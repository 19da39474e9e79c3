#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the five hand-written CUDA kernels from the sources in the
checkout (one `nvcc` per source, all in parallel) and holds each against
its plain PyTorch version: `edge_mpnn` and `segment_pool` at the served
shapes, `edge_mpnn_runs` and `segment_pool_runs` at the trained shapes,
on sorted and unsorted ids (`segment_pool_runs` also at the 64-wide
chunks of the model-parallel mean model), and `flash_attention` at the
graph-attention shape of a training batch, the reference envelope's
corner and an LM causal GQA prefill.  `[autotune]` then tunes the edge
and pooling kernels' variant and tile height per exact key with
`repro_torch.kernels.autotune` into a temporary file (the reference
bench's pooling shape, the served and trained convs and pools), prints
every candidate's device µs beside the shipped rule's, and with the
registry's consult on holds the tuned decisions, outputs and repeats to
`[kernels]`' rules, a GNNServer warmed from CUDA graphs to 0 captures
after warmup and a training forward to its 20 run-kernel launches.
Then it drives the port's paths at
the full width of the §8 OGBN-MAG model (init states -> 4-round
vanilla_mpnn over all five edge sets, 128 wide, LayerNorm -> root-node
head, 8 classes):

* serving: `repro_torch.serve.gnn.GNNServer` on the card, the same
  requests served twice in one call, eagerly and from one CUDA graph per
  bucket rung captured at warmup (`[serve]`, with a rung-8 batch's host
  stages, forward wall and device busy for both in `[profile]`); the
  mean-pooling variant of the same model from captured graphs
  (`[mean]`); then load generation through `repro_torch.serve.loadgen`
  over all 20000 papers (a closed loop of 4 clients x 125, an open loop
  at half its QPS for 5 s), the freshness step (`add_edges` bumps the
  store's version, stale entries are evicted, the resampled root's
  logits match the plain forward) and the twin
  `repro_torch.orchestration.gnn_serve.main([])` at the example's
  defaults, which must exit 0 (`[serveloop]`).  With graphs, launches
  are counted at capture (each rung's capture must hold the forward's
  20 `edge_mpnn` or `segment_pool` launches, replays none) and one
  replay of each rung is read through torch.profiler (20 such device
  kernels, no run kernel, no copy);
* training: `repro_torch.orchestration.trainer.Trainer` over a
  `StoreProvider` of target-sorted 16-root batches, AdamW +
  warmup-cosine, then an eval pass (`[train]`, `[train-mean]`), with the
  gradients of step 1 and the per-step losses held to the same run
  through the plain versions on the card;
* graph attention: `repro_torch.orchestration.gat_flash_parity.run`
  (`GraphSelfAttention` on the flash kernel) at the example's size and
  over the paper states of a training batch (`[attention]`);
* the model zoo: `rgcn`, `gcn`, `graph_sage`, `gatv2` and `hgt_like` on
  a training batch, gradients held to the plain path, and `gatv2` and
  `hgt_like` trained a few steps through the Trainer (`[zoo]`);
* the example twins in `repro_torch.orchestration` at the examples'
  defaults: `quickstart` against the plain versions (`[quickstart]`),
  `link_prediction` trained twice, bit-identical (`[linkpred]`), and
  `graph_classification` checkpointing to a temporary directory, with a
  run stopped at its first save and resumed that must repeat the
  uninterrupted losses exactly, and one full Graph Networks round
  against the plain path (`[graphcls]`);
* the sampler fleet: `[train]`'s run again through
  `runner.run(sampler="service")` over a process fleet of 2 workers
  forked from this CUDA-initialized process, each batch copied from
  pinned buffers on a side stream a step ahead, every loss bit-identical
  to `[train]`'s (`[service]`); and `repro_torch.orchestration.
  out_of_core.run` at the example's defaults, a thread fleet against a
  dial fleet of subprocess workers over an on-disk GraphDirectory:
  losses exactly equal, each worker's peak RSS below the directory's
  bytes (`[outofcore]`);
* the mesh (`[mesh]`): the §8 model trained by `Trainer(num_devices=,
  model_parallel=)` on super-batches of 4 component groups x 4 roots —
  (a) one rank, the sum model, held to the plain versions by the
  [train] rule; (b) 2 ranks sharing the card on gloo, (data=2), ZeRO-1
  optimizer state; (c) 2 ranks, (data=1, model=2), the mean model, its
  pools on 64-wide feature chunks; (d) one rank of the mean model —
  (b)'s losses held to (a)'s and (c)'s to (d)'s within 1e-4, (c)'s
  step-1 gradients to (d)'s by the [train] rule, (b)'s
  optimizer state a rank at most (a)'s / 1.8, 20 `edge_mpnn_runs` (sum)
  or `segment_pool_runs` (mean) a group forward on every rank; then the
  twin `repro_torch.orchestration.ogbn_mag_train.main(["--steps", "3"])`,
  which must exit 0;
* multi-host sampling (`[multihost]`): the `ogbn_mag_train` twin at
  ``--multihost 2 --num-devices 2`` (through `run_twin`, what its `main`
  runs), two processes of one gloo world sharing the card, rank 0
  hosting a `SamplerEndpoint` whose per-rank sampler fleets stream every
  rank's batches over loopback TCP; then the same argv without
  ``--multihost`` through `run_ranks`, the in-process stream on the same
  2-rank mesh.  Every per-step loss of each rank within 1e-4 of the
  in-process run's, 20 `edge_mpnn_runs` a group forward on each rank,
  and the step time, batch wait and roots/s of both runs and their
  ratio printed;
* LM serving (`[lm]`): the dense decoder at full width (qwen1.5-4b,
  3.95 B fp32 parameters drawn on the card, bf16 compute, a float8 KV
  cache) behind `repro_torch.serve.engine.ServeEngine`: 8 requests over
  4 slots (every token in range, every logit finite), the engine's
  greedy tokens at one slot equal to a hand-rolled prefill ->
  decode_step loop bit for bit, decode after prefill against the full
  forward (bf16 cache), the float8 cast on the card against the CPU's,
  flash through the LM's `Attention(use_flash=True)` at 2048 tokens (1
  launch, within 2e-2 of the chunked path), prefill and decode times
  with fp32-held and bf16-held weights (the same tokens), and the
  `lm_serve` twin at its defaults;
* the other LM families (`[lm-families]`), one model on the card at a
  time, each at full width (the engine families at 8 layers, whisper at
  full depth), fp32 weights drawn on the card
  from the seed, bf16 compute: granite-moe-3b-a800m (MoE), rwkv6-3b and
  zamba2-1.2b behind `ServeEngine` as `[lm]`'s decoder (8 requests over
  4 slots, the 1-slot engine against the hand-rolled loop bit for bit,
  decode after prefill against the full forward in bf16 and in fp32
  compute, the MoE check at a prompt where neither run drops, prefill
  and decode times), whisper-medium through its own prefill (1024
  stubbed frames) and 16 greedy decode steps, every decoded position
  against the full forward; then the `lm_serve` twin at `--arch
  rwkv6-3b-smoke`.  No kernel of the port is on these paths: every
  launch count must stay 0;
* LM training (`[lm-train]`), one model on the card at a time: (a) every
  arch id's smoke model one `make_train_step` on the card against the
  same step on the CPU (AdamW; then command-r-plus-104b with Adafactor
  and qwen1.5-4b with the int8 error-feedback compressor): loss rtol
  1e-5, step-1 gradients |d| <= 1e-6 + 1e-4 |g|, int8 codes equal on
  identical gradients; (b) at full width and 4 layers in fp32, remat
  "layer" (qwen1.5-4b) and "dots" (granite-moe-3b-a800m) against "none"
  and n_microbatches=2 against 1, and the in-place sliced AdamW against
  the functional update bit for bit; (c) qwen1.5-4b at full width and
  depth (3.95 B fp32 parameters, bf16 compute, remat "layer",
  `pick_optimizer`'s AdamW) 6 steps of 1 x 2048 tokens: peak memory,
  losses and gradient norms, step ms and tokens/s, a profiled step and
  optimizer update beside the step's bound, then a microbatched step
  holding no second gradient buffer; (d) the `repro_torch.launch.train`
  twin restarted from its checkpoint, its losses equal to an
  uninterrupted run's.  No kernel of the port is on these paths either;
* the LM on the mesh (`[lm-mesh]`): 4 gloo ranks sharing the card at
  (data=2, model=2), `make_train_step(plan=, zero1=True)`, fp32 and TF32
  off, against the same steps on one rank of the card run alone first:
  (a) qwen1.5-4b at full width and 2 layers, AdamW, 3 steps of 4 x 512
  tokens in 2 microbatches with a loss mask whose counts differ between
  the data halves (losses rtol 1e-4, final parameters rtol 1e-4 / atol
  1e-5, a rank's parameters at most 0.55 and its optimizer state at
  most 1 / 3.5 of one rank's); (b) granite-moe-3b-a800m likewise at its
  capacity factor 1.0, where tokens drop (the MoE terms each step too;
  its bytes against the reckoning of its split, since its vocabulary
  stays whole); (c) `pipeline_apply` over 4 stage ranks, one qwen1.5-4b
  `DecoderBlock` a stage, 4 microbatches of 1 x 512, against the blocks
  in sequence (rtol 1e-4), its forward alone under `torch.no_grad()`,
  then the forward and backward of a seeded cotangent's dot with the
  output: the input's gradient on every stage and each stage's block's
  within 1e-6 + 1e-4 |g| of the one-rank stack's, an element past it
  judged by the same stack in float64 (the one-rank stack off float64
  by more than the rule and the pipeline no further than it), the ms,
  calls and peak of each part; (d) (a)'s model and steps again over
  parameters placed by `MeshPlan.place_params_` (FSDP / ZeRO-3: cut
  over "data" at rest, gathered a layer at use), against the same
  one-rank run at (a)'s limits, a rank's parameters at most 0.30 of the
  model's and exactly its placement's reckoning; (e) (d) again with the
  plan's act rule "seq" -> "model" (sequence parallelism: the residual
  stream a rank's slice of the sequence between blocks), at (a)'s
  limits, then a prefill of 64 tokens and 8 greedy decode steps from
  the one-rank run's final weights with the KV cache cut by sequence,
  tokens equal to the one-rank run's and logits within rtol 1e-4 / atol
  1e-5, the cache a rank holds against the whole; (f) rwkv6-3b,
  zamba2-1.2b (2 Mamba2 layers, one application of the shared block)
  and whisper-medium (2 + 2 layers over 32 frames) at full width split
  over "model" (Mamba2 and the RWKV6 mixes by heads, the cross-rank
  norms) and placed (FSDP), zamba2 also under "seq" -> "model", 3
  steps of 4 x 256 tokens in one microbatch each, against one rank of
  the card at (a)'s limits, the bytes a rank holds equal to its
  layout's reckoning, then a prefill of 64 tokens and 8 greedy steps
  from the one-rank run's weights with fp32 caches cut by heads (by
  sequence under the rule): tokens equal, logits within rtol 1e-4 /
  atol 1e-5; and zamba2-1.2b placed and split again, trained with
  Adafactor (its factored statistics counting the B and C columns every
  model rank holds alike once) against one rank with Adafactor; (g) granite-moe-3b-a800m and rwkv6-3b at full width and 2
  layers on 16 gloo ranks sharing the card at (data=1, model=16), the
  production model axis, where granite's 40 experts and 24 / 8 heads
  and rwkv6's 40 heads do not divide: granite's experts cut by their
  hidden width, attention's weights cut at rest by fused columns and
  gathered at use, rwkv6's time mix by value columns (4 of every head's
  64 a rank, its weights cut at rest), as the reference's resolver
  places them; 3 steps of 1 x 256 each against one rank at (a)'s
  limits, a rank's parameter and optimizer bytes equal to its layout's
  reckoning, then rwkv6-3b's prefill of 64 tokens and 8 greedy steps
  from the one-rank run's weights, the wkv state cut by value columns:
  tokens equal, logits within rtol 1e-4 / atol 1e-5, the state and
  cache bytes a rank holds equal to the reckoning; the start-up of the
  16 ranks timed; (h) (f)'s rwkv6-3b and whisper-medium runs under
  "seq" -> "model" (the residual a rank's slice of the sequence,
  whisper's frames and tokens both; the token shifts, the wkv recurrence
  and the cross K/V over the gathered sequence), against (f)'s one-rank
  runs at (a)'s limits, then their prefill and greedy decode under the
  rule (the prefill's residual cut, rwkv6's states the whole prompt's);
  (i) (a) with `grad_compression`, `compress_int8_stateless` and then a
  bound `ErrorFeedbackCompressor`, against one rank with the same
  compressor: the scales of every step within 1e-6 + 1e-4 |s|, the
  first step's codes equal but within 1e-3 of a rounding tie (at most 2
  a leaf), the final parameters at (a)'s limits but where a step's
  codes differed (held to 3 x lr + 1e-5 there), the `all_max` calls a
  compression (at most 3) and the residual's bytes against the
  gradient slice's reckoning.  Every run at lr 1e-4 (LM_MESH_LR); a
  parameter element past the strict tolerance (but where (i)'s codes
  differed) in the slice a rank's update wrote passes, within 3 x lr of
  the strict tolerance, only where its gradients, the rank's and the
  one-rank run's (the one-rank run keeps the elements where its
  gradient is small at some step, every element of a small leaf, every
  step-1 root candidate and what it feeds; a rank records its own at
  those), are within 1e-6 + 1e-4 |g| of each other at every step; or
  at step 1, both non-zero and within 1e-6 of zero (a root: Adam's
  first step parts the runs there); or at step 1 but not later, where
  a root of the run feeds it (a knock-on: the root's table row, or its
  RWKV6 time-mix head); one a rank all-gathered from another data rank
  (ZeRO-1) only where it equals that rank's copy bit for bit
  (`lm_mesh_compare`, `lm_mesh_verdicts`).  Step
  ms, `torch.distributed` calls (and, for (d) to (i), per op; for (e)
  to (h) per mesh axis) and the host ms inside them a step, and peak
  GB, a rank.  No kernel launches;
* the dry run (`[dryrun]`, `repro_torch.launch.dryrun`, traced on meta
  tensors in spawned processes on the CPU): (a) `[lm-train]` (c)'s step
  on one rank against that run's measured peak, (b) rank 0 of
  `[lm-mesh]` (a) in a fake world of 4 against rank 0's measured peak
  (both within 10%), its `torch.distributed` calls a step and the
  parameter and optimizer bytes it held (equal); (b') the same for rank
  0 of `[lm-mesh]` (d), calls per op equal too, and (b'') for (e);
  (b''') rank 0 of each `[lm-mesh]` (f) run: calls per op and per axis
  and the bytes held equal, the traced peak beside the card's; (b'''')
  rank 0 of each `[lm-mesh]` (g) run in a fake world of 16: calls per
  op and per axis and the bytes held equal, the traced peak within 10%;
  (b5) rank 0 of each `[lm-mesh]` (h) run in a fake world of 4: calls
  per op and the bytes held equal, the traced peak within 10%; (c)
  qwen2.5-32b's train_4k, prefill_32k and decode_32k and
  command-r-plus-104b's train_4k at 16 x 16 (256 ranks), placed as
  every cell is (FSDP), with their ``"seq"`` overrides applied, each
  cell's row and roofline; (d) `HBM_PER_CARD` against the card.

The run kernels fold in a fixed order on sorted ids, so `[kernels]`
holds them to 20 bit-identical repeats and `[train]` two independent
kernel runs to the same bits over all 24 steps.

Each path is run with every kernel's launch count set to 0 just before
it and read just after.  Each phase prints one line; any failure prints
``FAIL:`` and exits non-zero.  The line before the last is a JSON record
of every kernel (launches on its path, error against the plain version,
times on the card, bound; for the two pooling kernels also host and
device µs per call, device kernels per call, a second `index_add_`
yardstick and the zoo's score shape; for the two edge kernels device µs
and device kernels and memsets per call in fp32 and bf16, the build's
registers and spills over their instantiations, and the fp32 CUDA-core
and bf16 tensor-core bounds; for `flash_attention` at each of its three
shapes the fp32 and bf16 times, device us and device kernels per call,
the 3xTF32 bound (its `bound_ms`), the fp32 CUDA-core and bf16
tensor-core bounds, and the build's registers and spills; its text lines
add the CTA the C entry chose and the kv tiles its skip rule visits and
the pairs they compute against the pairs the mask allows);
the edge and pooling kernels' launch budgets (EDGE_BUDGET, POOL_BUDGET:
exact device kernels a call, each after at most one memset) and flash's
(at most two device kernels a call) fail the run past them, and each
fp32 edge case must stay within FP64_ERR_MULTIPLE of the plain version's
error against an fp64 result; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without a CUDA device, or without the `src/repro_torch` package next to
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import io
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12        # fp32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12       # bf16 / fp16 on the tensor cores
PEAK_TF32_FLOPS = 495e12       # TF32 on the tensor cores

# the served model (paper §8 / examples/ogbn_mag_train.py, full width)
DIM = 128
FEAT_DIM = 128
N_CLASSES = 8
ROUNDS = 4
VOCAB = 4096
MAX_BATCH = 8
SEED = 0
DEVICE = "cuda"

# closed loop: one outstanding request per client, every root fresh; 500
# requests, so p99 is a tail and not the single slowest request
LOOP_CLIENTS = 4
LOOP_REQUESTS = 125

# training (examples/ogbn_mag_train.py: batch 16; lr 3e-3 over 600 steps
# with the Trainer's warmup 50 and weight decay 1e-5), cut to 24 steps of
# one epoch over 384 roots, then an eval pass over 64 held-out roots
TRAIN_BATCH = 16
TRAIN_STEPS = 24
EVAL_ROOTS = 64
TRAIN_LR = 3e-3
TRAIN_TOTAL = 600
MEAN_STEPS = 3
# kernel path vs plain path on the card: fp32 atomics sum in another
# order than index_add_, so gradients agree to a relative 1e-3 of each
# parameter's largest gradient entry, losses on shared parameters to 1e-4,
# and independent runs' losses to 1e-3 over their first PARITY_STEPS steps
GRAD_RTOL = 1e-3
LOSS_ATOL = 1e-3
PARITY_STEPS = 5
STEP_LOSS_ATOL = 1e-4
# the run kernels fold each sum in a fixed order on sorted ids (carry.cuh):
# REPEATS calls on the same inputs must return the same bits, and
# independent training runs on the kernel path the same losses
REPEATS = 20
# an edge kernel's fp32 error against the fp64 result, held to this
# multiple of the plain fp32 version's own (the product and the sum run
# in other orders than cuBLAS and index_add_, with errors of one size)
FP64_ERR_MULTIPLE = 4.0

# device kernels per call, held exactly (each after at most one memset):
# an any-order fp32 sum or edge call is one kernel; a run kernel's sum
# adds its carry fold (carry.cuh); max/min and 16-bit outputs add a
# finalize or cast pass
EDGE_BUDGET = {"edge_mpnn": {"fp32": 1, "bf16": 2},
               "edge_mpnn_runs": {"fp32": 2, "bf16": 3}}
POOL_BUDGET = {
    "segment_pool": {"sum fp32": 1, "max fp32": 2, "min fp32": 2,
                     "sum bf16": 2},
    "segment_pool_runs": {"sum fp32": 2, "max fp32": 2, "min fp32": 2,
                          "sum bf16": 3}}

# graph attention at full width: GraphSelfAttention(4 heads x 32) over the
# 128-wide paper states; the zoo at the reference's defaults, two of its
# models trained ZOO_STEPS steps on each path
ATTN_HEADS = 4
ATTN_PER_HEAD = 32
ZOO_STEPS = 3
# the LM prefill shape the flash kernel is also held at: qwen2.5-32b's
# attention (src/repro/configs/qwen2_5_32b.py: 40 q heads, 8 kv heads,
# d_model 5120 -> head width 128), batch 1, 2048 tokens, causal
PREFILL = dict(b=1, s=2048, h=40, kh=8, d=128)
# the mesh (`[mesh]`): super-batches of MESH_GROUPS component groups of
# MESH_ROOTS roots (16 roots a step, as [train]), MESH_STEPS steps a run;
# two ranks share the one card on gloo
MESH_GROUPS = 4
MESH_ROOTS = 4
MESH_STEPS = 12
MESH_RANKS = 2
MESH_TIMEOUT_S = 300
MESH_LOSS_ATOL = 1e-4           # reference: tests/test_graph_sharding.py
MESH_ZERO_SHRINK = 1.8          # reference: tests/test_partition.py
# multi-host sampling: the ogbn_mag_train twin on two ranks, 24 steps of
# 16 roots; 600 papers, half the example's, since every process of both
# runs samples all of them before its first step (the phase stays under
# a minute)
MULTIHOST_STEPS = 24
MULTIHOST_PAPERS = 600
MULTIHOST_RANKS = 2
# the LM on the mesh (`[lm-mesh]`): (data=2, model=2) on 4 gloo ranks
# sharing the card, full width cut to 2 layers, fp32 compute, AdamW at
# its default rate.  Adam's first steps move a parameter by about its
# gradient's sign times the rate, so an element whose gradient is within
# rounding of zero, summed in another order on the ranks, lands apart
# between two correct runs by a good part of the rate: 1 to 9 elements a
# run of 10^8-10^9, 1.47e-5 to 2.27e-5 off one rank's, past atol 1e-5
# (PERF.md §6, PR 31).  So a parameter element past the strict
# tolerance is judged by its gradients (`lm_mesh_verdicts`): the one-rank
# run's and this rank's at that element, step by step, each within
# 1e-6 + 1e-4 |g| of the one rank's; or a root, parted at step 1 (its
# step-1 gradients within that rule, both non-zero and within 1e-6 of
# zero: Adam's first step g / (|g| + 1e-8) may differ), its later steps
# not held; or a knock-on of such a root (its step-1 gradients within
# the rule, later ones not, in the root's table row or RWKV6 time-mix
# head, PERF.md §6, PR 34); each with its drift within LM_MESH_STEPS x
# lr + the strict tolerance (what Adam's sign steps can add); every
# other element keeps the strict bound.  A one-rank run does not repeat
# bit for bit (atomic sums: the MoE, the embedding), so its gradients
# are kept as it runs
LM_MESH_ARCHS = ("qwen1.5-4b", "granite-moe-3b-a800m")
LM_MESH_DATA, LM_MESH_MODEL, LM_MESH_STAGES = 2, 2, 4
LM_MESH_LAYERS = 2
LM_MESH_BATCH, LM_MESH_SEQ, LM_MESH_MICRO = 4, 512, 2
LM_MESH_STEPS = 3
LM_MESH_LR = 1e-4
LM_MESH_RTOL, LM_MESH_ATOL = 1e-4, 1e-5
LM_MESH_GRAD_RTOL, LM_MESH_GRAD_ATOL = 1e-4, 1e-6   # the gradient rule
# a one-rank run keeps its gradient each step at the elements where it is
# not zero and within this share of its leaf's mean |g| at some step (a
# few in a hundred): an element whose parameter two correct runs part by
# Adam's sign steps has a gradient near rounding; one past the tolerance
# whose one-rank gradient was never kept fails.  A leaf of at most
# LM_MESH_CAP_ELEMENTS elements (norms, biases, rwkv6's bonus_u) is kept
# whole, and so are every step-1 root candidate (its |g| in (0,
# LM_MESH_GRAD_ATOL]) and what it feeds (`lm_mesh_grad_store`)
LM_MESH_GRAD_SMALL = 1e-2
LM_MESH_PARAM_SHARE = 0.55
LM_MESH_FSDP_SHARE = 0.30   # (d): parameters cut over "data" too
LM_MESH_OPT_SHRINK = 3.5
LM_MESH_TIMEOUT_S = 600
# (e): (d) with the act rule "seq" -> "model" (sequence parallelism), then
# a prefill of LM_MESH_PROMPT tokens and LM_MESH_DECODE greedy steps from
# the one-rank run's final weights, the KV cache cut by sequence
LM_MESH_SEQ_RULES = {"seq": "model"}
LM_MESH_PROMPT, LM_MESH_DECODE = 64, 8
# (f): the families split by heads, each against one rank; zamba2 again
# under LM_MESH_SEQ_RULES.  One microbatch of 4 x 256: a microbatch's
# FSDP gathers (forward, recompute, backward) are most of a step's gloo
# time, and (d) and (e) cover microbatches
LM_MESH_TP_RUNS = (("rwkv6-3b", None), ("zamba2-1.2b", None),
                   ("zamba2-1.2b", LM_MESH_SEQ_RULES),
                   ("whisper-medium", None))
LM_MESH_TP_SEQ, LM_MESH_TP_MICRO, LM_MESH_TP_FRAMES = 256, 1, 32
# (f) also trains this arch with Adafactor (`make_optimizer("adafactor")`'s
# optimizer at LM_MESH_LR), placed, without the "seq" rule: its factored
# statistics over Mamba2's fused in_proj and conv leaves count the B and
# C columns every model rank holds alike once (`ModelLayout.dup`)
LM_MESH_ADAFACTOR = "zamba2-1.2b"
# (g): granite-moe and rwkv6-3b at full width on (data=1, model=16),
# the production model axis: granite's 40 experts and 24 / 8 heads do
# not divide 16, so the experts are cut by their hidden width and
# attention's weights at rest by fused columns (the reference resolver's
# fall-through); rwkv6's 40 heads of 64 do not either, so its time mix
# runs by value columns (4 of every head a rank, the wkv state so cut),
# its weights cut at rest, and it is served from that cache after its
# steps; 16 gloo ranks share the card, one intra-op thread each
LM_MESH_UNEVEN_ARCHS = ("granite-moe-3b-a800m", "rwkv6-3b")
LM_MESH_UNEVEN_MODEL = 16
LM_MESH_UNEVEN_ROWS, LM_MESH_UNEVEN_SEQ = 1, 256
LM_MESH_UNEVEN_TIMEOUT_S = 600
# (h): (f)'s rwkv6-3b and whisper-medium runs under LM_MESH_SEQ_RULES,
# held to (f)'s one-rank runs
LM_MESH_SEQ_FAMILIES = ("rwkv6-3b", "whisper-medium")
# (i): (a) with each `grad_compression`, held to one rank with the same
# compressor by the code rule: the first step's codes equal but within
# LM_MESH_TIE of a rounding tie of the one rank's x / scale, at most
# LM_MESH_MAX_MISSES in a leaf of up to LM_MESH_CAP_ELEMENTS (the CPU
# tests' leaves); at full width a leaf of 10^6-10^8 elements holds tens
# to a hundred codes that close to a tie where the two sums differ
# (PERF.md §6), so there each differing code is held instead to
# the two gradients' rule, |dx| <= 1e-6 + 1e-4 |x|, at the element; at
# most LM_MESH_MAX_ALL_MAX `all_max` calls a compression
LM_MESH_COMPRESSORS = ("int8", "int8_ef")
LM_MESH_TIE, LM_MESH_MAX_MISSES, LM_MESH_MAX_ALL_MAX = 1e-3, 2, 3
LM_MESH_CAP_ELEMENTS = 65536


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    raise SystemExit(1)


def phase(name: str, message: str) -> None:
    print(f"[{name}] {message}", flush=True)


def time_ms(torch, fn, calls: int = 50, reps: int = 5,
            warmup: int = 5) -> float:
    """Per-call time (ms): CUDA events around `calls` back-to-back calls,
    so the device never waits on the host between them; the median of
    `reps` such runs.  Inputs stay in L2 (a few MB), as they do when the
    previous layer of the forward has just written them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(torch, fn, calls: int = 200, reps: int = 5,
            warmup: int = 10) -> float:
    """Host µs per call to enqueue `fn`: the host clock around `calls`
    back-to-back calls with no synchronize among them (the device runs
    behind and never makes the host wait, unless `fn` itself syncs); the
    median of `reps` such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def device_per_call(torch, fn, calls: int = 20, tries: int = 6) -> dict:
    """The device work of one call of `fn`, from torch.profiler over
    `calls` calls: device µs (kernels and memsets), and the kernels and
    memsets it ran, per call, with the kernels' names.  The profiler
    misses an event now and then, and now and then every event: a run
    that saw no device event, or in which some kernel's or memset's events
    are not a whole multiple of `calls`, is profiled again after a short
    pause, up to `tries` runs.  If the last still misses, a name short of
    a whole multiple by one event counts as that multiple (`missed`
    says how many such events), and a larger shortfall leaves its count
    fractional, so that a launch budget fails.  A name's device µs are
    its mean per event times its launches a call; `by_name` splits the
    device µs by kernel name (memsets under "memset"),
    `launches_by_name` the launches a call by the same names."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if getattr(ev, "device_type", None) == cuda and ev.count]
        if events and all(ev.count % calls == 0 for ev in events):
            break
    us, kernels, memsets, missed, by_name, counts = 0.0, 0.0, 0.0, 0, {}, {}
    for ev in events:
        launches = ev.count / calls
        if -ev.count % calls == 1:  # one event missed
            launches, missed = -(-ev.count // calls), missed + 1
        ev_us = (getattr(ev, "self_device_time_total", 0) or 0) \
            / ev.count * launches
        us += ev_us
        if "memset" in ev.key.lower():
            memsets += launches
            name = "memset"
        else:
            kernels += launches
            name = ev.key.replace("(anonymous namespace)::", "")
            name = (name.split("(")[0].split("<")[0].split("::")[-1]
                    .removeprefix("void "))
        by_name[name] = by_name.get(name, 0.0) + ev_us
        counts[name] = counts.get(name, 0.0) + launches
    return dict(device_us=us, kernels=kernels, memsets=memsets,
                missed=missed, names=sorted(set(by_name) - {"memset"}),
                by_name=by_name, launches_by_name=counts)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def full_fp32(torch) -> None:
    """Every fp32 product in full fp32, as the kernels and the JAX
    reference compute: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def device_phase(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    full_fp32(torch)
    name = torch.cuda.get_device_name(0)
    phase("device", f"{name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, TF32 off")
    return name, smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build(list(build.SOURCES))
    seconds = time.perf_counter() - t0
    for name, rep in report.items():
        usage = [f"{x['name']} {x.get('registers', '?')} registers "
                 f"{x.get('smem', 0)} B smem {x.get('spill_stores', '?')}/"
                 f"{x.get('spill_loads', '?')} B spills"
                 for x in ptxas_entries(rep["log"])]
        phase("build", f"{name}: {rep['seconds']:.1f}s; "
              + (" | ".join(usage) or "no ptxas report (cached build)"))
    phase("build", f"{len(report)} kernels built in parallel in "
          f"{seconds:.1f}s")
    return report


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the served shapes
# ---------------------------------------------------------------------------

def _close(torch, name, got, want, rtol, atol) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = (got - want).abs().max().item()
        fail(f"{name}: max |kernel - plain| {err:.3e} exceeds rtol "
             f"{rtol} atol {atol}")
    return (got - want).abs().max().item()


def _close_sum(torch, name, got, want, abs_sum, counts, rtol) -> float:
    """`got` vs `want` where both are fp32 sums of `counts` terms per row
    whose absolute values sum to `abs_sum`, taken in different orders
    (tile runs and atomics vs index_add_).  Each order may be off by up
    to n * 2**-24 * sum|terms| (recursive summation), so a row of n terms
    is held to (rtol + 2 * n * 2**-24) * sum|terms| + 1e-6: rtol covers
    the terms themselves (an FMA chain vs a library matmul).  The
    training batches' padding edges form one run of thousands of edges
    into the padding node, where a plain relative tolerance on the sum
    would not hold for either order."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    tol = (rtol + 2 * counts.float()[:, None] * 2.0 ** -24) * abs_sum + 1e-6
    err = (got - want).abs()
    if bool((err > tol).any()):
        worst = int(torch.argmax((err - tol).max(1).values))
        fail(f"{name}: max |kernel - plain| {err.max().item():.3e}; row "
             f"{worst} ({int(counts[worst])} terms, sum|terms| "
             f"{abs_sum[worst].max().item():.3e}) exceeds its tolerance")
    return err.max().item()


def edge_fp64(torch, h_src, h_tgt, src, tgt, w, b, n_tgt, act):
    """The edge function of fp32 inputs in fp64 on the card: the result
    that both the fp32 kernel and the fp32 plain version approximate."""
    from repro_torch.kernels.edge_mpnn.ref import activate
    src, tgt = src.long(), tgt.long()
    valid = (tgt >= 0) & (tgt < n_tgt)
    x = torch.cat([h_src[src.clamp(0, h_src.shape[0] - 1)],
                   h_tgt[tgt.clamp(0, n_tgt - 1)]], dim=-1).double()
    msg = activate(x @ w.double() + b.double(), act)
    msg = torch.where(valid[:, None], msg, 0.0)
    return torch.zeros(n_tgt + 1, w.shape[1], dtype=torch.float64,
                       device=x.device).index_add_(
        0, torch.where(valid, tgt, n_tgt), msg)[:n_tgt]


def fp64_check(torch, name, got, want, exact) -> tuple:
    """(kernel, plain) max |fp32 - fp64| of an edge call: fails when the
    kernel's exceeds FP64_ERR_MULTIPLE times the plain version's."""
    kernel_err = (got.double() - exact).abs().max().item()
    plain_err = (want.double() - exact).abs().max().item()
    if kernel_err > FP64_ERR_MULTIPLE * plain_err:
        fail(f"{name}: |kernel - fp64| {kernel_err:.3e} exceeds "
             f"{FP64_ERR_MULTIPLE:g} x the plain version's {plain_err:.3e}")
    return kernel_err, plain_err


def repeat_check(torch, name, fn) -> None:
    """Fails unless REPEATS calls of `fn` return the same bits."""
    first = fn()
    for _ in range(REPEATS - 1):
        if not torch.equal(fn(), first):
            fail(f"{name}: {REPEATS} calls on the same inputs are not "
                 "bit-identical")


def _bound(nbytes: int, flops: int) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and fp32 operations over its fp32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_entries(log: str) -> list:
    """Every kernel instantiation in a `-Xptxas -v` build log, as dicts
    (name as `kernel<template arguments>`, registers, static shared
    memory, spill stores and loads in bytes); what a line does not say is
    left out, and nothing fails on a line it cannot read."""
    import re
    entries, current = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            current = dict(name=short_name(found.group(1)))
            entries.append(current)
        elif current is not None and "spill stores" in line:
            for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                got = re.search(pat, line)
                if got:
                    current[key] = int(got.group(1))
        elif current is not None and "Used" in line:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem")):
                got = re.search(pat, line)
                if got:
                    current[key] = int(got.group(1))
            current = None
    return entries


def short_name(mangled: str) -> str:
    """`name<1,2,...>` of an Itanium-mangled kernel name whose template
    arguments are integers or bools (`_ZN..16edge_mpnn_kernelILi0E..`),
    else the name as given."""
    import re
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = None
    while (got := re.match(r"(\d+)", rest)) is not None:
        n = int(got.group(1))
        name, rest = rest[got.end():got.end() + n], rest[got.end() + n:]
    args = re.match(r"I((?:L[a-z]+\d+E)+)E", rest)
    if name is None:
        return mangled
    if args is None:
        return name
    return f"{name}<{','.join(re.findall(r'L[a-z]+(\d+)E', args.group(1)))}>"


def ptxas_summary(entries: list, prefix: str) -> dict:
    """Registers (least, most) and the largest spills over the entries
    whose name starts with `prefix`."""
    mine = [x for x in entries if x["name"].startswith(prefix + "<")]
    regs = [x["registers"] for x in mine if "registers" in x]
    return dict(instantiations=len(mine),
                registers=[min(regs), max(regs)] if regs else None,
                spill_stores=max((x.get("spill_stores", 0) for x in mine),
                                 default=0),
                spill_loads=max((x.get("spill_loads", 0) for x in mine),
                                default=0))


def edge_bytes(torch, h_src, h_tgt, src, tgt, w, b, n_out, isz) -> int:
    """Bytes one edge kernel call must move: the distinct (clamped)
    source rows and distinct target rows of the valid edges, W and b read
    once, both id arrays read once, the [n_tgt, M] output written once."""
    n_tgt = h_tgt.shape[0]
    valid = (tgt >= 0) & (tgt < n_tgt)
    rows_src = torch.unique(src[valid].clamp(0, h_src.shape[0] - 1)).numel()
    rows_tgt = torch.unique(tgt[valid]).numel()
    return ((rows_src * h_src.shape[1] + rows_tgt * h_tgt.shape[1]
             + w.numel() + b.numel() + n_out) * isz + 2 * src.numel() * 4)


def edge_kernel_costs(torch, kernel, args, kw, n_valid, n_out,
                      build_report) -> dict:
    """One edge kernel at (args, kw): device us and device kernels and
    memsets per call (torch.profiler) for fp32 and bf16, the bf16 time,
    the build's registers and spills over the kernel's instantiations,
    and two bounds: fp32 on the CUDA cores (the product that ships for
    fp32) and bf16 on the tensor cores, each the larger of its operations
    and its bytes (`edge_bytes`).  Fails unless each call runs exactly
    its EDGE_BUDGET kernels after at most 1 memset (the profiler may miss
    a memset event now and then, as in pool_launch_costs' check)."""
    name = kernel.__name__
    h_src, h_tgt, src, tgt, w, b = args
    ds, dt, m = h_src.shape[1], h_tgt.shape[1], w.shape[1]
    bf = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in args]
    fp32 = device_per_call(torch, lambda: kernel(*args, **kw))
    bf16 = device_per_call(torch, lambda: kernel(*bf, **kw))
    for label, cost in (("fp32", fp32), ("bf16", bf16)):
        want = EDGE_BUDGET[name][label]
        if cost["kernels"] != want or cost["memsets"] > 1:
            fail(f"{name}: a {label} call ran {cost['kernels']} device "
                 f"kernels ({cost['names']}) and {cost['memsets']} memsets "
                 f"({want} kernels and at most 1 memset expected)")
    flops = 2 * n_valid * (ds + dt) * m
    fp32_bound = _bound(edge_bytes(torch, *args, n_out, 4), flops)
    t_bytes = edge_bytes(torch, *args, n_out, 2) / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    bf16_bound = (max(t_bytes, t_ops) * 1e3,
                  "bytes" if t_bytes >= t_ops else "operations")
    ms_bf16 = time_ms(torch, lambda: kernel(*bf, **kw))
    return dict(
        device_us=fp32["device_us"], device_kernels=fp32["kernels"],
        memsets=fp32["memsets"], device_names=fp32["names"],
        device_us_by_name=fp32["by_name"],
        bf16_ms=ms_bf16, bf16_device_us=bf16["device_us"],
        bf16_device_kernels=bf16["kernels"], bf16_memsets=bf16["memsets"],
        ptxas=ptxas_summary(ptxas_entries(build_report[name]["log"]),
                            f"{name}_kernel"),
        cuda_core_bound_ms=fp32_bound[0], cuda_core_bound_by=fp32_bound[1],
        tensor_bound_ms=bf16_bound[0], tensor_bound_by=bf16_bound[1])


def edge_costs_line(name, rec) -> str:
    """The [kernels] line of edge_kernel_costs' numbers."""
    p = rec["ptxas"]
    regs = ("-".join(map(str, p["registers"])) if p["registers"]
            else "not reported")
    return (f"{name} per call: fp32 device {rec['device_us']:.2f} us in "
            f"{rec['device_kernels']:g} kernel + {rec['memsets']:g} memset ("
            + ", ".join(f"{k} {v:.2f}"
                        for k, v in rec["device_us_by_name"].items())
            + "); "
            f"bf16 {rec['bf16_ms']:.4f} ms, device "
            f"{rec['bf16_device_us']:.2f} us in "
            f"{rec['bf16_device_kernels']:g} kernels + "
            f"{rec['bf16_memsets']:g} memset; build: {p['instantiations']} "
            f"instantiations, {regs} registers, at most "
            f"{p['spill_stores']}/{p['spill_loads']} B spill stores/loads; "
            f"bounds: fp32 CUDA cores {rec['cuda_core_bound_ms']:.5f} ms "
            f"({rec['cuda_core_bound_by']}, share of ms "
            f"{rec['cuda_core_bound_ms'] / rec['ms']:.3f}, of device time "
            f"{rec['cuda_core_bound_ms'] * 1e3 / rec['device_us']:.3f}), "
            f"bf16 tensor cores {rec['tensor_bound_ms']:.5f} ms "
            f"({rec['tensor_bound_by']}, share of bf16 ms "
            f"{rec['tensor_bound_ms'] / rec['bf16_ms']:.3f}, of device time "
            f"{rec['tensor_bound_ms'] * 1e3 / rec['bf16_device_us']:.3f})")


def served_inputs(torch) -> types.SimpleNamespace:
    """The has_topic conv at rung 8, drawn from seed SEED: n_src = 1224
    papers, n_tgt = 4896 fields, E = 4896 edges, 128 wide; ~5% padding
    edges (tgt >= n_tgt), and ~37% of the targets receive no edge.  `rng`
    and `normal` carry on the same draw."""
    dev = torch.device(DEVICE)
    n_src, n_tgt, e, d = 1224, 4896, 4896, DIM
    rng = np.random.default_rng(SEED)
    src = torch.from_numpy(rng.integers(0, n_src, e).astype(np.int32)).to(dev)
    tgt_np = rng.integers(0, n_tgt, e).astype(np.int32)
    tgt_np[rng.random(e) < 0.05] = n_tgt + 7  # padding edges

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    h_src, h_tgt = normal(n_src, d), normal(n_tgt, d)
    w, b = normal(2 * d, d, scale=(2 * d) ** -0.5), normal(d, scale=0.1)
    vals = normal(e, d)
    ints = torch.from_numpy(rng.integers(-8, 8, (e, d)).astype(np.float32)
                            ).to(dev)
    return types.SimpleNamespace(
        rng=rng, normal=normal, n_src=n_src, n_tgt=n_tgt, e=e, d=d, src=src,
        tgt=torch.from_numpy(tgt_np).to(dev),
        n_valid=int((tgt_np < n_tgt).sum()),
        n_empty=n_tgt - len(np.unique(tgt_np[tgt_np < n_tgt])),
        h_src=h_src, h_tgt=h_tgt, w=w, b=b, vals=vals, ints=ints)


def pool_launch_costs(torch, kernel, vals, ids, n) -> dict:
    """One pooling kernel's launch costs at (vals, ids): host µs to
    enqueue an fp32 sum, its device µs, kernels and memsets per call
    (torch.profiler), and the device kernels per call of max, min and a
    bf16 sum.  Fails unless every case runs exactly its POOL_BUDGET
    kernels and an fp32 sum at most one memset."""
    name = kernel.__name__
    fn = functools.partial(kernel, vals, ids, n_segments=n)
    dev = device_per_call(torch, fn)
    by_case = {"sum fp32": dev["kernels"]}
    for label, reduce, dtype in (("max fp32", "max", torch.float32),
                                 ("min fp32", "min", torch.float32),
                                 ("sum bf16", "sum", torch.bfloat16)):
        by_case[label] = device_per_call(torch, functools.partial(
            kernel, vals.to(dtype), ids, n_segments=n,
            reduce=reduce))["kernels"]
    if dev["memsets"] > 1:
        fail(f"{name}: an fp32 sum ran {dev['memsets']} memsets per call "
             "(at most 1 expected)")
    for label, k in by_case.items():
        if k != POOL_BUDGET[name][label]:
            fail(f"{name}: {label} ran {k} device kernels per call "
                 f"({dev['names']} for the fp32 sum; "
                 f"{POOL_BUDGET[name][label]} expected)")
    return dict(host_us=host_us(torch, fn), device_us=dev["device_us"],
                device_kernels=dev["kernels"], memsets=dev["memsets"],
                device_us_by_name=dev["by_name"], kernels_by_case=by_case)


def host_breakdown(torch, vals, ids, n) -> dict:
    """Host µs per call of each step of the launch path of an fp32 sum at
    (vals, ids): the wrapper's steps one by one (dtype code, allocation,
    stream handle, the ctypes entry call that launches), the wrapper
    whole, and the registry's steps around it (kernel_ids, the autograd
    Function, `segment_reduce` with and without a gradient to record, the
    count of the mean)."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.segment_pool import kernel as seg
    index = vals.get_device()
    e, d = vals.shape
    ids64 = ids.long()
    leaf = vals.detach().clone().requires_grad_(True)
    out = vals.new_empty((n, d))
    stream = torch.cuda.current_stream(index).cuda_stream
    entry = seg._entry("segment_pool")
    args = (vals.data_ptr(), ids.data_ptr(), out.data_ptr(), out.data_ptr(),
            e, d, n, seg._DTYPE_CODES[vals.dtype], seg._REDUCE_CODES["sum"],
            stream)
    off = contextlib.nullcontext
    steps = {
        "dtype code, dict by torch.dtype": (
            lambda: seg._DTYPE_CODES[vals.dtype], off),
        "values.new_empty [N, D]": (lambda: vals.new_empty((n, d)), off),
        "current_stream(index).cuda_stream": (
            lambda: torch.cuda.current_stream(index).cuda_stream, off),
        "ctypes entry call (launches)": (lambda: entry(*args), off),
        "wrapper segment_pool": (
            lambda: seg.segment_pool(vals, ids, n_segments=n), off),
        "kernel_ids int64 -> int32": (lambda: registry.kernel_ids(ids64),
                                      off),
        "SegmentPoolFunction.apply, grad": (
            lambda: registry.SegmentPoolFunction.apply(
                leaf, ids, n, "sum", seg.segment_pool), off),
        "SegmentPoolFunction.apply, inference": (
            lambda: registry.SegmentPoolFunction.apply(
                vals, ids, n, "sum", seg.segment_pool), torch.inference_mode),
        "segment_reduce sum, grad": (
            lambda: registry.segment_reduce(leaf, ids64, n, "sum",
                                            sorted_ids=False), off),
        "segment_reduce sum, inference": (
            lambda: registry.segment_reduce(vals, ids64, n, "sum",
                                            sorted_ids=False),
            torch.inference_mode),
        "segment_count": (lambda: registry.segment_count(ids64, n), off),
        "segment_reduce mean, inference": (
            lambda: registry.segment_reduce(vals, ids64, n, "mean",
                                            sorted_ids=False),
            torch.inference_mode),
    }
    result = {}
    for label, (fn, ctx) in steps.items():
        with ctx():
            result[label] = host_us(torch, fn)
    return result


BINCOUNT = "torch.bincount (control)"


def sync_check(torch, batch) -> dict:
    """Mean pooling (both pooling kernels) and `node_degree` on the card
    under torch.cuda.set_sync_debug_mode("error"): {op: None, or the
    error a host sync raised}.  A control, `BINCOUNT` of the same ids,
    must raise: it reads the ids' max back to the host to size its
    output, so it shows that the mode sees a sync."""
    from repro_torch.core import ops
    from repro_torch.core.graph_tensor import TARGET
    from repro_torch.kernels import registry
    feat = torch.ones(batch.edge_sets["has_topic"].capacity, DIM,
                      device=DEVICE)

    def mean(sorted_ids):
        def run():
            with registry.layout(sorted_by_target=sorted_ids):
                ops.pool_edges_to_node(batch, "has_topic", TARGET, "mean",
                                       feature_value=feat)
        return run

    cases = {"mean, segment_pool_runs": mean(True),
             "mean, segment_pool": mean(False),
             "node_degree": lambda: ops.node_degree(batch, "has_topic",
                                                    TARGET),
             BINCOUNT: lambda: torch.bincount(
                 batch.edge_sets["has_topic"].adjacency.target.long()
                 .clamp(min=0))}
    result = {}
    for name, fn in cases.items():
        fn()  # first calls (library loads) are not the steady state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            result[name] = None
        except RuntimeError as err:
            result[name] = str(err).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return result


def index_add_yardsticks(torch, vals, ids, n) -> tuple:
    """(ms, ms) of the two library yardsticks of an fp32 segment sum, timed
    only (the port never calls them): `index_add_` into an accumulator
    allocated once and never zeroed again, and the whole function in one
    expression, `torch.zeros(N + 1, D).index_add_(...)`, with padding ids
    on the spare row."""
    safe = torch.where(ids < n, ids, n).long()
    acc = torch.zeros(n + 1, vals.shape[1], device=vals.device)
    return (time_ms(torch, lambda: acc.index_add_(0, safe, vals)),
            time_ms(torch, lambda: torch.zeros(
                n + 1, vals.shape[1], device=vals.device).index_add_(
                    0, safe, vals)))


def kernels_phase(torch, build_report):
    """Each kernel of the served conv (`served_inputs`) against its plain
    version, timed beside its bound and a library call."""
    from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn
    from repro_torch.kernels.edge_mpnn.ref import edge_mpnn_ref
    from repro_torch.kernels.segment_pool.kernel import segment_pool
    from repro_torch.kernels.segment_pool.ref import segment_pool_ref

    dev = torch.device(DEVICE)
    s = served_inputs(torch)
    n_src, n_tgt, e, d = s.n_src, s.n_tgt, s.e, s.d
    rng, normal, src, tgt = s.rng, s.normal, s.src, s.tgt
    n_valid, n_empty = s.n_valid, s.n_empty
    h_src, h_tgt, w, b = s.h_src, s.h_tgt, s.w, s.b
    records = {}

    # -- edge_mpnn ----------------------------------------------------------
    errs, fp64_errs = [], []
    for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-5),
                              (torch.bfloat16, 2e-2, 2e-2)):
        args = [t.to(dtype) for t in (h_src, h_tgt)]
        wb = [t.to(dtype) for t in (w, b)]
        for act in ("relu", "gelu", "identity"):
            got = edge_mpnn(args[0], args[1], src, tgt, wb[0], wb[1],
                            n_src=n_src, n_tgt=n_tgt, activation=act)
            want = edge_mpnn_ref(args[0], args[1], src, tgt, wb[0], wb[1],
                                 n_src=n_src, n_tgt=n_tgt, activation=act)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != (n_tgt, d):
                fail(f"edge_mpnn: got {got.dtype} {tuple(got.shape)}")
            err = _close(torch, f"edge_mpnn[{dtype}, {act}]", got, want,
                         rtol, atol)
            if dtype == torch.float32:
                errs.append(err)
                fp64_errs.append(fp64_check(
                    torch, f"edge_mpnn[{act}] vs fp64", got, want,
                    edge_fp64(torch, h_src, h_tgt, src, tgt, w, b, n_tgt,
                              act)))
    ms = time_ms(torch, lambda: edge_mpnn(h_src, h_tgt, src, tgt, w, b,
                                          n_src=n_src, n_tgt=n_tgt))
    plain_ms = time_ms(torch, lambda: edge_mpnn_ref(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    bound_ms, bound_by = _bound(
        edge_bytes(torch, h_src, h_tgt, src, tgt, w, b, n_tgt * d, 4),
        2 * n_valid * (2 * d) * d)
    records["edge_mpnn"] = dict(
        name="edge_mpnn", route="cuda",
        source="src/repro_torch/kernels/edge_mpnn/edge_mpnn.cu",
        replaces="src/repro/kernels/edge_mpnn/kernel.py:182",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
        fp64_err=max(k for k, _ in fp64_errs),
        plain_fp64_err=max(p for _, p in fp64_errs))
    records["edge_mpnn"].update(edge_kernel_costs(
        torch, edge_mpnn, (h_src, h_tgt, src, tgt, w, b),
        dict(n_src=n_src, n_tgt=n_tgt), n_valid, n_tgt * d, build_report))
    phase("kernels", f"edge_mpnn fp32/bf16 x relu/gelu/identity match the "
          f"plain version (fp32 max err {max(errs):.2e}); vs fp64 "
          f"(relu, gelu, identity) kernel / plain "
          + ", ".join(f"{k:.2e} / {p:.2e}" for k, p in fp64_errs)
          + f" (kernel held to {FP64_ERR_MULTIPLE:g}x plain); fp32 "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
          f"{records['edge_mpnn']['bound_ms']:.4f} ms "
          f"({records['edge_mpnn']['bound_by']}); {n_valid} valid edges")
    phase("kernels", edge_costs_line("edge_mpnn", records["edge_mpnn"]))

    # -- segment_pool --------------------------------------------------------
    vals, ints = s.vals, s.ints
    got = segment_pool(ints, tgt, n_segments=n_tgt, reduce="sum")
    want = segment_pool_ref(ints, tgt, n_segments=n_tgt, reduce="sum")
    if not torch.equal(got, want):
        fail("segment_pool: integer-valued fp32 sums are not bit-identical")
    for reduce in ("max", "min"):
        got = segment_pool(vals, tgt, n_segments=n_tgt, reduce=reduce)
        want = segment_pool_ref(vals, tgt, n_segments=n_tgt, reduce=reduce)
        if not torch.equal(got, want):
            fail(f"segment_pool: {reduce} differs from the plain version")
    empty_rows = torch.ones(n_tgt, dtype=torch.bool, device=dev)
    empty_rows[tgt[tgt < n_tgt].long()] = False
    if got[empty_rows].abs().max().item() != 0:
        fail("segment_pool: empty segments must yield 0")
    err = _close(torch, "segment_pool[sum, fp32]",
                 segment_pool(vals, tgt, n_segments=n_tgt),
                 segment_pool_ref(vals, tgt, n_segments=n_tgt), 1e-5, 1e-5)
    vb = vals.to(torch.bfloat16)
    got = segment_pool(vb, tgt, n_segments=n_tgt)
    if got.dtype != torch.bfloat16:
        fail(f"segment_pool: bf16 input gave {got.dtype}")
    _close(torch, "segment_pool[sum, bf16]", got,
           segment_pool_ref(vb, tgt, n_segments=n_tgt), 2e-2, 2e-2)
    ms = time_ms(torch, lambda: segment_pool(vals, tgt, n_segments=n_tgt))
    plain_ms = time_ms(torch, lambda: segment_pool_ref(
        vals, tgt, n_segments=n_tgt))
    library_ms, zeroed_ms = index_add_yardsticks(torch, vals, tgt, n_tgt)
    # padding rows' values are never read
    isz = 4
    bound_ms, bound_by = _bound(n_valid * d * isz + e * 4 + n_tgt * d * isz,
                                n_valid * d)
    costs = pool_launch_costs(torch, segment_pool, vals, tgt, n_tgt)
    steps = host_breakdown(torch, vals, tgt, n_tgt)
    records["segment_pool"] = dict(
        name="segment_pool", route="cuda",
        source="src/repro_torch/kernels/segment_pool/segment_pool.cu",
        replaces="src/repro/kernels/segment_pool/kernel.py:193",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library_zeroed_ms=zeroed_ms, **costs, host_steps_us=steps)
    phase("kernels", f"segment_pool: int sums bit-exact, max/min exact, "
          f"sum fp32 max err {err:.2e}, bf16 cast back; {n_empty} empty "
          f"segments; sum {ms:.4f} ms vs plain {plain_ms:.4f} ms vs "
          f"index_add_ {library_ms:.4f} ms (zeros + index_add_ "
          f"{zeroed_ms:.4f} ms), bound {bound_ms:.4f} ms; per call: host "
          f"{costs['host_us']:.2f} us, device {costs['device_us']:.2f} us, "
          f"device kernels {costs['kernels_by_case']}, memsets "
          f"{costs['memsets']}")
    phase("kernels", "segment_pool launch path, host us per call: "
          + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))

    # -- widths past one tile: edge_mpnn walks M in 64-column tiles, and
    # segment_pool has no width limit, so a wider model stays on both
    n_w, e_w = 300, 1000
    src_w = torch.from_numpy(rng.integers(0, n_w, e_w).astype(np.int32)
                             ).to(dev)
    tgt_w = torch.from_numpy(rng.integers(0, n_w + 5, e_w).astype(np.int32)
                             ).to(dev)  # >= n_w: padding
    h_w = normal(n_w, 256)
    w_w, b_w = normal(512, 384, scale=512 ** -0.5), normal(384, scale=0.1)
    mpnn_err = _close(
        torch, "edge_mpnn[fp32, 256+256 -> 384]",
        edge_mpnn(h_w, h_w, src_w, tgt_w, w_w, b_w, n_src=n_w, n_tgt=n_w),
        edge_mpnn_ref(h_w, h_w, src_w, tgt_w, w_w, b_w, n_src=n_w,
                      n_tgt=n_w), 1e-5, 1e-5)
    v_w = normal(e_w, 640)
    pool_err = _close(torch, "segment_pool[sum, fp32, 640 wide]",
                      segment_pool(v_w, tgt_w, n_segments=n_w),
                      segment_pool_ref(v_w, tgt_w, n_segments=n_w),
                      1e-5, 1e-5)
    phase("kernels", f"wide: edge_mpnn 512 -> 384 (six column tiles) max "
          f"err {mpnn_err:.2e}, segment_pool 640 wide max err "
          f"{pool_err:.2e}")
    return records


def trained_inputs(torch, batch) -> types.SimpleNamespace:
    """The has_topic conv of the first 16-root training batch (n_src
    papers, n_tgt fields, E edges, 128 wide), its targets sorted as the
    batcher emits them (padding last) and in a seeded random order, with
    values drawn from seed SEED + 4, and the zoo's attention scores on the
    same edges ([E, 4]: gatv2 / hgt_like's 4 heads)."""
    from repro_torch.kernels.registry import kernel_ids
    dev = torch.device(DEVICE)
    es = batch.edge_sets["has_topic"]
    n_src = batch.node_sets["paper"].capacity
    n_tgt = batch.node_sets["field_of_study"].capacity
    e, d = es.capacity, DIM
    src = kernel_ids(es.adjacency.source)
    tgt = kernel_ids(torch.where(es.mask(), es.adjacency.target,
                                 torch.full_like(es.adjacency.target,
                                                 n_tgt)))
    if not bool((tgt[1:] >= tgt[:-1]).all()):
        fail("training batch: has_topic targets are not sorted")
    rng = np.random.default_rng(SEED + 4)
    perm = torch.from_numpy(rng.permutation(e)).to(dev)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    h_src, h_tgt = normal(n_src, d), normal(n_tgt, d)
    w, b = normal(2 * d, d, scale=(2 * d) ** -0.5), normal(d, scale=0.1)
    vals = normal(e, d)
    ints = torch.from_numpy(rng.integers(-8, 8, (e, d)).astype(np.float32)
                            ).to(dev)
    scores = normal(e, ATTN_HEADS)
    return types.SimpleNamespace(
        rng=rng, normal=normal, n_src=n_src, n_tgt=n_tgt, e=e, d=d,
        layouts={"sorted": (src, tgt), "unsorted": (src[perm], tgt[perm])},
        src=src, tgt=tgt, n_valid=int((tgt < n_tgt).sum()),
        n_runs=int(torch.unique(tgt[tgt < n_tgt]).numel()),
        counts=torch.zeros(n_tgt + 1, dtype=torch.int64, device=dev
                           ).index_add_(0, tgt.long(),
                                        torch.ones_like(tgt.long()))[:n_tgt],
        h_src=h_src, h_tgt=h_tgt, w=w, b=b, vals=vals, ints=ints,
        scores=scores)


def runs_kernels_phase(torch, batch, records, build_report):
    """The run kernels at the trained shape (`trained_inputs`), on sorted
    and unsorted ids, and `segment_pool_runs` at the zoo's score shape."""
    from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn, edge_mpnn_runs
    from repro_torch.kernels.edge_mpnn.ref import activate, edge_mpnn_ref
    from repro_torch.kernels.segment_pool.kernel import (segment_pool,
                                                         segment_pool_runs)
    from repro_torch.kernels.segment_pool.ref import segment_pool_ref

    dev = torch.device(DEVICE)
    t = trained_inputs(torch, batch)
    n_src, n_tgt, e, d = t.n_src, t.n_tgt, t.e, t.d
    rng, normal, src, tgt, layouts = t.rng, t.normal, t.src, t.tgt, t.layouts
    n_valid, n_runs, counts = t.n_valid, t.n_runs, t.counts
    h_src, h_tgt, w, b = t.h_src, t.h_tgt, t.w, t.b

    def message_sums(act):
        """Per target row, the sum of |message| over its edges."""
        x = torch.cat([h_src[src.long()], h_tgt[tgt.clamp(max=n_tgt - 1)
                                                .long()]], dim=-1)
        msg = activate(x @ w + b, act)
        msg = torch.where((tgt < n_tgt)[:, None], msg.abs(), 0.0)
        return torch.zeros(n_tgt + 1, d, device=dev).index_add_(
            0, tgt.long(), msg)[:n_tgt]

    # -- edge_mpnn_runs ------------------------------------------------------
    errs, fp64_errs = [], []
    for act in ("relu", "gelu", "identity"):
        abs_sum = message_sums(act)
        for layout, (s_ids, t_ids) in layouts.items():
            for dtype in (torch.float32, torch.bfloat16):
                args = [t.to(dtype) for t in (h_src, h_tgt, w, b)]
                got = edge_mpnn_runs(args[0], args[1], s_ids, t_ids,
                                     args[2], args[3], n_src=n_src,
                                     n_tgt=n_tgt, activation=act)
                want = edge_mpnn_ref(args[0], args[1], s_ids, t_ids,
                                     args[2], args[3], n_src=n_src,
                                     n_tgt=n_tgt, activation=act)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != (n_tgt, d):
                    fail(f"edge_mpnn_runs: got {got.dtype} "
                         f"{tuple(got.shape)}")
                name = f"edge_mpnn_runs[{layout}, {dtype}, {act}]"
                if dtype == torch.float32:
                    errs.append(_close_sum(torch, name, got, want, abs_sum,
                                           counts, 1e-5))
                    fp64_errs.append(fp64_check(
                        torch, f"{name} vs fp64", got, want, edge_fp64(
                            torch, h_src, h_tgt, s_ids, t_ids, w, b, n_tgt,
                            act)))
                else:  # the cast back to bf16 dominates
                    _close(torch, name, got, want, 2e-2, 2e-2)
    # sorted targets: every call returns the same bits (carry.cuh), the
    # padding node's run across its tiles included
    for act in ("relu", "gelu", "identity"):
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dtype) for t in (h_src, h_tgt, w, b)]
            repeat_check(torch, f"edge_mpnn_runs[sorted, {dtype}, {act}]",
                         lambda: edge_mpnn_runs(
                             args[0], args[1], src, tgt, args[2], args[3],
                             n_src=n_src, n_tgt=n_tgt, activation=act))
    ms = time_ms(torch, lambda: edge_mpnn_runs(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    plain_ms = time_ms(torch, lambda: edge_mpnn_ref(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    any_order_ms = time_ms(torch, lambda: edge_mpnn(
        h_src, h_tgt, src, tgt, w, b, n_src=n_src, n_tgt=n_tgt))
    bound_ms, bound_by = _bound(
        edge_bytes(torch, h_src, h_tgt, src, tgt, w, b, n_tgt * d, 4),
        2 * n_valid * (2 * d) * d)
    records["edge_mpnn_runs"] = dict(
        name="edge_mpnn_runs", route="cuda",
        source="src/repro_torch/kernels/edge_mpnn/edge_mpnn_runs.cu",
        replaces="src/repro/kernels/edge_mpnn/kernel.py:129",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
        fp64_err=max(k for k, _ in fp64_errs),
        plain_fp64_err=max(p for _, p in fp64_errs))
    records["edge_mpnn_runs"].update(edge_kernel_costs(
        torch, edge_mpnn_runs, (h_src, h_tgt, src, tgt, w, b),
        dict(n_src=n_src, n_tgt=n_tgt), n_valid, n_tgt * d, build_report))
    phase("kernels", f"edge_mpnn_runs sorted+unsorted x fp32/bf16 x "
          f"relu/gelu/identity match the plain version (fp32 max err "
          f"{max(errs):.2e}, the padding node's {int(counts.max())}-edge "
          f"run; vs fp64, worst of the 3 x 2 fp32 cases: kernel "
          f"{records['edge_mpnn_runs']['fp64_err']:.2e}, plain "
          f"{records['edge_mpnn_runs']['plain_fp64_err']:.2e}, held to "
          f"{FP64_ERR_MULTIPLE:g}x; sorted: {REPEATS} calls bit-identical "
          f"in fp32 and bf16); trained shape n_src {n_src} n_tgt {n_tgt} "
          f"E {e} ({n_valid} valid, {n_runs} target runs): sorted fp32 "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms vs edge_mpnn "
          f"{any_order_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    phase("kernels", edge_costs_line("edge_mpnn_runs",
                                     records["edge_mpnn_runs"]))

    # -- segment_pool_runs ---------------------------------------------------
    vals, ints = t.vals, t.ints
    abs_sum = segment_pool_ref(vals.abs(), tgt, n_segments=n_tgt)
    err = 0.0
    for layout, (_, t_ids) in layouts.items():
        kw = dict(n_segments=n_tgt)
        if not torch.equal(segment_pool_runs(ints, t_ids, **kw),
                           segment_pool_ref(ints, t_ids, **kw)):
            fail(f"segment_pool_runs[{layout}]: integer-valued fp32 sums "
                 "are not bit-identical")
        for reduce in ("max", "min"):
            if not torch.equal(
                    segment_pool_runs(vals, t_ids, reduce=reduce, **kw),
                    segment_pool_ref(vals, t_ids, reduce=reduce, **kw)):
                fail(f"segment_pool_runs[{layout}]: {reduce} differs from "
                     "the plain version")
        err = max(err, _close_sum(
            torch, f"segment_pool_runs[{layout}, sum, fp32]",
            segment_pool_runs(vals, t_ids, **kw),
            segment_pool_ref(vals, t_ids, **kw), abs_sum, counts, 0.0))
        vb = vals.to(torch.bfloat16)  # the cast back dominates
        got = segment_pool_runs(vb, t_ids, **kw)
        if got.dtype != torch.bfloat16:
            fail(f"segment_pool_runs: bf16 input gave {got.dtype}")
        _close(torch, f"segment_pool_runs[{layout}, sum, bf16]", got,
               segment_pool_ref(vb, t_ids, **kw), 2e-2, 2e-2)
    # sorted ids: every sum returns the same bits (carry.cuh), at the
    # trained shape and at drawn runs of 1 to 3000 rows, 128 and 4 wide
    for dtype in (torch.float32, torch.bfloat16):
        x = vals.to(dtype)
        repeat_check(torch, f"segment_pool_runs[sorted, sum, {dtype}]",
                     lambda: segment_pool_runs(x, tgt, n_segments=n_tgt))
    lengths = rng.integers(1, 3001, 12)
    long_ids = torch.from_numpy(np.repeat(np.arange(len(lengths)), lengths)
                                .astype(np.int32)).to(dev)
    long_counts = torch.from_numpy(lengths).to(dev)
    for width in (d, ATTN_HEADS):
        x = normal(long_ids.numel(), width)
        got = segment_pool_runs(x, long_ids, n_segments=len(lengths))
        _close_sum(torch, f"segment_pool_runs[runs of 1-3000, D {width}]",
                   got, segment_pool_ref(x, long_ids,
                                         n_segments=len(lengths)),
                   segment_pool_ref(x.abs(), long_ids,
                                    n_segments=len(lengths)),
                   long_counts, 0.0)
        repeat_check(torch, f"segment_pool_runs[runs of 1-3000, D {width}]",
                     lambda: segment_pool_runs(x, long_ids,
                                               n_segments=len(lengths)))
    exact = torch.zeros(n_tgt + 1, d, dtype=torch.float64, device=dev
                        ).index_add_(0, tgt.long(), vals.double())[:n_tgt]
    kernel_err = (segment_pool_runs(vals, tgt, n_segments=n_tgt).double()
                  - exact).abs().max()
    plain_err = (segment_pool_ref(vals, tgt, n_segments=n_tgt).double()
                 - exact).abs().max()
    ms = time_ms(torch, lambda: segment_pool_runs(vals, tgt,
                                                  n_segments=n_tgt))
    plain_ms = time_ms(torch, lambda: segment_pool_ref(vals, tgt,
                                                       n_segments=n_tgt))
    any_order_ms = time_ms(torch, lambda: segment_pool(vals, tgt,
                                                       n_segments=n_tgt))
    library_ms, zeroed_ms = index_add_yardsticks(torch, vals, tgt, n_tgt)
    isz = 4
    bound_ms, bound_by = _bound(n_valid * d * isz + e * 4 + n_tgt * d * isz,
                                n_valid * d)
    costs = pool_launch_costs(torch, segment_pool_runs, vals, tgt, n_tgt)
    records["segment_pool_runs"] = dict(
        name="segment_pool_runs", route="cuda",
        source="src/repro_torch/kernels/segment_pool/runs.cu",
        replaces="src/repro/kernels/segment_pool/kernel.py:142",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library_zeroed_ms=zeroed_ms, any_order_ms=any_order_ms, **costs)
    phase("kernels", f"segment_pool_runs sorted+unsorted: int sums "
          f"bit-exact, max/min exact, sorted sums {REPEATS} calls "
          f"bit-identical (fp32, bf16; also at runs of "
          f"{int(lengths.min())}-{int(lengths.max())} rows, D {d} and "
          f"{ATTN_HEADS}), sum fp32 max err {err:.2e} (vs "
          f"fp64: kernel {kernel_err.item():.2e}, plain "
          f"{plain_err.item():.2e}), bf16 cast back; sorted sum {ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms vs segment_pool {any_order_ms:.4f} ms "
          f"vs index_add_ {library_ms:.4f} ms (zeros + index_add_ "
          f"{zeroed_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by}); per "
          f"call: host {costs['host_us']:.2f} us, device "
          f"{costs['device_us']:.2f} us ("
          + ", ".join(f"{k} {v:.2f}"
                      for k, v in costs["device_us_by_name"].items())
          + f"), device kernels "
          f"{costs['kernels_by_case']}, memsets {costs['memsets']}")

    # -- the zoo's attention scores: segment_softmax's max and exp-sum over
    # [E, 4] on the same sorted targets (gatv2 / hgt_like, 4 heads)
    scores = t.scores
    smax = segment_pool_runs(scores, tgt, n_segments=n_tgt, reduce="max")
    if not torch.equal(smax, segment_pool_ref(scores, tgt, n_segments=n_tgt,
                                              reduce="max")):
        fail("segment_pool_runs[D 4, max] differs from the plain version")
    ex = torch.where((tgt < n_tgt)[:, None],
                     torch.exp(scores - smax[tgt.clamp(max=n_tgt - 1).long()]),
                     0.0)
    ex_sum = segment_pool_ref(ex, tgt, n_segments=n_tgt)
    d4_err = _close_sum(torch, "segment_pool_runs[D 4, sum]",
                        segment_pool_runs(ex, tgt, n_segments=n_tgt), ex_sum,
                        ex_sum, counts, 0.0)
    repeat_check(torch, "segment_pool_runs[D 4, sum]",
                 lambda: segment_pool_runs(ex, tgt, n_segments=n_tgt))
    d4_bound = _bound(n_valid * ATTN_HEADS * isz + e * 4
                      + n_tgt * ATTN_HEADS * isz, n_valid * ATTN_HEADS)
    d4 = {}
    for reduce, x in (("max", scores), ("sum", ex)):
        kernel_fn = functools.partial(segment_pool_runs, x, tgt,
                                      n_segments=n_tgt, reduce=reduce)
        dev_cost = device_per_call(torch, kernel_fn)
        if dev_cost["kernels"] != POOL_BUDGET["segment_pool_runs"][
                f"{reduce} fp32"]:
            fail(f"segment_pool_runs[D 4, {reduce}]: {dev_cost['kernels']} "
                 "device kernels per call")
        d4[reduce] = dict(
            ms=time_ms(torch, kernel_fn),
            plain_ms=time_ms(torch, functools.partial(
                segment_pool_ref, x, tgt, n_segments=n_tgt, reduce=reduce)),
            host_us=host_us(torch, kernel_fn),
            device_us=dev_cost["device_us"],
            device_kernels=dev_cost["kernels"], memsets=dev_cost["memsets"],
            bound_ms=d4_bound[0])
    records["segment_pool_runs"]["d4_scores"] = d4
    phase("kernels", f"segment_pool_runs at the zoo's score shape [E {e}, "
          f"{ATTN_HEADS}]: max exact, exp-sum max err {d4_err:.2e}, "
          f"{REPEATS} calls bit-identical; "
          + "; ".join(f"{r} {c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} "
                      f"ms, host {c['host_us']:.2f} us, device "
                      f"{c['device_us']:.2f} us in {c['device_kernels']} "
                      f"kernels + {c['memsets']} memsets"
                      for r, c in d4.items())
          + f", bound {d4_bound[0]:.5f} ms ({d4_bound[1]})")
    # -- the mean model's pools under model=2: [E, 64] chunks of the
    # 128-wide messages, on the same sorted targets
    v64 = normal(e, d // 2)
    d64_err = _close_sum(torch, "segment_pool_runs[D 64, sum]",
                         segment_pool_runs(v64, tgt, n_segments=n_tgt),
                         segment_pool_ref(v64, tgt, n_segments=n_tgt),
                         segment_pool_ref(v64.abs(), tgt, n_segments=n_tgt),
                         counts, 0.0)
    repeat_check(torch, "segment_pool_runs[D 64, sum]",
                 lambda: segment_pool_runs(v64, tgt, n_segments=n_tgt))
    d64_bound = _bound(n_valid * (d // 2) * isz + e * 4
                       + n_tgt * (d // 2) * isz, n_valid * (d // 2))
    d64 = dict(
        max_abs_err=d64_err,
        ms=time_ms(torch, lambda: segment_pool_runs(v64, tgt,
                                                    n_segments=n_tgt)),
        plain_ms=time_ms(torch, lambda: segment_pool_ref(
            v64, tgt, n_segments=n_tgt)),
        library_ms=index_add_yardsticks(torch, v64, tgt, n_tgt)[0],
        bound_ms=d64_bound[0], bound_by=d64_bound[1])
    records["segment_pool_runs"]["d64_chunk"] = d64
    phase("kernels", f"segment_pool_runs at the model=2 chunk shape [E {e}, "
          f"{d // 2}], sorted: sum max err {d64_err:.2e}, {REPEATS} calls "
          f"bit-identical; {d64['ms']:.4f} ms vs plain "
          f"{d64['plain_ms']:.4f} ms vs index_add_ {d64['library_ms']:.4f} "
          f"ms, bound {d64['bound_ms']:.5f} ms ({d64['bound_by']})")
    syncs = sync_check(torch, batch)
    if syncs.pop(BINCOUNT) is None:
        fail("the sync check saw no host sync in torch.bincount, which "
             "reads its input's max back to the host")
    if any(syncs.values()):
        fail(f"a mean pool or node_degree synchronised the host: {syncs}")
    phase("kernels", f"no host sync under set_sync_debug_mode('error'): "
          f"{', '.join(syncs)}; the control, torch.bincount, raised")

    # -- widths past one tile, on sorted ids ---------------------------------
    n_w, e_w = 300, 1000
    src_w = torch.from_numpy(rng.integers(0, n_w, e_w).astype(np.int32)
                             ).to(dev)
    tgt_w = torch.from_numpy(np.sort(rng.integers(0, n_w + 5, e_w))
                             .astype(np.int32)).to(dev)  # >= n_w: padding
    h_w = normal(n_w, 256)
    w_w, b_w = normal(512, 384, scale=512 ** -0.5), normal(384, scale=0.1)
    mpnn_err = _close(
        torch, "edge_mpnn_runs[fp32, 256+256 -> 384]",
        edge_mpnn_runs(h_w, h_w, src_w, tgt_w, w_w, b_w, n_src=n_w,
                       n_tgt=n_w),
        edge_mpnn_ref(h_w, h_w, src_w, tgt_w, w_w, b_w, n_src=n_w,
                      n_tgt=n_w), 1e-5, 1e-5)
    v_w = normal(e_w, 640)
    pool_err = _close(torch, "segment_pool_runs[sum, fp32, 640 wide]",
                      segment_pool_runs(v_w, tgt_w, n_segments=n_w),
                      segment_pool_ref(v_w, tgt_w, n_segments=n_w),
                      1e-5, 1e-5)
    phase("kernels", f"wide, sorted: edge_mpnn_runs 512 -> 384 (six column "
          f"tiles) max err {mpnn_err:.2e}, segment_pool_runs 640 wide (five "
          f"128-column slices) max err {pool_err:.2e}")


# ---------------------------------------------------------------------------
# the served model
# ---------------------------------------------------------------------------

def mag_edges() -> dict:
    from repro_torch.core.schema import mag_schema
    schema = mag_schema()
    return {k: (v.source, v.target) for k, v in schema.edge_sets.items()}


def init_states(torch):
    """The §8 init states: paper features -> hidden states, fp32
    id-embedding tables for the featureless node sets (ids % 4096), all
    128 wide."""
    from repro_torch.core.graph_tensor import HIDDEN_STATE
    from repro_torch.nn.layers import Embedding, Linear

    class InitStates(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.paper = Linear(FEAT_DIM, DIM)
            self.tables = torch.nn.ModuleDict({
                n: Embedding(VOCAB, DIM)
                for n in ("author", "institution", "field_of_study")})

        def forward(self, graph):
            ns = {"paper": {HIDDEN_STATE: torch.relu(self.paper(
                graph.node_sets["paper"]["feat"]))}}
            for n, table in self.tables.items():
                ids = graph.node_sets[n]["id"] % VOCAB
                ns[n] = {HIDDEN_STATE: table(ids, dtype=torch.float32)}
            return graph.replace_features(node_sets=ns)

    return InitStates()


def model_parts(torch, reduce_type: str):
    """(init states, gnn) of the §8 model: `init_states`, then
    vanilla_mpnn (5 edge sets, 4 rounds, 128/128, LayerNorm)."""
    from repro_torch.core.models import vanilla_mpnn
    edges = mag_edges()
    dims = {n: DIM for n in ("author", "field_of_study", "institution",
                             "paper")}
    return init_states(torch), vanilla_mpnn(
        edges, dims, message_dim=DIM, hidden_dim=DIM, num_rounds=ROUNDS,
        use_layer_norm=True, reduce_type=reduce_type)


def root_task(hidden: int = DIM):
    from repro_torch.orchestration.tasks import (
        RootNodeMulticlassClassification)
    return RootNodeMulticlassClassification("paper", N_CLASSES, hidden)


def build_model(torch, reduce_type: str):
    """The served model: init states -> gnn -> RootNodeMulticlass head,
    with parameters drawn from a seeded generator."""
    from repro_torch.nn.layers import init_params

    class Served(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.task = root_task()
            self.init, self.gnn = model_parts(torch, reduce_type)
            self.head = self.task.head()

        def forward(self, graph):
            return self.task.predict(self.head, self.gnn(self.init(graph)))

    return init_params(Served(), SEED).to(DEVICE).eval()


def section8_spec(schema):
    """The §8 sampling spec of examples/ogbn_mag_train.py."""
    from repro_torch.data.sampling import SamplingSpecBuilder
    b = SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(8, "cites")
    authors = cited.join([seed_op]).sample(4, "written")
    author_papers = authors.sample(4, "writes")
    authors.sample(4, "affiliated_with")
    author_papers.join([seed_op, cited]).sample(4, "has_topic")
    return seed_op.build()


def plain_logits(torch, server, store, spec, roots):
    """The same forward on the card through the plain versions, on the
    batch the server pads these roots to."""
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    from repro_torch.kernels import registry
    graphs = [sample_subgraph(store, spec, int(r), seed_rng(0, int(r)))
              for r in roots]
    sizes = server.ladder.sizes[server.ladder.bucket_for(len(roots))]
    with registry.plain_versions():
        return server.run_eager(merge_and_pad(graphs, sizes))[:len(roots)]


def check_logits(name, got, want, n):
    if got.shape != (n, N_CLASSES) or not np.isfinite(got).all():
        fail(f"{name}: logits {got.shape}, finite={np.isfinite(got).all()}")
    if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
        fail(f"{name}: served logits differ from the plain forward by "
             f"{np.abs(got - want).max():.3e} (rtol 1e-4, atol 1e-4)")
    return float(np.abs(got - want).max())


def fresh_roots(rng, used: set, n: int, n_papers: int) -> list:
    """`n` roots never requested before (no embedding-cache hits)."""
    out = []
    while len(out) < n:
        r = int(rng.integers(n_papers))
        if r not in used:
            used.add(r)
            out.append(r)
    return out


def device_profile(torch, prof) -> tuple:
    """(device busy ms, device kernel count, top kernels by device time)
    of a torch.profiler run; device-side events only (CPU ops would count
    twice)."""
    by_kernel = {}
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if getattr(ev, "device_type", None) == cuda and us > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            total, count = by_kernel.get(name, (0, 0))
            by_kernel[name] = (total + us, count + ev.count)
    busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
    n_kernels = sum(n for _, n in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    profile = (", ".join(f"{k[:48]} {us / 1e3:.3f} ms x{n}"
                         for k, (us, n) in top)
               if by_kernel else "profiler saw no device time")
    return busy_ms, n_kernels, profile


def breakdown(torch, server, model, store, spec, roots) -> str:
    """Where one rung-8 request batch spends its time: host stages on the
    host clock (each ending in a synchronize), the forward's device time
    from CUDA events, and device time by kernel from torch.profiler.
    Eagerly the copy in is `to_device` and the forward the model's
    launches plus the copy out; with graphs the copy in is the rung's
    pinned stage and the forward its replay plus the copy out."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    t0 = time.perf_counter()
    graphs = [sample_subgraph(store, spec, r, seed_rng(0, r)) for r in roots]
    t1 = time.perf_counter()
    merged = merge_and_pad(graphs, server.ladder.sizes[len(roots)])
    t2 = time.perf_counter()
    if server.capture_graphs:
        rung_graph = server._graphs[len(roots)]
        rung_graph.stage(merged)
        torch.cuda.synchronize()
        t3 = time.perf_counter()

        def forward():
            return rung_graph.replay(server.device)
    else:
        g = to_device(merged, server.device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()

        def forward():
            return model(g).cpu()
    with torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t4 = time.perf_counter()
        start.record()
        forward()
        end.record()
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            forward()
            torch.cuda.synchronize()
    busy_ms, n_kernels, profile = device_profile(torch, prof)
    fwd_ms = (t5 - t4) * 1e3
    mode = "graph replay" if server.capture_graphs else "eager"
    copy_in = "stage" if server.capture_graphs else "to_device"
    return (f"rung {len(roots)} {mode}: sample {(t1 - t0) * 1e3:.2f} ms, "
            f"merge+pad {(t2 - t1) * 1e3:.2f} ms, {copy_in} "
            f"{(t3 - t2) * 1e3:.2f} ms, forward wall {fwd_ms:.2f} ms "
            f"(CUDA events {start.elapsed_time(end):.2f} ms), profiler "
            f"device busy {busy_ms:.3f} ms = "
            f"{100 * busy_ms / fwd_ms:.1f}% of the forward wall, "
            f"{n_kernels} device kernels; top: {profile}")


def kernel_wrappers() -> tuple:
    """The five kernel wrappers, each with its own launch count."""
    from repro_torch.kernels.edge_mpnn import kernel as mpnn
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.segment_pool import kernel as seg
    return (mpnn.edge_mpnn, mpnn.edge_mpnn_runs, seg.segment_pool,
            seg.segment_pool_runs, flash.flash_attention)


def zero_launches() -> None:
    for fn in kernel_wrappers():
        fn.launches = 0


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def closed_loop(server, roots_per_client, timeout=120.0):
    """One thread per client, one outstanding request each; returns
    (latencies_ms, errors, duration_s)."""
    latencies, errors, lock = [], [0], threading.Lock()

    def client(roots):
        for r in roots:
            req = server.submit(r)
            try:
                req.result(timeout)
            except Exception:  # noqa: BLE001 — counted, reported and failed on below
                with lock:
                    errors[0] += 1
                continue
            with lock:
                latencies.append(req.latency_s * 1e3)

    threads = [threading.Thread(target=client, args=(roots,), daemon=True,
                                name=f"client-{i}")
               for i, roots in enumerate(roots_per_client)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    duration = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail("closed-loop clients did not finish")
    return latencies, errors[0], duration


# ---------------------------------------------------------------------------
# phase 4: serve the §8 model through GNNServer on the card
# ---------------------------------------------------------------------------

# device kernels a served graph must not hold: the run variants (served
# batches are unsorted) and copies (inputs are staged before the replay)
RUN_KERNELS = ("edge_mpnn_runs_kernel", "seg_runs_tile_kernel",
               "seg_runs_rows_kernel", "carry_fold_kernel")


def graph_server(torch, store, spec, model):
    """A GNNServer capturing one CUDA graph per rung, with each rung's
    kernel launches during its capture: (server, {rung: {kernel:
    launches}}, warmup seconds).  The capture is spied on so that the
    launch count reads the capture alone (warmup first runs each rung
    eagerly, outside capture)."""
    from repro_torch.serve.gnn import GNNServer
    t0 = time.perf_counter()
    server = GNNServer(store, spec, model, device=DEVICE,
                       max_batch=MAX_BATCH, batch_window_ms=5.0,
                       warmup=False)
    captured, capture = {}, server._capture

    def counted(rung, merged):
        before = read_launches()
        out = capture(rung, merged)
        captured[rung] = {k: v - before[k]
                          for k, v in read_launches().items()}
        return out

    server._capture = counted
    try:
        server.warmup()
    except Exception:
        server.close()
        raise
    return server, captured, time.perf_counter() - t0


def replay_kernels(torch, server) -> dict:
    """{rung: device kernels by name in one replay of its graph} from
    torch.profiler (`device_per_call` over 5 replays of the static
    inputs as they stand)."""
    return {rung: device_per_call(torch, rung_graph.graph.replay, calls=5)
            for rung, rung_graph in sorted(server._graphs.items())}


def check_graphs(name, server, captured, replays, kernel, device_kernel,
                 per_forward, forbidden=()):
    """Every rung captured at warmup, `per_forward` launches of wrapper
    `kernel` (and no other wrapper's) in each capture and as many
    `device_kernel`s in one replay, none of `forbidden` or a copy."""
    rungs = tuple(server.ladder.rungs)
    if tuple(sorted(server._graphs)) != rungs or \
            server.steady_state_recompiles != 0:
        fail(f"{name}: captured rungs {sorted(server._graphs)} for ladder "
             f"{rungs}, {server.steady_state_recompiles} captures after "
             "warmup")
    for rung in rungs:
        want = {k: per_forward if k == kernel else 0
                for k in captured.get(rung, {})}
        if captured.get(rung) != want or not want:
            fail(f"{name}: rung {rung} capture launched "
                 f"{captured.get(rung)} ({per_forward} {kernel} expected)")
        seen = replays[rung]["launches_by_name"]
        bad = [k for k in seen if k in forbidden or "memcpy" in k.lower()]
        if seen.get(device_kernel) != per_forward or bad:
            fail(f"{name}: one replay of rung {rung} ran {seen} "
                 f"({per_forward} {kernel} device kernels expected, none "
                 f"of {list(forbidden)} or copies)")


def convs_per_forward(torch, server, model) -> int:
    """Convolutions a forward runs, each checked to be on the edge kernel
    (`describe_dispatch` at every rung)."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.grouping import merge_and_pad
    graph = server._subgraphs.get(0)
    n_convs = 0
    for rung in server.ladder.rungs:
        g = to_device(merge_and_pad([graph], server.ladder.sizes[rung]),
                      server.device)
        with torch.inference_mode():
            rounds = model.gnn.describe_dispatch(model.init(g))
        for rnd, per_set in enumerate(rounds):
            for ns, convs in per_set.items():
                for es, dec in convs.items():
                    if dec is None or not dec.use_kernel:
                        fail(f"rung {rung} round {rnd} {ns}<-{es} is "
                             f"not on the kernel: {dec}")
                    n_convs += 1
    per_forward = n_convs // len(server.ladder.rungs)
    if per_forward != 5 * ROUNDS:
        fail(f"{per_forward} convs per forward, expected {5 * ROUNDS}")
    return per_forward


def serve_mode(torch, store, spec, model, capture: bool) -> dict:
    """Serve the fresh-root checks and the closed loop through one
    server, eager or from one CUDA graph per rung; the same seeded roots
    in both modes.  Fails on any error, recompile, run kernel or wrong
    launch count; returns the numbers the phase prints."""
    from repro_torch.serve.gnn import GNNServer
    zero_launches()
    if capture:
        server, captured, warm_s = graph_server(torch, store, spec, model)
    else:
        t0 = time.perf_counter()
        server = GNNServer(store, spec, model, device=DEVICE,
                           max_batch=MAX_BATCH, batch_window_ms=5.0,
                           capture_graphs=False)
        warm_s = time.perf_counter() - t0
    warm_launches = read_launches()
    mode = "graphs" if capture else "eager"
    try:
        if server.ladder.rungs != (1, 2, 4, 8):
            fail(f"bucket ladder {server.ladder.rungs}, expected (1, 2, 4, 8)")
        per_forward = convs_per_forward(torch, server, model)
        rng = np.random.default_rng(SEED + 1)
        used = {0}
        n_papers = store.num_nodes["paper"]
        zero_launches()
        batches0 = server.stats.batches
        checks = []
        for n in (1, 2, 4, 8, 3, 8):
            roots = fresh_roots(rng, used, n, n_papers)
            checks.append((roots, server.serve_sync(roots, timeout=120)))
        clients = [fresh_roots(rng, used, LOOP_REQUESTS, n_papers)
                   for _ in range(LOOP_CLIENTS)]
        latencies, errors, duration = closed_loop(server, clients)
        stats = server.stats
        counts = read_launches()
        batches = stats.batches - batches0
        if counts["edge_mpnn_runs"] or counts["segment_pool_runs"]:
            fail(f"serving ({mode}) launched a run kernel: {counts} (its "
                 "batches are not sorted by target)")
        if errors or stats.failed:
            fail(f"{mode}: {errors} client errors, {stats.failed} failed "
                 "requests")
        if stats.steady_state_recompiles != 0:
            fail(f"{mode}: {stats.steady_state_recompiles} steady-state "
                 "recompiles")
        if set(stats.batch_sizes) != set(server.ladder.rungs):
            fail(f"{mode}: served buckets {sorted(stats.batch_sizes)} do "
                 f"not cover the ladder {server.ladder.rungs}")
        replays = None
        if capture:
            replays = replay_kernels(torch, server)
            rungs = len(server.ladder.rungs)
            check_graphs("serve", server, captured, replays, "edge_mpnn",
                         "edge_mpnn_kernel", per_forward, RUN_KERNELS)
            # warmup: one eager forward and one capture per rung; replays
            # launch nothing through the wrappers
            if warm_launches["edge_mpnn"] != 2 * per_forward * rungs or any(
                    counts.values()):
                fail(f"serve graphs: warmup launches {warm_launches}, "
                     f"serving launches {counts} ({2 * per_forward * rungs}"
                     " edge_mpnn at warmup, none in replays expected)")
            launches = warm_launches["edge_mpnn"]
        else:
            launches = counts["edge_mpnn"]
            if launches != per_forward * batches:
                fail(f"edge_mpnn launched {launches} times for {batches} "
                     f"batches ({per_forward} per forward expected)")
        max_err = max(check_logits(f"serve {mode}", got, plain_logits(
            torch, server, store, spec, roots), len(roots))
            for roots, got in checks)
        profile = breakdown(torch, server, model, store, spec,
                            fresh_roots(rng, used, MAX_BATCH, n_papers))
    finally:
        server.close()
    return dict(mode=mode, warm_s=warm_s, server=server, stats=stats,
                batches=batches, launches=launches, per_forward=per_forward,
                pool_launches=counts["segment_pool"], max_err=max_err,
                profile=profile, replays=replays,
                p50=np.percentile(latencies, 50),
                p99=np.percentile(latencies, 99),
                qps=len(latencies) / duration, n=len(latencies))


def serve_phase(torch, store, spec, card) -> tuple:
    """The §8 model served twice in one call, the same requests each
    time: eagerly (each batch's forward launched op by op) and from one
    CUDA graph per rung captured at warmup.  Returns edge_mpnn's launches
    (eager serving, and the graph server's warmup)."""
    model = build_model(torch, "sum")
    runs = [serve_mode(torch, store, spec, model, capture)
            for capture in (False, True)]
    for r in runs:
        phase("profile", r["profile"])
    for r in runs:
        stats = r["stats"]
        if r["replays"] is None:
            launch_text = (f"edge_mpnn launches {r['launches']}, "
                           f"segment_pool launches {r['pool_launches']}")
        else:
            per_replay = {rung: rec["launches_by_name"].get(
                "edge_mpnn_kernel") for rung, rec in r["replays"].items()}
            us = {rung: round(rec["device_us"], 1)
                  for rung, rec in r["replays"].items()}
            launch_text = (f"{len(r['replays'])} rungs captured at warmup "
                           f"({r['per_forward']} edge_mpnn launches a "
                           f"capture, {r['launches']} with the eager warm "
                           f"runs), none in replays; one replay's "
                           f"edge_mpnn_kernel by rung {per_replay}, device "
                           f"us {us}")
        phase("serve", f"{card} {r['mode']}: warmup {r['warm_s']:.1f}s, "
              f"ladder {list(r['server'].ladder.rungs)}, "
              f"{r['per_forward']} convs/forward all on edge_mpnn, "
              f"{r['batches']} batches "
              f"{dict(sorted(stats.batch_sizes.items()))}, {launch_text}, "
              f"logits vs plain max err {r['max_err']:.2e}, closed loop "
              f"{LOOP_CLIENTS} clients x {LOOP_REQUESTS} = {r['n']} "
              f"requests: p50 {r['p50']:.2f} ms p99 {r['p99']:.2f} ms "
              f"{r['qps']:.1f} QPS, 0 recompiles, 0 failed")
    return runs[0]["launches"], runs[1]["launches"]


# ---------------------------------------------------------------------------
# phase 5: the mean-pooling variant (generic conv path -> segment_pool)
# ---------------------------------------------------------------------------

def mean_phase(torch, store, spec):
    """The mean-pooling model served from one CUDA graph per rung: each
    capture holds 5 x ROUNDS segment_pool launches and each replay as
    many `scatter_kernel`s, no edge or run kernel.  Returns segment_pool's
    launches (the warmup's eager runs and captures)."""
    model = build_model(torch, "mean")
    zero_launches()
    server, captured, _ = graph_server(torch, store, spec, model)
    warm = read_launches()
    rng = np.random.default_rng(SEED + 2)
    used = set()
    try:
        zero_launches()
        batches0 = server.stats.batches
        checks = []
        for n in (8, 5):
            roots = fresh_roots(rng, used, n, store.num_nodes["paper"])
            checks.append((roots, server.serve_sync(roots, timeout=120)))
        stats = server.stats
        counts = read_launches()
        batches = stats.batches - batches0
        replays = replay_kernels(torch, server)
        max_err = max(check_logits("mean", got, plain_logits(
            torch, server, store, spec, roots), len(roots))
            for roots, got in checks)
    finally:
        server.close()
    per_forward = 5 * ROUNDS
    rungs = len(server.ladder.rungs)
    if stats.failed or stats.steady_state_recompiles:
        fail(f"mean serve: {stats.failed} failed, "
             f"{stats.steady_state_recompiles} recompiles")
    check_graphs("mean", server, captured, replays, "segment_pool",
                 "scatter_kernel", per_forward,
                 RUN_KERNELS + ("edge_mpnn_kernel",))
    if warm["segment_pool"] != 2 * per_forward * rungs or any(
            v for k, v in warm.items() if k != "segment_pool") or any(
            counts.values()):
        fail(f"mean path: warmup launches {warm}, serving launches "
             f"{counts} ({2 * per_forward * rungs} segment_pool at warmup, "
             "none in replays expected)")
    us = {rung: round(rec["device_us"], 1) for rung, rec in replays.items()}
    phase("mean", f"mean-pooling model served from {rungs} CUDA graphs: "
          f"{batches} batches, {per_forward} segment_pool launches a "
          f"capture ({warm['segment_pool']} with the eager warm runs), "
          f"none in replays, {per_forward} scatter_kernel in one replay "
          f"of each rung (device us {us}), logits vs plain max err "
          f"{max_err:.2e}")
    return warm["segment_pool"]


# ---------------------------------------------------------------------------
# phase 5b: load generation through the port's loadgen, freshness, the twin
# ---------------------------------------------------------------------------

SERVELOOP_OPEN_S = 5.0


def serveloop_phase(torch, store, spec, smi) -> tuple:
    """The §8 model at full width from one CUDA graph per rung, driven by
    `repro_torch.serve.loadgen` over every paper: a closed loop (4
    clients x 125, seed 0), an open loop at half its QPS for 5 s (seed
    1), then freshness (`add_edges` on `cites` bumps the version, stale
    entries are evicted, the resampled root's logits match the plain
    forward within 1e-4); then the twin `gnn_serve.main([])` at the
    example's defaults must exit 0.  Mutates `store` (a cites edge), so
    later phases take the unwrapped store.  Returns edge_mpnn's launches
    here and in the twin."""
    from repro_torch.orchestration import gnn_serve
    from repro_torch.serve import closed_loop as loadgen_closed
    from repro_torch.serve import open_loop as loadgen_open
    model = build_model(torch, "sum")
    zero_launches()
    server, captured, warm_s = graph_server(torch, store, spec, model)
    n_papers = store.num_nodes["paper"]
    root = 5
    try:
        closed = loadgen_closed(server, range(n_papers),
                                clients=LOOP_CLIENTS,
                                requests_per_client=LOOP_REQUESTS,
                                seed=0, timeout=120)
        opened = loadgen_open(server, range(n_papers), qps=0.5 * closed.qps,
                              duration_s=SERVELOOP_OPEN_S, seed=1,
                              timeout=120)
        v0 = store.version
        store.add_edges("cites", [root], [n_papers - 1])
        after = server.submit(root).result(60)
        stats = server.stats
        err = check_logits("serveloop freshness", np.asarray(after)[None],
                           plain_logits(torch, server, store, spec, [root]),
                           1)
    finally:
        server.close()
    launches = read_launches()
    rungs = len(server.ladder.rungs)
    if closed.errors or opened.errors or stats.failed:
        fail(f"serveloop: errors closed {closed.errors}, open "
             f"{opened.errors}, failed {stats.failed}")
    if stats.steady_state_recompiles or server._captures != rungs:
        fail(f"serveloop: {stats.steady_state_recompiles} recompiles, "
             f"{server._captures} captures")
    if store.version != v0 + 1 or stats.invalidations <= 0:
        fail(f"serveloop freshness: version {v0} -> {store.version}, "
             f"{stats.invalidations} invalidations")
    if launches != {k: (2 * 5 * ROUNDS * rungs if k == "edge_mpnn" else 0)
                    for k in launches}:
        fail(f"serveloop: launches {launches} ({2 * 5 * ROUNDS * rungs} "
             "edge_mpnn at warmup, none in replays expected)")
    phase("serveloop", f"{smi}: warmup {warm_s:.1f}s, closed loop over "
          f"{n_papers} papers {closed.summary()}, open loop at "
          f"{0.5 * closed.qps:.1f} QPS for {SERVELOOP_OPEN_S:g} s "
          f"{opened.summary()}; freshness: version {v0} -> "
          f"{store.version}, {stats.invalidations} invalidations, root "
          f"{root} resampled, logits vs plain max err {err:.2e}; "
          f"embedding hits/misses {stats.embedding_hits}/"
          f"{stats.embedding_misses}, {stats.batches} batches "
          f"{dict(sorted(stats.batch_sizes.items()))}, 0 errors, 0 "
          f"recompiles, launches {launches['edge_mpnn']} edge_mpnn (warmup)")
    zero_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = gnn_serve.main([])
        except SystemExit as exc:
            rc = exc.code
    twin = read_launches()
    for line in out.getvalue().splitlines():
        phase("serveloop", f"twin: {line}")
    per_forward = 2  # two rounds over one edge set
    if rc != 0 or twin != {k: (2 * per_forward * rungs
                               if k == "edge_mpnn" else 0) for k in twin}:
        fail(f"serveloop: gnn_serve.main([]) returned {rc!r}, launches "
             f"{twin} ({2 * per_forward * rungs} edge_mpnn expected)")
    return launches["edge_mpnn"], twin["edge_mpnn"]


# ---------------------------------------------------------------------------
# phase 6: train the §8 model through the port's Trainer on the card
# ---------------------------------------------------------------------------

def train_setup(raw, spec):
    """Seeded train and held-out roots, and the batch size constraints
    profiled over their subgraphs (find_size_constraints, as the §8
    example sizes its batches)."""
    from repro_torch.data.batching import find_size_constraints
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    rng = np.random.default_rng(SEED + 3)
    n_train = TRAIN_STEPS * TRAIN_BATCH
    roots = rng.choice(raw.num_nodes["paper"], n_train + EVAL_ROOTS,
                       replace=False)
    graphs = [sample_subgraph(raw, spec, int(r), seed_rng(0, int(r)))
              for r in roots]
    return (roots[:n_train], roots[n_train:],
            find_size_constraints(graphs, TRAIN_BATCH))


def provider(raw, spec, roots, sizes):
    from repro_torch.orchestration.providers import StoreProvider
    return StoreProvider(raw, spec, roots, batch_size=TRAIN_BATCH,
                         sizes=sizes)


def fresh_model(torch, reduce_type: str = "sum", parts=None,
                hidden: int = DIM, task=None):
    """The Trainer's model at step 0: TrainModel(init, gnn, head) drawn
    with init_params(model, SEED), on the card; (init, gnn) are `parts`,
    or the §8 model with `reduce_type` pooling; the head is `task`'s (the
    root-node task's by default)."""
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration.trainer import TrainModel
    init, gnn = parts if parts is not None else model_parts(torch,
                                                            reduce_type)
    task = task if task is not None else root_task(hidden)
    model = TrainModel(init, gnn, task.head())
    return init_params(model, SEED).to(DEVICE)


def grad_check(torch, reduce_type: str, batch, labels, parts=None,
               hidden: int = DIM, task=None) -> tuple:
    """Step 1's gradients, kernel path vs plain path, on one batch and one
    set of parameters.  A parameter the loss reaches on one path must be
    reached on the other (slice 1's kernels returned tensors with no
    grad_fn, which would cut every conv off).  The loss reads only the
    root papers, so the institution and field_of_study states, and every
    node set's update in the last round but the papers', reach it on
    neither path: they get the zero gradient `jax.grad` gives them, as in
    the Trainer's step.  Every gradient must be finite and within
    GRAD_RTOL of its largest plain entry.  `parts` (init, gnn) with a
    `hidden`-wide output replace the §8 model (`reduce_type` then only
    names the model in messages), and `task` the root-node task.  Returns
    (worst relative error, parameters, parameters the loss reaches,
    kernel loss, plain loss).  A stacked `batch` ([R, ...] component
    groups, `labels` [R, C]) is held by the mean of its groups' losses."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.kernels import registry
    from repro_torch.core.graph_tensor import stack_size, unstack_graph
    task = task if task is not None else root_task(hidden)
    model = fresh_model(torch, reduce_type, parts, hidden, task)
    params = dict(model.named_parameters())
    g = to_device(batch, DEVICE)
    lab = torch.as_tensor(labels).to(DEVICE)
    # a stacked [R, ...] super-batch: the mean of its groups' losses, as
    # the mesh's step takes it
    groups, labs = ((unstack_graph(g), lab) if stack_size(g) is not None
                    else ([g], [lab]))

    def grads():
        loss = sum(task.loss_from_graph(model.head, model(x), y)
                   for x, y in zip(groups, labs)) / len(groups)
        return loss.item(), torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)

    with registry.layout(sorted_by_target=True):
        loss_k, g_k = grads()
        with registry.plain_versions():
            loss_p, g_p = grads()
    worst, reached = 0.0, 0
    for (name, p), a, b in zip(params.items(), g_k, g_p):
        if (a is None) != (b is None):
            fail(f"[{reduce_type}] {name}: the loss reaches it on the "
                 f"{'plain' if a is None else 'kernel'} path only")
        reached += a is not None
        a = torch.zeros_like(p) if a is None else a
        b = torch.zeros_like(p) if b is None else b
        if not bool(torch.isfinite(a).all()):
            fail(f"[{reduce_type}] {name}: non-finite gradient")
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if err > GRAD_RTOL * scale + 1e-7:
            fail(f"[{reduce_type}] {name}: kernel gradient differs from the "
                 f"plain one by {err:.3e} (largest plain entry "
                 f"{scale:.3e}, rtol {GRAD_RTOL})")
        if scale > 0:
            worst = max(worst, err / scale)
    return worst, len(params), reached, loss_k, loss_p


def fit(torch, reduce_type, train, evaluation, steps, plain=False,
        model_fn=None):
    """One Trainer.fit from seed 0: AdamW + warmup-cosine, the §8
    example's lr and schedule, on the card; the §8 model with
    `reduce_type` pooling unless `model_fn` gives another (init, gnn)."""
    from repro_torch.kernels import registry
    from repro_torch.orchestration.trainer import Trainer
    trainer = Trainer(learning_rate=TRAIN_LR, total_steps=TRAIN_TOTAL,
                      max_steps=steps, seed=SEED, log_every=10 ** 6,
                      device=DEVICE,
                      eval_at="end" if evaluation is not None else "never")
    if model_fn is None:
        def model_fn():
            return model_parts(torch, reduce_type)
    with registry.plain_versions() if plain else contextlib.nullcontext():
        return trainer.fit(model_fn, root_task(), train,
                           eval_provider=evaluation)


def step_loop(torch, train) -> tuple:
    """The Trainer's step written out, over the same stream from the same
    draw, on the kernel path: each stage timed on the host clock, ending
    in a synchronize (medians over the steps after the first), then one
    more step under torch.profiler for the device's busy share.  After
    each step's gradients, the same batch's loss is computed again through
    the plain versions on the same parameters (outside the timed stages
    and the profiled step), so the two paths are compared at every step
    with no drift between them.  Returns (summary, largest per-step
    |kernel - plain| loss gap)."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.kernels import registry
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.train_loop import apply_updates, loss_and_grads
    task = root_task()
    model = fresh_model(torch, "sum")
    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=warmup_cosine(TRAIN_LR, 50, TRAIN_TOTAL),
                weight_decay=1e-5)
    state = opt.init(params)

    def loss_fn(graph, labels):
        return task.loss_from_graph(model.head, model(graph), labels)

    stream = itertools.chain.from_iterable(
        train.epoch(e) for e in itertools.count())
    gaps = []

    def step(check_plain=True):
        nonlocal state
        t0 = time.perf_counter()
        host = next(stream)
        labels = task.labels(host)
        t1 = time.perf_counter()
        g = to_device(host, DEVICE)
        lab = torch.as_tensor(labels).to(DEVICE)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss, grads = loss_and_grads(loss_fn, params, g, lab)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if check_plain:  # not timed
            with registry.plain_versions(), torch.no_grad():
                gaps.append(abs(loss.item() - loss_fn(g, lab).item()))
        t3_plain = time.perf_counter()
        state = apply_updates(opt, params, state, grads)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        return [1e3 * x for x in (t1 - t0, t2 - t1, t3 - t2, t4 - t3_plain)]

    with registry.layout(sorted_by_target=True):
        rows = [step() for _ in range(TRAIN_STEPS)][1:]
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step(check_plain=False)
    med = [statistics.median(col) for col in zip(*rows)]
    wall = sum(med)
    busy_ms, n_kernels, profile = device_profile(torch, prof)
    return (f"step {wall:.2f} ms = sample+batch {med[0]:.2f} + host->card "
            f"{med[1]:.2f} + forward+backward {med[2]:.2f} + optimizer "
            f"{med[3]:.2f} (medians of {len(rows)} steps); profiled step: "
            f"device busy {busy_ms:.3f} ms = {100 * busy_ms / wall:.1f}% of "
            f"the step, {n_kernels} device kernels; top: {profile}"), \
        max(gaps)


def cpu_loss(torch, batch, labels) -> float:
    """Step 1's loss through the plain versions on the CPU: the same
    parameters (drawn on the host) and the same batch as the card's."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration.trainer import TrainModel
    task = root_task()
    init, gnn = model_parts(torch, "sum")
    model = init_params(TrainModel(init, gnn, task.head()), SEED)
    with torch.no_grad():
        return task.loss_from_graph(model.head, model(to_device(batch,
                                                               "cpu")),
                                    torch.as_tensor(labels)).item()


def eval_plain(torch, params, evaluation) -> dict:
    """`evaluate` over `evaluation` through the plain versions, with the
    model's parameters set to `params` ({name: tensor})."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.kernels import registry
    from repro_torch.orchestration.evaluation import evaluate
    from repro_torch.train.train_loop import make_graph_eval_step
    task = root_task()
    model = fresh_model(torch, "sum")
    model.load_state_dict(params)
    keys = task.metric_names()

    def metric_fn(graph, labels):
        pairs = task.metrics(model.head, model(graph), labels)
        return tuple(x for k in keys for x in pairs[k])

    with registry.plain_versions():
        return evaluate(evaluation, task, make_graph_eval_step(metric_fn),
                        lambda g, lab: (to_device(g, DEVICE),
                                        torch.as_tensor(lab).to(DEVICE)),
                        metric_keys=keys)


def train_phase(torch, raw, spec, card, setup) -> dict:
    """Train the sum model: step-1 gradient check, the counted Trainer
    run with its eval pass, the same run twice through the plain
    versions, the eval pass on the trained parameters through the plain
    versions, and the step loop (time split, same-parameter loss
    parity).  Returns edge_mpnn_runs' launches ("launches"), the counted
    run's per-step losses ("losses"), and its median step and batch-wait
    times ("step_ms", "wait_ms") over the steps after the first."""
    train_roots, eval_roots, sizes = setup
    train = provider(raw, spec, train_roots, sizes)
    evaluation = provider(raw, spec, eval_roots, sizes)
    task = root_task()
    first = next(iter(train.epoch(0)))
    worst, n_params, reached, loss_k, _ = grad_check(torch, "sum", first,
                                                     task.labels(first))
    loss_cpu = cpu_loss(torch, first, task.labels(first))
    if abs(loss_k - loss_cpu) > STEP_LOSS_ATOL:
        fail(f"train: step-1 loss on the card {loss_k:.6f} vs the plain "
             f"versions on the CPU {loss_cpu:.6f}")

    zero_launches()
    run = fit(torch, "sum", train, evaluation, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = read_launches()
    eval_steps = evaluation.num_steps
    forwards = run.step + eval_steps
    if run.step != TRAIN_STEPS:
        fail(f"train: {run.step} steps, expected {TRAIN_STEPS}")
    if launches["edge_mpnn_runs"] != 5 * ROUNDS * forwards or any(
            launches[k] for k in ("edge_mpnn", "segment_pool",
                                  "segment_pool_runs")):
        fail(f"train: launches {launches} for {forwards} forwards "
             f"({5 * ROUNDS} edge_mpnn_runs per forward expected, no other "
             "kernel)")
    # the kernel path folds every sum in a fixed order on the sorted
    # batches, so a second kernel run from the same draw and stream must
    # repeat every loss and parameter bit for bit
    again = fit(torch, "sum", train, None, TRAIN_STEPS)
    if again.metrics["train_losses"] != run.metrics["train_losses"]:
        fail(f"train: two kernel runs from the same draw and stream differ: "
             f"{run.metrics['train_losses']} vs "
             f"{again.metrics['train_losses']}")
    for name, p in run.metrics["params"].items():
        if not torch.equal(p, again.metrics["params"][name]):
            fail(f"train: two kernel runs end with different {name}")
    # kernel vs plain: independent runs part once a ReLU input within
    # rounding of 0 flips sign on one path (the plain path's index_add_
    # sums in another order, and in none fixed): its gradient jumps, and
    # Adam scales the jump to a full lr-sized step.  So those trajectories
    # are held together over the first PARITY_STEPS steps (warmup keeps
    # lr small there), each step is held on shared parameters in
    # step_loop, and the plain path's own run-to-run spread is measured
    # beside them.
    plain = fit(torch, "sum", train, None, TRAIN_STEPS, plain=True)
    plain2 = fit(torch, "sum", train, None, TRAIN_STEPS, plain=True)
    losses = np.asarray(run.metrics["train_losses"])
    plain_losses = np.asarray(plain.metrics["train_losses"])
    gaps = np.abs(losses - plain_losses)
    spread = float(np.abs(plain_losses - np.asarray(
        plain2.metrics["train_losses"])).max())
    head_gap = float(gaps[:PARITY_STEPS].max())
    if not np.isfinite(losses).all() or head_gap > LOSS_ATOL:
        fail(f"train: the first {PARITY_STEPS} per-step losses differ from "
             f"the plain run by {head_gap:.3e} (atol {LOSS_ATOL}): "
             f"{losses.tolist()} vs {plain_losses.tolist()}")
    acc, eval_loss = run.metrics["eval"]["accuracy"], run.metrics["eval"][
        "loss"]
    plain_eval = eval_plain(torch, run.metrics["params"], evaluation)
    if not np.isfinite(eval_loss) or abs(eval_loss - plain_eval["loss"]) \
            > STEP_LOSS_ATOL:
        fail(f"train: eval {run.metrics['eval']} vs the plain versions on "
             f"the same parameters {plain_eval}")
    step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
    wait_ms = 1e3 * statistics.median(run.metrics["batch_wait_seconds"][1:])
    phase("train", f"{card}: {TRAIN_STEPS} steps x {TRAIN_BATCH} roots + "
          f"eval {eval_steps} x {TRAIN_BATCH}; step-1 gradients of "
          f"{n_params} parameters ({reached} reached by the loss on both "
          f"paths) all finite, max rel err vs plain "
          f"{worst:.2e} (rtol {GRAD_RTOL}); step-1 loss {loss_k:.6f} (CPU "
          f"{loss_cpu:.6f}); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; a second kernel run bit-identical over all "
          f"{TRAIN_STEPS} steps (losses and parameters); independent "
          f"runs, max |kernel - plain| over "
          f"the first {PARITY_STEPS} steps {head_gap:.2e} (atol "
          f"{LOSS_ATOL}), over all {TRAIN_STEPS} {gaps.max():.2e} (plain "
          f"vs plain {spread:.2e}); eval accuracy {acc:.4f} loss "
          f"{eval_loss:.4f} (plain on the same parameters "
          f"{plain_eval['accuracy']:.4f} / {plain_eval['loss']:.4f}); "
          f"launches {launches} = "
          f"{launches['edge_mpnn_runs'] // forwards}/forward; Trainer step "
          f"{step_ms:.2f} ms median = {1e3 * TRAIN_BATCH / step_ms:.1f} "
          f"roots/s, of it waiting for the batch {wait_ms:.2f} ms median "
          f"(sampling and the copy, on the loop's thread)")
    profile, step_gap = step_loop(torch, train)
    if step_gap > STEP_LOSS_ATOL:
        fail(f"train: on the same parameters, a step's kernel loss differs "
             f"from the plain one by {step_gap:.3e} (atol {STEP_LOSS_ATOL})")
    phase("train-profile", f"{profile}; same-parameter loss gap kernel vs "
          f"plain over {TRAIN_STEPS} steps {step_gap:.2e} (atol "
          f"{STEP_LOSS_ATOL})")
    return {"launches": launches["edge_mpnn_runs"],
            "losses": run.metrics["train_losses"], "step_ms": step_ms,
            "wait_ms": wait_ms}


def train_mean_phase(torch, raw, spec, setup) -> int:
    """A few steps of the mean-pooling model (the generic conv path,
    pooled by segment_pool_runs on target-sorted ids), its step-1
    gradients held to the plain path.  Returns segment_pool_runs'
    launches."""
    train_roots, _, sizes = setup
    train = provider(raw, spec, train_roots, sizes)
    first = next(iter(train.epoch(0)))
    worst, n_params, reached, _, _ = grad_check(torch, "mean", first,
                                                root_task().labels(first))
    zero_launches()
    run = fit(torch, "mean", train, None, MEAN_STEPS)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["segment_pool_runs"] != 5 * ROUNDS * run.step or any(
            launches[k] for k in ("edge_mpnn", "edge_mpnn_runs",
                                  "segment_pool")):
        fail(f"train-mean: launches {launches} for {run.step} steps "
             f"({5 * ROUNDS} segment_pool_runs per forward expected)")
    losses = run.metrics["train_losses"]
    if not np.isfinite(losses).all():
        fail(f"train-mean: losses {losses}")
    step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
    phase("train-mean", f"{run.step} steps of the mean model: step-1 "
          f"gradients of {n_params} parameters ({reached} reached) max rel "
          f"err vs plain "
          f"{worst:.2e}; losses {[round(x, 4) for x in losses]}; launches "
          f"{launches} = {launches['segment_pool_runs'] // run.step}/forward; "
          f"Trainer step {step_ms:.2f} ms median")
    return launches["segment_pool_runs"]


# ---------------------------------------------------------------------------
# flash_attention against its plain version at three shapes
# ---------------------------------------------------------------------------

def flash_shapes(torch, batch) -> dict:
    """{label: (q, k, v, segments or None, causal)} in fp32, unit-scale
    normal inputs from a seeded generator:
    (a) GraphSelfAttention at the §8 width: the paper node set of the
        first training batch as one sequence, its component ids as
        segments (16 roots + the padding id), 4 heads x 32;
    (b) the reference envelope's corner (kernels/dispatch.py:242-243):
        4096 rows, 8 heads x 128, 16 components of 240 rows + 256 padding
        rows on id 16;
    (c) the causal GQA prefill of PREFILL (no segments)."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)

    def qkv(b, s, h, kh, d):
        return tuple(torch.randn(b, s, n, d, generator=g, device=DEVICE)
                     for n in (h, kh, kh))

    paper = batch.node_sets["paper"]
    seg_a = paper.component_ids().to(torch.int32)[None]
    seg_b = torch.clamp(torch.arange(4096, device=DEVICE) // 240,
                        max=16).to(torch.int32)[None]
    pre = PREFILL
    return {
        "a": (*qkv(1, paper.capacity, ATTN_HEADS, ATTN_HEADS, ATTN_PER_HEAD),
              seg_a, False),
        "b": (*qkv(1, 4096, 8, 8, 128), seg_b, False),
        "c": (*qkv(pre["b"], pre["s"], pre["h"], pre["kh"], pre["d"]), None,
              True),
    }


def flash_bounds(torch, q, k, seg) -> tuple:
    """(allowed pairs per head, {kind: (bound_ms, bound_by)}): 4 D flops
    per (query, key) pair the mask allows, per head (sum of n_c^2 over the
    segments of the one batch row, or S (S + 1) / 2 per batch row for the
    causal shape), against q, k, v and out read or written once plus the
    segment ids; at fp32 on the CUDA cores ("fp32"), 3xTF32 on the
    tensor cores (a third of the TF32 rate, fp32 bytes; "tf32x3") and
    bf16 on the tensor cores (2-byte elements; "bf16")."""
    b, s, h, d = q.shape
    if seg is not None:
        pairs = int((torch.bincount(seg.flatten().long()) ** 2).sum())
    else:
        pairs = b * s * (s + 1) // 2

    def bound(itemsize, flops_per_s):
        nbytes = itemsize * (2 * q.numel() + 2 * k.numel())
        if seg is not None:
            nbytes += 2 * seg.numel() * 4
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 4 * d * h * pairs / flops_per_s
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    return pairs, {"fp32": bound(4, PEAK_FP32_FLOPS),
                   "tf32x3": bound(4, PEAK_TF32_FLOPS / 3),
                   "bf16": bound(2, PEAK_BF16_FLOPS)}


def flash_tiles(q, k, seg, causal, rows) -> dict:
    """The kv tiles the kernel visits at these inputs for q tiles of
    `rows` row groups, by its skip rule as `kernel.tile_plan` mirrors it:
    visited and total over the q tiles of every batch row, and the
    (query, key) pairs the visited tiles compute, per head."""
    from repro_torch.kernels.flash_attention.kernel import (BLOCK_K,
                                                            WARP_ROWS,
                                                            tile_plan)
    b, sq = q.shape[:2]
    skv = k.shape[1]
    ids = None if seg is None else seg.cpu().tolist()
    visited = total = 0
    for bi in range(b):
        row_ids = None if ids is None else ids[bi]
        plan = tile_plan(row_ids, row_ids, sq, skv, causal,
                         WARP_ROWS * rows)
        visited += sum(len(tiles) for tiles in plan)
        total += len(plan) * -(-skv // BLOCK_K)
    return dict(visited=visited, total=total,
                pairs=visited * WARP_ROWS * rows * BLOCK_K)


def sdpa_call(torch, q, k, v, seg, causal):
    """One torch.nn.functional.scaled_dot_product_attention call on the
    same inputs ([B, H, S, D] layout, a boolean segment mask), timed as a
    yardstick only: the port never calls it."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if seg is not None:
        mask = seg[0][:, None] == seg[0][None, :]
        return lambda: sdpa(qt, kt, vt, attn_mask=mask)
    return lambda: sdpa(qt, kt, vt, is_causal=causal,
                        enable_gqa=k.shape[2] != q.shape[2])


def flash_kernels_phase(torch, batch, records, build_report):
    """flash_attention at flash_shapes' three shapes: fp32 (rtol/atol
    1e-5) and bf16 (2e-2) against attention_ref, repeats bit-identical,
    (b)'s unmatched queries exact zeros; then per shape the fp32 and bf16
    times, the plain version's and SDPA's (a yardstick only), device us
    and device kernels per call (at most 2, else FAIL), and the bounds:
    3xTF32 (the product the kernel runs for fp32, the record's
    `bound_ms`), fp32 on the CUDA cores, and bf16.  The text lines add
    the CTA the C entry chose and, from `kernel.tile_plan`, the kv tiles
    and pairs its skip rule visits."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                            last_cta)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    lines, shapes = [], {}
    for label, (q, k, v, seg, causal) in flash_shapes(torch, batch).items():
        errs, ctas = {}, {}
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            args = [x.to(dtype) for x in (q, k, v)]
            got = flash_attention(*args, seg, causal=causal)
            ctas[dtype] = last_cta()
            want = attention_ref(*args, seg, causal=causal)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != q.shape:
                fail(f"flash_attention ({label}): got {got.dtype} "
                     f"{tuple(got.shape)}")
            errs[dtype] = _close(torch, f"flash_attention[({label}), "
                                 f"{dtype}]", got, want, tol, tol)
            for _ in range(2):
                if not torch.equal(flash_attention(*args, seg,
                                                   causal=causal), got):
                    fail(f"flash_attention ({label}, {dtype}): repeat "
                         "launches are not bit-identical")
        if label == "b":
            # queries whose id no key has: the padding rows moved to 17
            pad = seg == 16
            q_seg = torch.where(pad, 17, seg).to(torch.int32)
            got = flash_attention(q, k, v, q_seg, seg, causal=False)
            if got[pad].abs().max().item() != 0:
                fail("flash_attention (b): queries no key may reach must "
                     "emit exact zeros")
            _close(torch, "flash_attention[(b), unmatched queries]", got,
                   attention_ref(q, k, v, q_seg, seg, causal=False),
                   1e-5, 1e-5)
        bf = [x.to(torch.bfloat16) for x in (q, k, v)]
        library = sdpa_call(torch, q, k, v, seg, causal)
        lib_err = (library().transpose(1, 2) - attention_ref(
            q, k, v, seg, causal=causal)).abs().max().item()
        ms = time_ms(torch, lambda: flash_attention(q, k, v, seg,
                                                    causal=causal))
        bf16_ms = time_ms(torch, lambda: flash_attention(*bf, seg,
                                                         causal=causal))
        plain_ms = time_ms(torch, lambda: attention_ref(q, k, v, seg,
                                                        causal=causal))
        library_ms = time_ms(torch, library)
        dev = {name: device_per_call(torch, lambda x=x: flash_attention(
            *x, seg, causal=causal)) for name, x in (("fp32", (q, k, v)),
                                                     ("bf16", bf))}
        for name, d in dev.items():
            if not 1 <= d["kernels"] <= 2:
                fail(f"flash_attention ({label}, {name}): a call ran "
                     f"{d['kernels']} device kernels ({d['names']}, "
                     f"{d['missed']} profiler events missed); 1 expected, "
                     "at most 2")
        pairs, bounds = flash_bounds(torch, q, k, seg)
        (bound_ms, bound_by), cc32, tc16 = (bounds["tf32x3"],
                                            bounds["fp32"], bounds["bf16"])
        cta = ctas[torch.float32]  # bf16 may take fewer kv splits
        tiles = flash_tiles(q, k, seg, causal, cta[0])
        b, s, h, d = q.shape
        shapes[label] = dict(
            ms=ms, bf16_ms=bf16_ms, plain_ms=plain_ms, library_ms=library_ms,
            fp32_err=errs[torch.float32], bf16_err=errs[torch.bfloat16],
            device_us=dev["fp32"]["device_us"],
            device_kernels=dev["fp32"]["kernels"],
            bf16_device_us=dev["bf16"]["device_us"],
            bf16_device_kernels=dev["bf16"]["kernels"],
            bound_ms=bound_ms, bound_by=bound_by,
            cuda_core_bound_ms=cc32[0], cuda_core_bound_by=cc32[1],
            bf16_bound_ms=tc16[0], bf16_bound_by=tc16[1])
        lines.append(
            f"({label}) B {b} S {s} H {h} K {k.shape[2]} D {d}"
            f"{' causal' if causal else ''}"
            f"{f' {seg.unique().numel()} segments' if seg is not None else ''}"
            f": CTAs of {cta[0]} x {cta[1]} warps, bf16 "
            f"{ctas[torch.bfloat16][0]} x {ctas[torch.bfloat16][1]} (row "
            f"groups x kv splits, as the C entry chose); by kernel.tile_plan "
            f"they visit "
            f"{tiles['visited']}/{tiles['total']} kv tiles, pairs per head "
            f"computed {tiles['pairs']} / allowed {pairs}; max err fp32 "
            f"{errs[torch.float32]:.2e} bf16 {errs[torch.bfloat16]:.2e}; "
            f"fp32 {ms:.4f} ms (device {dev['fp32']['device_us']:.2f} us, "
            f"{dev['fp32']['kernels']:g} kernel) bf16 {bf16_ms:.4f} ms "
            f"(device {dev['bf16']['device_us']:.2f} us, "
            f"{dev['bf16']['kernels']:g} kernel) vs plain {plain_ms:.4f} ms "
            f"vs SDPA fp32 {library_ms:.4f} ms (max err {lib_err:.2e}); "
            f"bounds 3xTF32 {bound_ms:.4f} ms ({bound_by}), fp32 CUDA cores "
            f"{cc32[0]:.4f} ms ({cc32[1]}), bf16 {tc16[0]:.4f} ms "
            f"({tc16[1]})")
    ptxas = ptxas_summary(ptxas_entries(build_report["flash_attention"]
                                        ["log"]), "flash_kernel")
    a = shapes["a"]  # the shape of the [attention] path
    records["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:79",
        max_abs_err=a["fp32_err"], ms=a["ms"], plain_ms=a["plain_ms"],
        bound_ms=a["bound_ms"], bound_by=a["bound_by"],
        library_ms=a["library_ms"], ptxas=ptxas, shapes=shapes)
    for line in lines:
        phase("kernels", f"flash_attention fp32/bf16 match the plain "
              f"version, repeats bit-identical: {line}")
    regs = ("-".join(map(str, ptxas["registers"])) if ptxas["registers"]
            else "not reported")
    phase("kernels", f"flash_attention build: {ptxas['instantiations']} "
          f"instantiations, {regs} registers, at most "
          f"{ptxas['spill_stores']}/{ptxas['spill_loads']} B spill "
          "stores/loads")


# ---------------------------------------------------------------------------
# the autotuner: kernels/autotune.py's records and the registry's consult
# ---------------------------------------------------------------------------

def autotune_jobs(torch, batch) -> list:
    """The keys `[autotune]` tunes, as (family, shape) pairs: segment_pool
    at the reference bench's shape (n 1000, E 8000, D 64; sum and max
    sorted, sum unsorted: `benchmarks/run.py:489-499`), at the trained
    pool shape and at its D 64 model=2 chunk; edge_mpnn, relu, at the
    served has_topic conv (unsorted, fp32 and bf16) and the trained one
    (sorted, fp32)."""
    s, t = served_inputs(torch), trained_inputs(torch, batch)
    pool = [dict(n=1000, d=64, e=8000, reduce="sum", sorted=True),
            dict(n=1000, d=64, e=8000, reduce="max", sorted=True),
            dict(n=1000, d=64, e=8000, reduce="sum", sorted=False),
            dict(n=t.n_tgt, d=t.d, e=t.e, reduce="sum", sorted=True),
            dict(n=t.n_tgt, d=t.d // 2, e=t.e, reduce="sum", sorted=True)]
    served = dict(n_src=s.n_src, n_tgt=s.n_tgt, ds=s.d, dt=s.d, m=s.d,
                  e=s.e, sorted=False)
    edge = [dict(served, dtype="float32"), dict(served, dtype="bfloat16"),
            dict(n_src=t.n_src, n_tgt=t.n_tgt, ds=t.d, dt=t.d, m=t.d,
                 e=t.e, sorted=True, dtype="float32")]
    return ([("segment_pool", job) for job in pool]
            + [("edge_mpnn", job) for job in edge])


def autotune_label(family, job) -> str:
    layout = "sorted" if job["sorted"] else "unsorted"
    if family == "segment_pool":
        return (f"segment_pool n {job['n']} D {job['d']} E {job['e']} "
                f"{job['reduce']} {layout}")
    return (f"edge_mpnn {job['n_src']} -> {job['n_tgt']} E {job['e']} "
            f"{job['dtype']} relu {layout}")


def autotune_check(torch, family, job, rec) -> str:
    """The registry under the consult at `job`'s shape, on seeded inputs
    (uniform ids, sorted for a sorted key): the decision reads the
    record, the output agrees with the plain version by `[kernels]`'
    rules (pool sums by `_close_sum`, max exactly; fp32 edges within
    FP64_ERR_MULTIPLE of the plain version's error against fp64, bf16
    2e-2), and on a sorted key REPEATS calls are bit-identical.  Returns
    the decision's reason."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.edge_mpnn.ref import edge_mpnn_ref
    from repro_torch.kernels.segment_pool.ref import segment_pool_ref
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 7)
    layout = "sorted" if job["sorted"] else "unsorted"
    want_reason = f"autotuned:{rec['variant']}/{rec['tile']}[{layout}]"
    label = autotune_label(family, job)

    def ids(n, e):
        x = rng.integers(0, n, e).astype(np.int32)
        return torch.from_numpy(np.sort(x) if job["sorted"] else x).to(dev)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    if family == "segment_pool":
        n, reduce = job["n"], job["reduce"]
        vals, seg = normal(job["e"], job["d"]), ids(n, job["e"])
        dec = registry.segment_reduce_decision(
            vals, job["sorted"], n_segments=n, reduce=reduce)

        def call():
            return registry.segment_reduce(vals, seg, n, reduce,
                                           sorted_ids=job["sorted"])

        got, want = call(), segment_pool_ref(vals, seg, n_segments=n,
                                             reduce=reduce)
        if reduce == "sum":
            counts = torch.zeros(n + 1, dtype=torch.int64, device=dev
                                 ).index_add_(0, seg.long(),
                                              torch.ones_like(seg.long()))[:n]
            _close_sum(torch, f"[autotune] {label}", got, want,
                       segment_pool_ref(vals.abs(), seg, n_segments=n),
                       counts, 0.0)
        elif not torch.equal(got, want):
            fail(f"[autotune] {label}: {reduce} differs from the plain "
                 "version")
    else:
        dtype = getattr(torch, job["dtype"])
        n_src, n_tgt, d = job["n_src"], job["n_tgt"], job["m"]
        src = torch.from_numpy(rng.integers(0, n_src, job["e"]).astype(
            np.int32)).to(dev)
        tgt = ids(n_tgt, job["e"])
        h_src, h_tgt = normal(n_src, job["ds"]), normal(n_tgt, job["dt"])
        w = normal(job["ds"] + job["dt"], d,
                   scale=(job["ds"] + job["dt"]) ** -0.5)
        b = normal(d, scale=0.1)
        args = [x.to(dtype) for x in (h_src, h_tgt, w, b)]
        dec = registry.edge_mpnn_decision(
            args[0], "relu", job["sorted"], h_tgt=args[1], w=args[2],
            n_edges=job["e"])

        def call():
            return registry.edge_mpnn(
                args[0], args[1], src, tgt, args[2], args[3], n_src=n_src,
                n_tgt=n_tgt, sorted_ids=job["sorted"])

        got = call()
        want = edge_mpnn_ref(args[0], args[1], src, tgt, args[2], args[3],
                             n_src=n_src, n_tgt=n_tgt)
        if dtype == torch.float32:
            fp64_check(torch, f"[autotune] {label} vs fp64", got, want,
                       edge_fp64(torch, h_src, h_tgt, src, tgt, w, b, n_tgt,
                                 "relu"))
        else:
            _close(torch, f"[autotune] {label}", got, want, 2e-2, 2e-2)
    if dec.reason != want_reason:
        fail(f"[autotune] {label}: decision {dec.reason!r} under the "
             f"consult ({want_reason!r} expected)")
    if job["sorted"]:
        repeat_check(torch, f"[autotune] {label}", call)
    return dec.reason


def autotune_reasons(torch, jobs) -> list:
    """Each job's decision reason on the card, from its shape alone."""
    from repro_torch.kernels import registry
    dev = torch.device(DEVICE)
    reasons = []
    for family, job in jobs:
        if family == "segment_pool":
            reasons.append(registry.segment_reduce_decision(
                torch.empty(job["e"], job["d"], device=dev), job["sorted"],
                n_segments=job["n"], reduce=job["reduce"]).reason)
        else:
            dtype = getattr(torch, job["dtype"])
            reasons.append(registry.edge_mpnn_decision(
                torch.empty(job["n_src"], job["ds"], dtype=dtype,
                            device=dev), "relu", job["sorted"],
                h_tgt=torch.empty(job["n_tgt"], job["dt"], dtype=dtype,
                                  device=dev),
                w=torch.empty(job["ds"] + job["dt"], job["m"], dtype=dtype,
                              device=dev), n_edges=job["e"]).reason)
    return reasons


def autotuned_convs(torch, model, graph, sorted_ids: bool) -> tuple:
    """(convs on an autotuned decision, convs) of one forward of `model`
    on `graph` (`describe_dispatch`)."""
    from repro_torch.kernels import registry
    with registry.layout(sorted_by_target=sorted_ids), \
            torch.inference_mode():
        rounds = model.gnn.describe_dispatch(model.init(graph))
    decs = [dec for per_set in rounds for convs in per_set.values()
            for dec in convs.values()]
    return (sum(dec is not None and dec.reason.startswith("autotuned:")
                for dec in decs), len(decs))


def edge_calls(run, shape) -> list:
    """The edge kernel calls `run()` makes at `shape` (n_src, n_tgt, E),
    each as the keyword arguments of a wrapper call on cloned inputs."""
    from repro_torch.kernels.edge_mpnn import kernel as mpnn
    calls, real = [], mpnn._run

    def spy(library, h_src, h_tgt, src, tgt, w, b, n_src, n_tgt, act, tile):
        if (n_src, n_tgt, src.shape[0]) == shape:
            calls.append(dict(
                h_src=h_src.clone(), h_tgt=h_tgt.clone(), src=src.clone(),
                tgt=tgt.clone(), w=w.clone(), b=b.clone(), n_src=n_src,
                n_tgt=n_tgt, activation=act))
        return real(library, h_src, h_tgt, src, tgt, w, b, n_src, n_tgt, act,
                    tile)

    mpnn._run = spy
    try:
        run()
    finally:
        mpnn._run = real
    return calls


def path_us(calls, choices) -> dict:
    """{"kernel/tile": device µs summed over `calls`} for each (kernel,
    tile) in `choices`, timed as the tuner times (`autotune._time_us`)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.edge_mpnn import kernel as mpnn
    return {f"{name}/{tile}": sum(
        autotune._time_us(functools.partial(getattr(mpnn, name), tile=tile,
                                            **c), 10) for c in calls)
        for name, tile in choices}


def autotune_server(torch, store, spec, model, roots) -> dict:
    """A GNNServer warmed from CUDA graphs under the registry's current
    consult, serving each root list of `roots` once: logits within 1e-4
    of the plain forward, 0 captures after warmup; autotuned convs by
    rung, one replay's device µs by rung (torch.profiler), the wrappers'
    launches (warmup included) and the has_topic calls of an eager
    rung-8 forward over `roots[0]`."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    zero_launches()
    server, _, warm_s = graph_server(torch, store, spec, model)
    try:
        max_err = max(check_logits(
            "[autotune] serve", server.serve_sync(r, timeout=120),
            plain_logits(torch, server, store, spec, r), len(r))
            for r in roots)
        if server.stats.steady_state_recompiles != 0:
            fail(f"[autotune] {server.stats.steady_state_recompiles} "
                 "captures after warmup")
        launches = read_launches()
        tuned = {rung: autotuned_convs(torch, model, to_device(
            merge_and_pad([server._subgraphs.get(0)],
                          server.ladder.sizes[rung]), server.device), False)
            for rung in server.ladder.rungs}
        replay_us = {rung: round(rec["device_us"], 1)
                     for rung, rec in replay_kernels(torch, server).items()}
        graphs = [sample_subgraph(store, spec, r, seed_rng(0, r))
                  for r in roots[0]]
        merged = merge_and_pad(graphs, server.ladder.sizes[len(roots[0])])
        s = served_inputs(torch)
        calls = edge_calls(lambda: server.run_eager(merged),
                           (s.n_src, s.n_tgt, s.e))
    finally:
        server.close()
    return dict(max_err=max_err, warm_s=warm_s, launches=launches,
                tuned=tuned, replay_us=replay_us, calls=calls)


def autotune_phase(torch, store, spec, batch, records, smi) -> dict:
    """`[autotune]`: tune every `autotune_jobs` key into a temporary file
    (never the default path or a file of the checkout) and print each
    candidate's device µs, the winner, the shipped rule's time and their
    ratio; then, with the consult on over that file, hold each key's
    decision, output and (sorted) repeats by `autotune_check`, serve the
    §8 model from CUDA graphs (0 captures after warmup, logits within
    1e-4 of plain) and run one training forward (exactly 20 run-kernel
    launches).  With the consult off, every reason must be the one it
    was.  The tuned and shipped choices are also timed on the served and
    trained paths' own has_topic calls (their ids, padding included: the
    tuner's are uniform), and a rung's replay with the consult on beside
    one with it off.  Returns the launches of the served and trained
    paths under the consult."""
    import shutil
    import tempfile
    from repro_torch.kernels import autotune, registry
    t0 = time.perf_counter()
    jobs = autotune_jobs(torch, batch)
    before = autotune_reasons(torch, jobs)
    want = [f"kernel:{family}_runs[sorted]" if job["sorted"]
            else f"kernel:{family}[unsorted]" for family, job in jobs]
    if before != want:
        fail(f"[autotune] reasons with the consult off: {before} ({want} "
             "expected)")
    rng = np.random.default_rng(SEED + 8)
    used = {0}
    roots = [fresh_roots(rng, used, n, store.num_nodes["paper"])
             for n in (8, 3, 1)]
    model = build_model(torch, "sum")
    default_path = autotune.DEFAULT_CACHE_PATH
    tmp = tempfile.mkdtemp(prefix="repro_autotune_")
    autotune.DEFAULT_CACHE_PATH = os.path.join(tmp, "autotune_cache_cuda.json")
    try:
        recs = []
        for family, job in jobs:
            if family == "segment_pool":
                rec = autotune.tune_segment_pool(
                    job["n"], job["d"], reduce=job["reduce"],
                    sorted_ids=job["sorted"], n_edges=job["e"])
            else:
                rec = autotune.tune_edge_mpnn(
                    job["n_src"], job["n_tgt"], job["ds"], job["dt"],
                    job["m"], dtype=job["dtype"], sorted_ids=job["sorted"],
                    n_edges=job["e"])
            recs.append(rec)
            phase("autotune", f"{autotune_label(family, job)}: "
                  + ", ".join(f"{k} {us:.2f}"
                              for k, us in rec["candidates"].items())
                  + f" us; winner {rec['variant']}/{rec['tile']} "
                  f"{rec['us']:.2f} us, shipped rule {rec['default_us']:.2f}"
                  f" us, ratio {rec['default_us'] / rec['us']:.3f} ({smi})")
        registry.use_autotune(True)
        try:
            reasons = [autotune_check(torch, family, job, rec)
                       for (family, job), rec in zip(jobs, recs)]
            on = autotune_server(torch, store, spec, model, roots)
            train_model = fresh_model(torch, "sum")
            zero_launches()
            t = trained_inputs(torch, batch)

            def train_forward():
                with registry.layout(sorted_by_target=True), \
                        torch.no_grad():
                    train_model(batch)

            trained_calls = edge_calls(train_forward, (t.n_src, t.n_tgt, t.e))
            trained = read_launches()
            tuned_trained = autotuned_convs(torch, train_model, batch, True)
        finally:
            registry.use_autotune(False)
        if trained["edge_mpnn_runs"] != 5 * ROUNDS or any(
                v for k, v in trained.items() if k != "edge_mpnn_runs"):
            fail(f"[autotune] a training forward launched {trained} "
                 f"({5 * ROUNDS} edge_mpnn_runs expected)")
    finally:
        autotune.clear(autotune.DEFAULT_CACHE_PATH)
        autotune.DEFAULT_CACHE_PATH = default_path
        shutil.rmtree(tmp, ignore_errors=True)
    after = autotune_reasons(torch, jobs)
    if after != want:
        fail(f"[autotune] reasons after the consult was turned off: {after}")
    off = autotune_server(torch, store, spec, model, roots)
    if on["tuned"][MAX_BATCH][0] == 0 or any(
            n for n, _ in off["tuned"].values()):
        fail(f"[autotune] autotuned convs by rung: consult on {on['tuned']},"
             f" off {off['tuned']} (some at rung {MAX_BATCH} on, none off "
             "expected)")
    served_rec, _, trained_rec = recs[-3:]  # the edge jobs, in order
    served_path = path_us(on["calls"], [
        ("edge_mpnn", 32), (served_rec["variant"], served_rec["tile"])])
    trained_path = path_us(trained_calls, [
        ("edge_mpnn_runs", 32), (trained_rec["variant"], trained_rec["tile"])])
    phase("autotune", f"consult on: {len(reasons)} decisions autotuned, "
          f"outputs within [kernels]' rules, sorted keys {REPEATS} calls "
          f"bit-identical; GNNServer from CUDA graphs (warmup "
          f"{on['warm_s']:.1f}s, launches {on['launches']}): 0 captures "
          f"after warmup, logits vs plain max err {on['max_err']:.2e}, "
          f"autotuned convs / convs by rung {on['tuned']}; a training "
          f"forward {trained} (autotuned convs {tuned_trained[0]} of "
          f"{tuned_trained[1]}); consult off: every reason as before, no "
          f"conv autotuned; {time.perf_counter() - t0:.1f}s")
    phase("autotune", f"on the paths' own has_topic calls (device us "
          f"summed over a forward's {len(on['calls'])} / "
          f"{len(trained_calls)} launches): served rung {MAX_BATCH} "
          + ", ".join(f"{k} {v:.2f}" for k, v in served_path.items())
          + "; trained " + ", ".join(f"{k} {v:.2f}"
                                     for k, v in trained_path.items())
          + f"; one replay's device us by rung, consult on "
          f"{on['replay_us']} vs off {off['replay_us']} ({smi})")
    for name in ("segment_pool", "edge_mpnn"):
        records[name]["autotune"] = [
            dict(key=autotune_label(family, job), **{
                k: rec[k] for k in ("variant", "tile", "us", "default_us")})
            for (family, job), rec in zip(jobs, recs) if family == name]
    records["edge_mpnn"]["autotune_path_us"] = dict(served=served_path,
                                                    trained=trained_path)
    return {"served": on["launches"], "trained": trained}


# ---------------------------------------------------------------------------
# graph attention: GraphSelfAttention on the flash kernel
# ---------------------------------------------------------------------------

def attention_phase(torch, states, card) -> int:
    """`gat_flash_parity.run` on the card at the example's size (its
    tolerances) and over the paper states of the first training batch at
    full width (gradients by the [train] rule), one flash launch per
    forward and none in the backward; then forward and forward+backward
    times on each path.  Returns the flash launches of the two runs."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.nn.graph_attention import GraphSelfAttention
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration import gat_flash_parity

    zero_launches()
    small = gat_flash_parity.run(device=DEVICE)
    full = gat_flash_parity.run(
        device=DEVICE, graph=states, node_set="paper", in_dim=DIM,
        num_heads=ATTN_HEADS, per_head_channels=ATTN_PER_HEAD, seed=SEED)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["flash_attention"] != 2 or any(
            n for k, n in launches.items() if k != "flash_attention"):
        fail(f"attention: launches {launches} for two forwards (1 "
             "flash_attention each expected, no other kernel)")
    for name, run in (("example", small), ("full width", full)):
        if (run.forward_launches, run.backward_launches) != (1, 0):
            fail(f"attention ({name}): {run.forward_launches} flash "
                 f"launches in the forward, {run.backward_launches} in the "
                 "backward (1 and 0 expected)")
    try:
        small.check()
    except AssertionError as err:
        fail(f"attention (example): kernel path vs plain path: {err}")
    if abs(full.loss - full.plain_loss) > 1e-5 * abs(full.plain_loss) + 1e-6:
        fail(f"attention (full width): loss {full.loss} vs plain "
             f"{full.plain_loss}")
    worst = 0.0
    for name, g in full.grads.items():
        want = full.plain_grads[name]
        scale = want.abs().max().item()
        err = (g - want).abs().max().item()
        if not bool(torch.isfinite(g).all()) or \
                err > GRAD_RTOL * scale + 1e-7:
            fail(f"attention (full width): {name} gradient differs from the "
                 f"plain one by {err:.3e} (largest plain entry {scale:.3e})")
        worst = max(worst, err / scale if scale > 0 else 0.0)

    module = init_params(GraphSelfAttention(ATTN_HEADS, ATTN_PER_HEAD, DIM),
                         SEED).to(DEVICE)
    params = list(module.parameters())

    def forward():
        with torch.no_grad():
            module(states, "paper")

    def forward_backward():
        torch.autograd.grad(module(states, "paper").square().mean(), params)

    times = {}
    for path in ("kernel", "plain"):
        with (registry.plain_versions() if path == "plain"
              else contextlib.nullcontext()):
            times[path] = (time_ms(torch, forward),
                           time_ms(torch, forward_backward))
    paper = states.node_sets["paper"]
    phase("attention", f"{card}: gat_flash_parity at the example's size "
          f"(96 rows, 4 x 8): loss {small.loss:.6f} vs plain "
          f"{small.plain_loss:.6f}, gradients within rtol 1e-4 / atol 1e-5; "
          f"full width ({paper.capacity} paper rows, "
          f"{int(paper.component_ids().max()) + 1} segments, 4 x 32 over 128-wide "
          f"states): loss {full.loss:.6f} vs plain {full.plain_loss:.6f}, "
          f"gradients max rel err {worst:.2e} (rtol {GRAD_RTOL}); "
          f"launches {launches['flash_attention']} (1 per forward, 0 per "
          f"backward); full width forward {times['kernel'][0]:.4f} ms "
          f"kernel vs {times['plain'][0]:.4f} ms plain, forward+backward "
          f"{times['kernel'][1]:.4f} ms vs {times['plain'][1]:.4f} ms")
    return launches["flash_attention"]


# ---------------------------------------------------------------------------
# the model zoo on a training batch
# ---------------------------------------------------------------------------

def zoo_models(torch) -> dict:
    """{name: (model_fn, output width, segment_pool_runs per forward)} at
    the reference's defaults over the §8 init states.  Per forward: a
    mean or sum pool is one launch per conv, an attention conv three (the
    segment softmax's max and sum over [E, H] scores, then the [E, H, C]
    message sum); 5 convs a round over 2 rounds, gcn 1."""
    from repro_torch.core import models
    edges = mag_edges()
    dims = {n: DIM for n in ("author", "field_of_study", "institution",
                             "paper")}
    return {
        "rgcn": (lambda: (init_states(torch), models.rgcn(edges, dims)),
                 128, 10),
        "gcn": (lambda: (init_states(torch), models.gcn("cites", "paper",
                                                        DIM)), 64, 2),
        "graph_sage": (lambda: (init_states(torch),
                                models.graph_sage(edges, dims)), 128, 10),
        "gatv2": (lambda: (init_states(torch), models.gatv2(edges, dims)),
                  128, 30),
        "hgt_like": (lambda: (init_states(torch),
                              models.hgt_like(edges, dims)), 128, 30),
    }


def zoo_phase(torch, raw, spec, setup) -> int:
    """Each zoo model on the first 16-root training batch: its exact
    segment_pool_runs launches per forward (no other kernel) and its
    step-1 gradients against the plain path by the [train] rule; then
    gatv2 and hgt_like trained ZOO_STEPS steps through the Trainer on
    both paths, losses within LOSS_ATOL.  Returns segment_pool_runs'
    launches over the phase's kernel-path runs."""
    train_roots, _, sizes = setup
    train = provider(raw, spec, train_roots, sizes)
    first = next(iter(train.epoch(0)))
    labels = root_task().labels(first)
    parts, total = [], 0
    for name, (model_fn, hidden, per_forward) in zoo_models(torch).items():
        zero_launches()
        worst, n_params, reached, _, _ = grad_check(
            torch, name, first, labels, model_fn(), hidden)
        launches = read_launches()
        if launches["segment_pool_runs"] != per_forward or any(
                n for k, n in launches.items() if k != "segment_pool_runs"):
            fail(f"zoo {name}: launches {launches} for one forward "
                 f"({per_forward} segment_pool_runs expected)")
        total += launches["segment_pool_runs"]
        parts.append(f"{name} {per_forward} launches/forward, {n_params} "
                     f"parameters ({reached} reached), max rel err "
                     f"{worst:.2e}")
    trained = []
    for name in ("hgt_like", "gatv2"):
        model_fn, _, per_forward = zoo_models(torch)[name]
        zero_launches()
        run = fit(torch, name, train, None, ZOO_STEPS, model_fn=model_fn)
        torch.cuda.synchronize()
        launches = read_launches()
        plain = fit(torch, name, train, None, ZOO_STEPS, plain=True,
                    model_fn=model_fn)
        if launches["segment_pool_runs"] != per_forward * ZOO_STEPS:
            fail(f"zoo {name}: {launches} over {ZOO_STEPS} Trainer steps "
                 f"({per_forward} segment_pool_runs per forward expected)")
        total += launches["segment_pool_runs"]
        losses = np.asarray(run.metrics["train_losses"])
        plain_losses = np.asarray(plain.metrics["train_losses"])
        gap = float(np.abs(losses - plain_losses).max())
        if run.step != ZOO_STEPS or not np.isfinite(losses).all() \
                or gap > LOSS_ATOL:
            fail(f"zoo {name}: Trainer losses {losses.tolist()} vs plain "
                 f"{plain_losses.tolist()}")
        step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
        trained.append(f"{name} {ZOO_STEPS} steps, losses "
                       f"{[round(float(x), 4) for x in losses]}, max |kernel - "
                       f"plain| {gap:.2e}, step {step_ms:.2f} ms")
    phase("zoo", "; ".join(parts + trained)
          + f"; segment_pool_runs launches {total}")
    return total


# ---------------------------------------------------------------------------
# the example twins: quickstart, link prediction, graph classification
# ---------------------------------------------------------------------------

def quickstart_phase(torch) -> dict:
    """`repro_torch.orchestration.quickstart.run` on the card against the
    same run through the plain versions on the card: the paper's spending
    numbers and the round's user states within rtol/atol 1e-5, and the
    exact launches of its one run: 2 edge_mpnn (the two SimpleConvs, rows
    of 3 and 4 floats, 8 messages wide), 1 segment_pool (the purchases,
    unsorted), 1 segment_pool_runs (the context max).  Returns them."""
    from repro_torch.kernels import registry
    from repro_torch.orchestration import quickstart
    zero_launches()
    got = quickstart.run(device=DEVICE)
    torch.cuda.synchronize()
    launches = read_launches()
    want_launches = {"edge_mpnn": 2, "edge_mpnn_runs": 0, "segment_pool": 1,
                     "segment_pool_runs": 1, "flash_attention": 0}
    if launches != want_launches:
        fail(f"quickstart: launches {launches}, expected {want_launches}")
    with registry.plain_versions():
        want = quickstart.run(device=DEVICE)
    errs = []
    for name in ("total_spend", "max_spend_fraction", "user_states"):
        a, b = getattr(got, name), getattr(want, name)
        if a.shape != b.shape or not np.isfinite(a).all() \
                or not np.allclose(a, b, rtol=1e-5, atol=1e-5):
            fail(f"quickstart: {name} {a.tolist()} vs plain {b.tolist()}")
        errs.append(float(np.abs(a - b).max()))
    if not np.allclose(got.total_spend, [160.11, 50.33, 350.0, 45.13],
                       rtol=1e-6):
        fail(f"quickstart: total spend {got.total_spend.tolist()}")
    phase("quickstart", f"total spend "
          f"{[round(float(x), 2) for x in got.total_spend]}, fraction of "
          f"max {[round(float(x), 3) for x in got.max_spend_fraction]}, "
          f"user states {got.user_states.shape}; max |kernel - plain| "
          f"{max(errs):.2e} (rtol/atol 1e-5); launches {launches}")
    return launches


def twin_grad_check(torch, name, task, model_fn, hidden, provider_) -> str:
    """Step 1's gradients of a twin's model on its first batch, kernel
    path vs plain path, by the [train] rule; the phase-line text."""
    first = next(iter(provider_.epoch(0)))
    worst, n_params, reached, _, _ = grad_check(
        torch, name, first, task.labels(first, epoch=0, step=0), model_fn(),
        hidden, task)
    return (f"step-1 gradients of {n_params} parameters ({reached} "
            f"reached) max rel err vs plain {worst:.2e} (rtol {GRAD_RTOL})")


def linkpred_phase(torch) -> int:
    """`link_prediction.run` at the example's defaults on the card (480
    papers, hidden 32, 2 rounds, 4 negatives, 3 epochs of 16-root
    StoreProvider batches, eval at the end): exactly 6 edge_mpnn_runs a
    forward (3 convs x 2 rounds) and no other kernel; a second kernel
    run from the same draw and stream repeats every loss and parameter
    bit for bit; step-1 gradients by the [train] rule.  Returns
    edge_mpnn_runs' launches."""
    from repro_torch.orchestration import link_prediction as lp
    from repro_torch.orchestration.tasks import LinkPrediction
    data = lp.providers()
    train, val = data
    zero_launches()
    run = lp.run(device=DEVICE, data=data)
    torch.cuda.synchronize()
    launches = read_launches()
    forwards = run.step + val.num_steps
    per_forward = 3 * lp.ROUNDS
    if launches["edge_mpnn_runs"] != per_forward * forwards or any(
            n for k, n in launches.items() if k != "edge_mpnn_runs"):
        fail(f"linkpred: launches {launches} for {forwards} forwards "
             f"({per_forward} edge_mpnn_runs per forward expected)")
    again = lp.run(device=DEVICE, data=data)
    if again.metrics["train_losses"] != run.metrics["train_losses"] or any(
            not torch.equal(p, again.metrics["params"][k])
            for k, p in run.metrics["params"].items()):
        fail("linkpred: two kernel runs from the same draw and stream "
             "differ")
    losses = run.metrics["train_losses"]
    if run.step != lp.EPOCHS * train.num_steps \
            or not np.isfinite(losses).all():
        fail(f"linkpred: {run.step} steps, losses {losses}")
    task = LinkPrediction("writes", lp.HIDDEN, num_negatives=lp.NEGATIVES)
    grads = twin_grad_check(torch, "linkpred", task, lp.model_fn, lp.HIDDEN,
                            train)
    em = run.metrics["eval"]
    step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
    phase("linkpred", f"{run.step} steps ({lp.EPOCHS} epochs x "
          f"{train.num_steps}) of 16 roots + eval {val.num_steps}; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; eval accuracy "
          f"{em['accuracy']:.4f} loss {em['loss']:.4f}; a second kernel "
          f"run bit-identical over all {run.step} steps (losses and "
          f"parameters); {grads}; launches {launches} = "
          f"{launches['edge_mpnn_runs'] // forwards}/forward; Trainer step "
          f"{step_ms:.2f} ms median")
    return launches["edge_mpnn_runs"]


def gn_round_check(torch, first) -> str:
    """One full Graph Networks round (EdgeSetUpdate on bonds, then the
    atoms' NodeSetUpdate, a fused SimpleConv, then a mean ContextUpdate
    over the atoms) on the first graph-classification batch, from the
    twin's initial states drawn from SEED: kernel path vs plain path,
    forward within rtol 1e-4 / atol 1e-5 and the gradients of a fixed
    random projection by the [train] rule; exactly 1 edge_mpnn_runs and 1
    segment_pool_runs.  The phase-line text."""
    from repro_torch.core.convolutions import SimpleConv
    from repro_torch.core.graph_tensor import HIDDEN_STATE, to_device
    from repro_torch.core.graph_update import (ContextUpdate,
                                               EdgeSetUpdate, GraphUpdate,
                                               NextStateFromConcat,
                                               NodeSetUpdate)
    from repro_torch.kernels import registry
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration import graph_classification as gcls
    h = gcls.HIDDEN
    rnd = init_params(GraphUpdate(
        edge_sets={"bonds": EdgeSetUpdate(2 * h, h)},
        node_sets={"atoms": NodeSetUpdate({"bonds": SimpleConv(h, 2 * h)},
                                          NextStateFromConcat(2 * h, h))},
        context=ContextUpdate(["atoms"], h, h)), SEED).to(DEVICE)
    init = init_params(gcls.InitStates(h), SEED).to(DEVICE)
    with torch.no_grad():
        g = init(to_device(first, DEVICE))
    params = list(rnd.parameters())

    def outputs():
        out = rnd(g)
        return (out.edge_sets["bonds"][HIDDEN_STATE],
                out.node_sets["atoms"][HIDDEN_STATE],
                out.context[HIDDEN_STATE])

    gen = torch.Generator().manual_seed(SEED)
    with registry.layout(sorted_by_target=True):
        zero_launches()
        got = outputs()
        launches = read_launches()
        cots = [torch.randn(o.shape, generator=gen).to(DEVICE) for o in got]
        g_k = torch.autograd.grad(sum((o * c).sum() for o, c in
                                      zip(got, cots)), params)
        with registry.plain_versions():
            want = outputs()
            g_p = torch.autograd.grad(sum((o * c).sum() for o, c in
                                          zip(want, cots)), params)
    if launches["edge_mpnn_runs"] != 1 or launches["segment_pool_runs"] != 1:
        fail(f"graphcls: the GN round launched {launches} (1 edge_mpnn_runs "
             "and 1 segment_pool_runs expected)")
    err = max(_close(torch, f"graphcls GN round output {i}", a, b, 1e-4,
                     1e-5) for i, (a, b) in enumerate(zip(got, want)))
    worst = 0.0
    for (name, _), a, b in zip(rnd.named_parameters(), g_k, g_p):
        scale = b.abs().max().item()
        gap = (a - b).abs().max().item()
        if not bool(torch.isfinite(a).all()) \
                or gap > GRAD_RTOL * scale + 1e-7:
            fail(f"graphcls GN round: {name} gradient differs from the "
                 f"plain one by {gap:.3e} (largest {scale:.3e})")
        worst = max(worst, gap / scale if scale else 0.0)
    return (f"a full GN round (edges {tuple(got[0].shape)}, atoms "
            f"{tuple(got[1].shape)}, context {tuple(got[2].shape)}) max "
            f"|kernel - plain| {err:.2e}, gradients max rel err "
            f"{worst:.2e}")


def graphcls_phase(torch) -> tuple:
    """`graph_classification.run` at the example's defaults on the card
    (480 graphs, 3 classes, hidden 32, 3 rounds, 16-graph batches, 6
    epochs with an eval after each, early stopping at patience 3),
    checkpointing to a temporary directory: exactly 3 edge_mpnn_runs and
    1 segment_pool_runs a forward; `best_checkpoint` names a directory
    that exists; a second run into its own directory, stopped at its
    first save (max_steps), then resumed with `Trainer(resume=True)`,
    repeats the uninterrupted run's losses exactly; step-1 gradients by
    the [train] rule; one full Graph Networks round (`gn_round_check`).
    Returns (edge_mpnn_runs, segment_pool_runs) launches of the counted
    run."""
    import tempfile
    from repro_torch.orchestration import graph_classification as gcls
    from repro_torch.orchestration.tasks import GraphMulticlassClassification
    data = gcls.providers()
    train, val = data
    with tempfile.TemporaryDirectory() as tmp:
        zero_launches()
        run = gcls.run(device=DEVICE, data=data,
                       ckpt_dir=os.path.join(tmp, "full"))
        torch.cuda.synchronize()
        launches = read_launches()
        evals = len(run.metrics["eval_history"])
        forwards = run.step + evals * val.num_steps
        want = {"edge_mpnn_runs": gcls.ROUNDS * forwards,
                "segment_pool_runs": forwards}
        if any(launches[k] != want.get(k, 0) for k in launches):
            fail(f"graphcls: launches {launches} for {forwards} forwards "
                 f"({gcls.ROUNDS} edge_mpnn_runs and 1 segment_pool_runs "
                 "per forward expected)")
        best = run.metrics["best_checkpoint"]
        cut = gcls.SAVE_INTERVAL
        part = gcls.run(device=DEVICE, data=data, steps=cut,
                        ckpt_dir=os.path.join(tmp, "resumed"))
        rest = gcls.run(device=DEVICE, data=data, resume=True,
                        ckpt_dir=os.path.join(tmp, "resumed"))
        losses = run.metrics["train_losses"]
        resumed = part.metrics["train_losses"] + rest.metrics["train_losses"]
        if part.step != cut or resumed != losses or rest.step != run.step:
            fail(f"graphcls: stopped at {part.step} and resumed to "
                 f"{rest.step}, losses {resumed} vs uninterrupted "
                 f"{run.step}: {losses}")
        best_name = os.path.basename(best)
    task = GraphMulticlassClassification("atoms", gcls.CLASSES, gcls.HIDDEN)
    grads = twin_grad_check(torch, "graphcls", task, gcls.model_fn,
                            gcls.HIDDEN, train)
    from repro_torch.core.graph_tensor import unstack_graph
    # the twin's batches are stacked [1, ...] super-batches
    gn = gn_round_check(torch, unstack_graph(next(iter(train.epoch(0))))[0])
    em = run.metrics["eval"]
    step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
    phase("graphcls", f"{run.step} steps ({train.num_steps} an epoch, "
          f"{evals} evals of {val.num_steps} batches"
          f"{', stopped early' if run.metrics.get('stopped_early') else ''}"
          f"); loss {losses[0]:.4f} -> {losses[-1]:.4f}; eval accuracy "
          f"{em['accuracy']:.4f} loss {em['loss']:.4f}; best checkpoint "
          f"{best_name} (step {run.metrics['best_step']}); stopped at step "
          f"{cut} and resumed: all {len(losses)} losses exactly equal; "
          f"{grads}; {gn}; launches {launches}; Trainer step "
          f"{step_ms:.2f} ms median")
    return launches["edge_mpnn_runs"], launches["segment_pool_runs"]


def service_phase(torch, raw, spec, setup, trained, smi) -> int:
    """[train]'s run again, its batches from a sampler fleet: the §8 model
    at full width from the same draw, the same roots, sizes and plan, 24
    steps of 16 roots through `runner.run(sampler="service")` over a
    "process" fleet of 2 workers, double-buffered (pinned copies a step
    ahead on a side stream).  The fleet forks this CUDA-initialized
    process; its workers run numpy only.  Every loss must equal [train]'s
    kernel run bit for bit (the fleet's stream is the StoreProvider's,
    and the run kernels fold in a fixed order on sorted ids), with
    exactly 5 x ROUNDS edge_mpnn_runs a forward and no other kernel.
    Returns edge_mpnn_runs' launches."""
    from repro_torch.orchestration import runner
    from repro_torch.sampling_service import SamplingService
    train_roots, _, sizes = setup
    task = root_task()
    svc = SamplingService(raw, spec, train_roots, batch_size=TRAIN_BATCH,
                          sizes=sizes, num_workers=2, seed=0, base_seed=0,
                          backend="process")
    try:
        procs = [w.process for w in svc.coordinator.workers.values()]
        if svc.backend != "process" or not all(
                hasattr(p_, "pid") for p_ in procs):
            fail(f"service: the fleet runs backend {svc.backend!r}, not "
                 "forked processes")
        zero_launches()
        run = runner.run(model_fn=lambda: model_parts(torch, "sum"),
                         task=task, epochs=1, learning_rate=TRAIN_LR,
                         total_steps=TRAIN_TOTAL, log_every=10 ** 6,
                         seed=SEED, max_steps=TRAIN_STEPS,
                         sampler="service", service=svc,
                         label_fn=task.labels, device=DEVICE)
        torch.cuda.synchronize()
        launches = read_launches()
        marks = svc.watermarks()
    finally:
        svc.close(timeout=10.0)
    if any(p_.is_alive() for p_ in procs):
        fail("service: a fleet process outlived close()")
    if run.step != TRAIN_STEPS:
        fail(f"service: {run.step} steps, expected {TRAIN_STEPS}")
    want = {"edge_mpnn_runs": 5 * ROUNDS * run.step}
    if any(launches[k] != want.get(k, 0) for k in launches):
        fail(f"service: launches {launches} for {run.step} forwards "
             f"({5 * ROUNDS} edge_mpnn_runs per forward expected, no other "
             "kernel)")
    losses = run.metrics["train_losses"]
    if losses != trained["losses"]:
        fail(f"service: the fleet-fed losses {losses} differ from [train]'s "
             f"kernel run {trained['losses']}")
    step_ms = 1e3 * statistics.median(run.metrics["step_seconds"][1:])
    wait_ms = 1e3 * statistics.median(run.metrics["batch_wait_seconds"][1:])
    phase("service", f"{smi}: {run.step} steps x {TRAIN_BATCH} roots from "
          f"a process fleet of 2 workers (watermarks {marks}), "
          f"double-buffered; all {run.step} losses bit-identical to "
          f"[train]'s kernel run ({losses[0]:.6f} -> {losses[-1]:.6f}); "
          f"launches {launches} = {launches['edge_mpnn_runs'] // run.step}"
          f"/forward; Trainer step {step_ms:.2f} ms median = "
          f"{1e3 * TRAIN_BATCH / step_ms:.1f} roots/s, waiting for the "
          f"batch {wait_ms:.2f} ms median; [train] (sampling on the loop's "
          f"thread): step {trained['step_ms']:.2f} ms, waiting "
          f"{trained['wait_ms']:.2f} ms")
    return launches["edge_mpnn_runs"]


def outofcore_phase(torch, smi) -> int:
    """`out_of_core.run` at the example's defaults on the card (24000
    papers x 1024 fp32 features, 64 roots, 6 steps of 8, hidden 32, 2
    rounds over cites and written): a thread fleet's run, then a dial
    fleet of 2 subprocess workers (`python -m
    repro_torch.storage.dial_worker`, one shard each) over a
    GraphDirectory in a temporary directory.  The two runs' losses must
    be exactly equal over as many steps, each worker's peak RSS below the
    directory's bytes, and each forward exactly 2 rounds x 2 edge sets =
    4 edge_mpnn_runs, no other kernel.  Returns edge_mpnn_runs'
    launches."""
    from repro_torch.orchestration import out_of_core
    per_forward = 2 * len(out_of_core.EDGES)
    t0 = time.perf_counter()
    data = out_of_core.problem()
    t_data = time.perf_counter() - t0
    zero_launches()
    t0 = time.perf_counter()
    try:
        result = out_of_core.run(device=DEVICE, data=data)
    except RuntimeError as exc:
        fail(f"outofcore: {exc}")
    torch.cuda.synchronize()
    t_runs = time.perf_counter() - t0
    launches = read_launches()
    forwards = result.thread.step + result.dial.step
    want = {"edge_mpnn_runs": per_forward * forwards}
    if any(launches[k] != want.get(k, 0) for k in launches):
        fail(f"outofcore: launches {launches} for {forwards} forwards "
             f"({per_forward} edge_mpnn_runs per forward expected, no "
             "other kernel)")
    losses = result.dial.metrics["train_losses"]
    if result.dial.step != out_of_core.STEPS or \
            losses != result.thread.metrics["train_losses"] or \
            not np.isfinite(losses).all():
        fail(f"outofcore: dial {result.dial.step} steps {losses} vs thread "
             f"{result.thread.step} steps "
             f"{result.thread.metrics['train_losses']}")
    total = result.graph_bytes
    rss = ", ".join(f"worker {w} {peak / 2 ** 20:.1f} MiB (ratio "
                    f"{peak / total:.3f})"
                    for w, peak in enumerate(result.peak_rss))
    step_ms = [1e3 * statistics.median(r.metrics["step_seconds"][1:])
               for r in (result.thread, result.dial)]
    phase("outofcore", f"{smi}: {out_of_core.PAPERS} papers x "
          f"{out_of_core.FEAT_DIM} features, GraphDirectory {total} bytes "
          f"({total / 2 ** 20:.1f} MiB); thread and dial fleets "
          f"{result.dial.step} steps each, losses exactly equal "
          f"({losses[0]:.6f} -> {losses[-1]:.6f}); peak RSS {rss}, all "
          f"below graph bytes; launches {launches} = "
          f"{launches['edge_mpnn_runs'] // forwards}/forward; Trainer step "
          f"thread {step_ms[0]:.2f} ms, dial {step_ms[1]:.2f} ms median; "
          f"data {t_data:.1f} s, both runs {t_runs:.1f} s (host clock)")
    return launches["edge_mpnn_runs"]

# ---------------------------------------------------------------------------
# the mesh: data- and feature-parallel training over torch.distributed
# ---------------------------------------------------------------------------

def mesh_batches(raw, spec, roots, path) -> list:
    """The first MESH_STEPS super-batches of MESH_GROUPS groups x
    MESH_ROOTS roots over `roots` (target-sorted, sizes profiled per
    group, as the §8 example sizes a super-batch's groups) with their
    per-group labels, as (graph, labels) pairs, also pickled to `path`
    for the spawned ranks."""
    import pickle
    from repro_torch.data.batching import find_size_constraints
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    from repro_torch.orchestration.providers import StoreProvider
    per_step = MESH_GROUPS * MESH_ROOTS
    roots = roots[:MESH_STEPS * per_step]
    sizes = find_size_constraints(
        [sample_subgraph(raw, spec, int(r), seed_rng(0, int(r)))
         for r in roots], MESH_ROOTS)
    task = root_task()
    pairs = [(g, task.labels(g)) for g in StoreProvider(
        raw, spec, roots, batch_size=per_step, sizes=sizes,
        num_replicas=MESH_GROUPS).epoch(0)]
    with open(path, "wb") as f:
        pickle.dump(pairs, f)
    return pairs


MESH_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "broadcast", "barrier")


@contextlib.contextmanager
def collective_clock(mesh=None):
    """Count the `torch.distributed` calls made inside the block and the
    host time spent inside them (a gloo call returns once its exchange
    is done, the copies of CUDA tensors to and from the host included):
    {"calls": n, "ms": t, "per_op": {name: n}, "per_axis": {axis: n}}
    (the axis of `mesh` whose process group a call names, "world" for
    the default group or one of no axis)."""
    import torch.distributed as dist
    seen = {"calls": 0, "ms": 0.0,
            "per_op": {name: 0 for name in MESH_COLLECTIVES},
            "per_axis": {}}
    real = {name: getattr(dist, name) for name in MESH_COLLECTIVES}
    names = {id(axis.group): name for name, axis in
             (mesh.axes.items() if mesh is not None else ())
             if axis.group is not None}

    def timed(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seen["ms"] += 1e3 * (time.perf_counter() - t0)
                seen["calls"] += 1
                seen["per_op"][name] += 1
                axis = names.get(id(kwargs.get("group")), "world")
                seen["per_axis"][axis] = seen["per_axis"].get(axis, 0) + 1
        return call

    for name, fn in real.items():
        setattr(dist, name, timed(name, fn))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def mesh_fit(torch, pairs, reduce_type: str, num_devices: int,
             model_parallel: int, steps: int, plain: bool = False) -> dict:
    """One `Trainer(num_devices=, model_parallel=)` fit over the
    super-batches `pairs` from seed 0 on the card (the [train] recipe);
    what the phase prints and compares, launches and collectives
    counted around the fit on this rank."""
    from repro_torch.kernels import registry
    from repro_torch.orchestration.providers import IteratorProvider
    from repro_torch.orchestration.trainer import Trainer
    trainer = Trainer(learning_rate=TRAIN_LR, total_steps=TRAIN_TOTAL,
                      max_steps=steps, seed=SEED, log_every=10 ** 6,
                      device=DEVICE, num_devices=num_devices,
                      model_parallel=model_parallel, eval_at="never")
    zero_launches()
    with registry.plain_versions() if plain else contextlib.nullcontext(), \
            collective_clock() as coll:
        run = trainer.fit(lambda: model_parts(torch, reduce_type),
                          root_task(), IteratorProvider(lambda e: iter(pairs)))
    torch.cuda.synchronize()
    return {"losses": run.metrics["train_losses"], "step": run.step,
            "collectives": coll,
            "launches": read_launches(), "plan": run.metrics["plan"],
            "opt_bytes": run.metrics["opt_state_bytes"],
            "step_ms": 1e3 * statistics.median(
                run.metrics["step_seconds"][1:])}


def mesh_grads(torch, pair, reduce_type: str, num_devices: int,
               model_parallel: int) -> dict:
    """Step 1's gradients of the §8 model (drawn as `fresh_model` draws
    it) on one super-batch through a `num_devices` x `model_parallel`
    plan: this rank's groups' mean loss under the plan's model context,
    each gradient then averaged over every rank as the train step
    averages it, {name: numpy}."""
    from repro_torch.core.graph_tensor import unstack_graph
    from repro_torch.distributed import collectives, partition
    from repro_torch.kernels import registry
    plan = partition.make_plan(num_devices, model_parallel=model_parallel,
                               device=DEVICE)
    task = root_task()
    model = fresh_model(torch, reduce_type)
    params = dict(model.named_parameters())
    graph, labels = plan.put_super_batch(*pair)
    groups = unstack_graph(graph)
    with registry.layout(sorted_by_target=True), plan.model_context():
        loss = sum(task.loss_from_graph(model.head, model(g), labels[i])
                   for i, g in enumerate(groups)) / len(groups)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    world = plan.mesh.world
    return {k: (collectives.all_reduce(g, world) / world.size).cpu().numpy()
            for k, g in zip(params, grads)}


def mesh_grad_gap(name: str, got: dict, want: dict) -> float:
    """The worst gradient error of `got` against `want` relative to each
    leaf's largest `want` entry; fails beyond the [train] rule
    (GRAD_RTOL of that entry)."""
    worst = 0.0
    for k, b in want.items():
        a = got[k]
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        if not np.isfinite(a).all() or err > GRAD_RTOL * scale + 1e-7:
            fail(f"mesh {name} {k}: step-1 gradient differs from one rank's "
                 f"by {err:.3e} (largest entry {scale:.3e}, rtol "
                 f"{GRAD_RTOL})")
        if scale > 0:
            worst = max(worst, err / scale)
    return worst


def mesh_rank(path: str, reduce_type: str, model_parallel: int,
              steps: int) -> dict:
    """What each spawned rank of `[mesh]` (b) and (c) runs; a rank of a
    model-split plan also returns step 1's gradients (`mesh_grads`) on
    the first super-batch."""
    import pickle
    import torch
    full_fp32(torch)
    with open(path, "rb") as f:
        pairs = pickle.load(f)
    grads = (mesh_grads(torch, pairs[0], reduce_type, MESH_RANKS,
                        model_parallel) if model_parallel > 1 else None)
    # start the counted fit together: a rank still loading would show
    # up as the other's time inside its first collective
    torch.distributed.barrier()
    run = mesh_fit(torch, pairs, reduce_type, MESH_RANKS, model_parallel,
                   steps)
    run["grads"] = grads
    return run


def mesh_line(name, run, kernel, groups, per_step, smi) -> str:
    """The phase's text for one run; fails unless every forward on this
    rank launched exactly 5 x ROUNDS of `kernel` and no other kernel."""
    forwards = run["step"] * groups
    launches = run["launches"]
    if launches[kernel] != 5 * ROUNDS * forwards or any(
            n for k, n in launches.items() if k != kernel):
        fail(f"mesh {name}: launches {launches} for {forwards} group "
             f"forwards ({5 * ROUNDS} {kernel} per group expected)")
    coll = run["collectives"]
    return (f"{name} plan {run['plan']}: step {run['step_ms']:.2f} ms median "
            f"= {1e3 * per_step / run['step_ms']:.1f} roots/s ({smi}); "
            f"collectives {coll['calls'] / run['step']:.1f} calls and "
            f"{coll['ms'] / run['step']:.2f} ms a step (host clock inside "
            f"the calls, step 1's setup included); "
            f"{launches[kernel] // forwards} {kernel} per group forward, "
            f"{groups} groups a step on this rank; opt-state "
            f"{run['opt_bytes']} bytes on this rank; losses "
            f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}")


def mesh_phase(torch, raw, spec, setup, smi) -> dict:
    """The port's mesh on the card at full width (the §8 model, 20000
    papers), every plan over the same MESH_STEPS super-batches of
    MESH_GROUPS x MESH_ROOTS target-sorted roots:
    (a) `Trainer(num_devices=1)`, sum model: one rank, no process group;
    step-1 gradients and the first PARITY_STEPS losses vs the same run
    through the plain versions by the [train] rule;
    (b) 2 ranks sharing the card, (data=2), sum model, on gloo: losses
    within MESH_LOSS_ATOL of (a), ZeRO-1 optimizer state at most (a)'s /
    MESH_ZERO_SHRINK a rank;
    (c) 2 ranks, (data=1, model=2), the mean model (its pools run
    `segment_pool_runs` on 64-wide chunks): step-1 gradients on the first
    super-batch by the [train] rule and losses within MESH_LOSS_ATOL of
    (d), one rank of the mean model;
    then the twin `ogbn_mag_train.main(["--steps", "3"])`, which must exit
    0.  Every forward launches exactly 20 `edge_mpnn_runs` (sum) or
    `segment_pool_runs` (mean) per group on each rank.  A rank that
    fails or outlives MESH_TIMEOUT_S fails the phase.  Returns the
    launches of (a) + (b)'s rank 0 and of (c)'s rank 0 + (d)."""
    import tempfile
    from repro_torch.distributed.launch import run_ranks
    from repro_torch.orchestration import ogbn_mag_train
    train_roots = setup[0]
    per_step = MESH_GROUPS * MESH_ROOTS
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        path = os.path.join(tmp, "batches.pkl")
        pairs = mesh_batches(raw, spec, train_roots, path)
        first, first_labels = pairs[0]
        worst, n_params, reached, _, _ = grad_check(torch, "sum", first,
                                                    first_labels)
        a = mesh_fit(torch, pairs, "sum", 1, 1, MESH_STEPS)
        plain = mesh_fit(torch, pairs, "sum", 1, 1, PARITY_STEPS,
                         plain=True)
        head_gap = float(np.abs(np.asarray(a["losses"][:PARITY_STEPS])
                                - np.asarray(plain["losses"])).max())
        if head_gap > LOSS_ATOL:
            fail(f"mesh (a): the first {PARITY_STEPS} losses differ from the "
                 f"plain run by {head_gap:.3e} (atol {LOSS_ATOL})")
        b = run_ranks(mesh_rank, MESH_RANKS,
                      args=(path, "sum", 1, MESH_STEPS), backend="gloo",
                      device=DEVICE + ":0", timeout_s=MESH_TIMEOUT_S)
        c = run_ranks(mesh_rank, MESH_RANKS,
                      args=(path, "mean", MESH_RANKS, MESH_STEPS),
                      backend="gloo", device=DEVICE + ":0",
                      timeout_s=MESH_TIMEOUT_S)
        d = mesh_fit(torch, pairs, "mean", 1, 1, MESH_STEPS)
        d_grads = mesh_grads(torch, pairs[0], "mean", 1, 1)
    c_grad_gap = max(mesh_grad_gap(f"(c) rank {rank}", run["grads"], d_grads)
                     for rank, run in enumerate(c))
    checks = []
    for name, runs, ref in (("(b)", b, a), ("(c)", c, d)):
        for rank, run in enumerate(runs):
            gap = float(np.abs(np.asarray(run["losses"])
                               - np.asarray(ref["losses"])).max())
            if run["step"] != MESH_STEPS or gap > MESH_LOSS_ATOL:
                fail(f"mesh {name} rank {rank}: {run['step']} steps, losses "
                     f"{run['losses']} vs one rank's {ref['losses']} (max "
                     f"gap {gap:.3e}, atol {MESH_LOSS_ATOL})")
            checks.append(gap)
    if b[0]["opt_bytes"] * MESH_ZERO_SHRINK > a["opt_bytes"]:
        fail(f"mesh (b): ZeRO-1 left {b[0]['opt_bytes']} bytes of optimizer "
             f"state a rank against one rank's {a['opt_bytes']}")
    phase("mesh", mesh_line("(a)", a, "edge_mpnn_runs", MESH_GROUPS,
                            per_step, smi)
          + f"; one rank, no process group; step-1 gradients "
          f"of {n_params} parameters ({reached} reached) max rel err vs "
          f"plain {worst:.2e} (rtol {GRAD_RTOL}); first {PARITY_STEPS} "
          f"losses vs plain {head_gap:.2e} (atol {LOSS_ATOL})")
    for name, runs, kernel, groups in (
            ("(b)", b, "edge_mpnn_runs", MESH_GROUPS // MESH_RANKS),
            ("(c)", c, "segment_pool_runs", MESH_GROUPS)):
        for rank, run in enumerate(runs):
            phase("mesh", f"rank {rank} " + mesh_line(
                name, run, kernel, groups, per_step, smi))
    phase("mesh", mesh_line("(d)", d, "segment_pool_runs", MESH_GROUPS,
                            per_step, smi))
    phase("mesh", f"(b) vs (a) and (c) vs (d): per-step losses within "
          f"{max(checks):.2e} over {MESH_STEPS} steps (atol "
          f"{MESH_LOSS_ATOL}); ZeRO-1 (b) {b[0]['opt_bytes']} vs (a) "
          f"{a['opt_bytes']} optimizer bytes a rank "
          f"({a['opt_bytes'] / b[0]['opt_bytes']:.3f}x); (c) vs (d) step-1 "
          f"gradients of {len(d_grads)} parameters on the first "
          f"super-batch, max rel err {c_grad_gap:.2e} (rtol {GRAD_RTOL})")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = ogbn_mag_train.main(["--steps", "3"])
    tail = [line for line in out.getvalue().splitlines()
            if line.startswith(("final loss", "ogbn_mag_train"))]
    if code != 0 or "ogbn_mag_train OK" not in tail:
        fail(f"mesh: the ogbn_mag_train twin exited {code}: "
             f"{out.getvalue()[-2000:]}")
    for line in tail:
        phase("mesh", f"twin: {line}")
    phase("mesh", f"phase {time.perf_counter() - t0:.1f}s")
    return {"edge_mpnn_runs": a["launches"]["edge_mpnn_runs"]
            + b[0]["launches"]["edge_mpnn_runs"],
            "segment_pool_runs": c[0]["launches"]["segment_pool_runs"]
            + d["launches"]["segment_pool_runs"]}


def twin_summary(argv: list, label: str) -> tuple:
    """The ogbn_mag_train twin's `run_twin(argv)` (its ranks are
    subprocesses), with what it printed; fails the phase when a rank
    fails."""
    from repro_torch.distributed.launch import RankFailure
    from repro_torch.orchestration import ogbn_mag_train
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            summary = ogbn_mag_train.run_twin(argv)
    except (SystemExit, RankFailure) as exc:
        fail(f"multihost: the {label} run failed ({exc!r}): "
             f"{out.getvalue()[-3000:]}")
    if len(summary["ranks"]) != MULTIHOST_RANKS:
        fail(f"multihost: the {label} run reported {len(summary['ranks'])} "
             f"ranks, not {MULTIHOST_RANKS}")
    return summary, out.getvalue()


def multihost_rank_line(label: str, rank: dict, forwards: int) -> tuple:
    """One rank's text and its median step and batch wait (ms, after the
    first step); fails unless every group forward on the rank launched
    exactly 5 x ROUNDS `edge_mpnn_runs` and no other kernel."""
    launches = rank["launches"]
    if launches["edge_mpnn_runs"] != 5 * ROUNDS * forwards or any(
            n for k, n in launches.items() if k != "edge_mpnn_runs"):
        fail(f"multihost {label} rank {rank['rank']}: launches {launches} "
             f"for {forwards} group forwards ({5 * ROUNDS} edge_mpnn_runs "
             "per group expected)")
    step = 1e3 * statistics.median(rank["step_seconds"][1:])
    wait = 1e3 * statistics.median(rank["batch_wait_seconds"][1:])
    first_step = 1e3 * rank["step_seconds"][0]
    first_wait = 1e3 * rank["batch_wait_seconds"][0]
    return (f"{label} rank {rank['rank']}: step {step:.2f} ms median, batch "
            f"wait {wait:.3f} ms median (first step {first_step:.1f} ms, "
            f"wait {first_wait:.1f}); {launches['edge_mpnn_runs'] // forwards}"
            f" edge_mpnn_runs per group forward over {forwards} (1 group a "
            "step)", step, wait)


def multihost_phase(torch, smi) -> int:
    """Multi-host sampling on the card: the ogbn_mag_train twin (the §8
    model at the twin's width, hidden 64) at ``--multihost 2
    --num-devices 2``, two processes of one gloo world sharing the card,
    every rank reading its row's batches over loopback TCP from rank 0's
    `SamplerEndpoint`; then the same argv in-process (two spawned ranks,
    each placing its block of the global super-batch).  Fails unless
    every per-step loss of each rank is within MESH_LOSS_ATOL of the
    in-process run's (the batches are bit-identical, the collectives the
    same) and every group forward on each rank launched exactly 20
    `edge_mpnn_runs`; prints both runs' median step time, batch wait and
    roots/s and their ratio (not gated: no benchmark file).  Returns the
    launches of both runs' rank 0."""
    argv = ["--num-devices", str(MULTIHOST_RANKS), "--steps",
            str(MULTIHOST_STEPS), "--papers", str(MULTIHOST_PAPERS)]
    from repro_torch.orchestration import ogbn_mag_train
    t0 = time.perf_counter()
    remote, text = twin_summary(argv + ["--multihost", str(MULTIHOST_RANKS)],
                                "--multihost")
    if "multihost: OK" not in text or "service over TCP" not in text:
        fail(f"multihost: the launcher did not report OK over TCP: "
             f"{text[-3000:]}")
    t1 = time.perf_counter()
    local, _ = twin_summary(argv, "in-process")
    t2 = time.perf_counter()
    n_test = MULTIHOST_PAPERS - int(MULTIHOST_PAPERS * 0.75)
    forwards = MULTIHOST_STEPS + n_test // ogbn_mag_train.BATCH
    gaps, steps = [], {}
    for label, run in (("--multihost", remote), ("in-process", local)):
        for rank, ref in zip(run["ranks"], local["ranks"]):
            gap = float(np.abs(np.asarray(rank["losses"])
                               - np.asarray(ref["losses"])).max())
            if rank["steps"] != MULTIHOST_STEPS or gap > MESH_LOSS_ATOL \
                    or not np.isfinite(rank["losses"]).all():
                fail(f"multihost {label} rank {rank['rank']}: "
                     f"{rank['steps']} steps, losses {rank['losses']} vs the "
                     f"in-process run's {ref['losses']} (max gap {gap:.3e}, "
                     f"atol {MESH_LOSS_ATOL})")
            gaps.append(gap)
            line, step, wait = multihost_rank_line(label, rank, forwards)
            steps.setdefault(label, []).append(step)
            phase("multihost", line)
    per_step = ogbn_mag_train.BATCH
    rates = {label: 1e3 * per_step / max(v) for label, v in steps.items()}
    phase("multihost", f"roots/s (16 roots a step over the slower rank's "
          f"median step): --multihost {rates['--multihost']:.1f}, "
          f"in-process {rates['in-process']:.1f}, ratio "
          f"{rates['--multihost'] / rates['in-process']:.3f} ({smi}); "
          f"per-step losses within {max(gaps):.2e} over {MULTIHOST_STEPS} "
          f"steps (atol {MESH_LOSS_ATOL}), final loss "
          f"{remote['final_loss']:.4f} / {local['final_loss']:.4f}, test "
          f"accuracy {remote['test_accuracy']:.4f} / "
          f"{local['test_accuracy']:.4f}; runs {t1 - t0:.1f}s / "
          f"{t2 - t1:.1f}s")
    return (remote["ranks"][0]["launches"]["edge_mpnn_runs"]
            + local["ranks"][0]["launches"]["edge_mpnn_runs"])


# ---------------------------------------------------------------------------
# LM serving: the dense decoder at full width behind ServeEngine
# ---------------------------------------------------------------------------

LM_ARCH = "qwen1.5-4b"
LM_SLOTS, LM_MAX_LEN = 4, 512
LM_REQUESTS, LM_PROMPT, LM_NEW = 8, 12, 16
LM_CHECK_PROMPT = 64
LM_LONG_PROMPT = 2048
LM_FLASH_TOKENS = 2048
LM_FLASH_TOL = 2e-2             # [kernels]' bf16 tolerance
# decode after prefill vs the full forward, bf16 compute and a bf16
# cache, logits of unit scale: the two take the same ops on other
# shapes (M 65 against 64 + 1), so cuBLAS may split the bf16 products'
# sums otherwise and each of the 40 layers' bf16 activations can round
# the other way (2^-8 relative a rounding); the reference's smoke test
# holds fp32 to 2e-2.
LM_DECODE_ATOL = 0.25
LM_DECODE_RTOL = 0.05
E4M3_CASES = (0.0, 1e-9, 240.0, 447.0, 448.0, 449.0, 463.9, 464.0, 464.1,
              466.0, 480.0, 1e4, float("inf"), float("nan"))


def lm_config():
    from repro_torch.models.registry import get_config
    return get_config(LM_ARCH)


def lm_prompts(cfg, n: int, length: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, length).astype(np.int32)
            for _ in range(n)]


def lm_finite_spy(torch, model) -> list:
    """Wrap the model's prefill and decode_step so each records, on the
    device, whether all its logits are finite; returns the flags' list
    (read after the run: no sync inside it)."""
    flags = []
    for name in ("prefill", "decode_step"):
        original = getattr(model, name)

        def spy(*args, _original=original, **kwargs):
            out, cache = _original(*args, **kwargs)
            flags.append(torch.isfinite(out.logits).all())
            return out, cache
        setattr(model, name, spy)
    return flags


def lm_unspy(model) -> None:
    for name in ("prefill", "decode_step"):
        delattr(model, name)


def lm_greedy(torch, model, prompt, new_tokens: int) -> list:
    """The hand-rolled loop: prefill, then decode_step with the cache's
    length set as ServeEngine.step sets it (the prompt + 1 at the first
    decode, the reference's gap, then one more a step)."""
    with torch.inference_mode():
        tokens = torch.as_tensor(prompt.astype(np.int64),
                                 device=DEVICE)[None]
        out, cache = model.prefill(tokens, max_len=LM_MAX_LEN)
        toks = [int(torch.argmax(out.logits[0, -1]))]
        length = len(prompt) + 1
        while len(toks) < new_tokens:
            cache.length = length
            out, cache = model.decode_step(
                torch.tensor([[toks[-1]]], device=DEVICE), cache)
            toks.append(int(torch.argmax(out.logits[0, -1])))
            length += 1
    return toks


def lm_engine_run(torch, cfg, model, n_slots, prompts, temps) -> tuple:
    """ServeEngine over the prompts; (done requests, seconds)."""
    from repro_torch.serve.engine import Request, ServeEngine
    engine = ServeEngine(cfg, model, n_slots=n_slots, max_len=LM_MAX_LEN)
    reqs = [Request(prompt=p, max_new_tokens=LM_NEW, temperature=t)
            for p, t in zip(prompts, temps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0


def lm_decode_check(torch, model) -> tuple:
    """Decode after a LM_CHECK_PROMPT-token prefill against the full
    forward's last position, the cache in the compute dtype (bf16) and
    then in the config's float8: (max |bf16 cache - forward|, max |float8
    cache - bf16 cache|)."""
    import dataclasses
    cfg = model.cfg
    [toks] = lm_prompts(cfg, 1, LM_CHECK_PROMPT + 1, SEED + 3)
    toks = torch.as_tensor(toks.astype(np.int64), device=DEVICE)[None]
    decoded = {}
    with torch.inference_mode():
        full = model(toks).logits[:, -1]
        for kv in ("", cfg.kv_cache_dtype):
            model.cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
            try:
                _, cache = model.prefill(toks[:, :-1], max_len=LM_MAX_LEN)
                decoded[kv] = model.decode_step(toks[:, -1:],
                                                cache)[0].logits[:, 0]
            finally:
                model.cfg = cfg
    bf16 = decoded[""]
    if not torch.allclose(bf16, full, rtol=LM_DECODE_RTOL,
                          atol=LM_DECODE_ATOL):
        fail(f"lm: decode after prefill differs from the full forward by "
             f"{(bf16 - full).abs().max().item():.3e} (rtol "
             f"{LM_DECODE_RTOL}, atol {LM_DECODE_ATOL}; logits up to "
             f"{full.abs().max().item():.3f})")
    return ((bf16 - full).abs().max().item(),
            (decoded[cfg.kv_cache_dtype] - bf16).abs().max().item(),
            full.abs().max().item())


def lm_cast_check(torch) -> int:
    """`to_kv_dtype` on the card against the CPU, float8_e4m3fn: the
    overflow boundary (both signs) in fp32 and bf16, and 2^20 random
    values spread over it.  Equal bytes, NaN where the CPU has NaN.
    Returns the values checked."""
    from repro_torch.nn.attention import to_kv_dtype
    g = torch.Generator().manual_seed(SEED + 4)
    edge = torch.tensor(E4M3_CASES, dtype=torch.float32)
    values = torch.cat([edge, -edge,
                        torch.randn(1 << 20, generator=g) * 160.0])
    fp8 = torch.float8_e4m3fn
    for dtype in (torch.float32, torch.bfloat16):
        x = values.to(dtype)
        want = to_kv_dtype(x, fp8)
        got = to_kv_dtype(x.to(DEVICE), fp8).cpu()
        gn, wn = got.float().isnan(), want.float().isnan()
        if not torch.equal(gn, wn) or not torch.equal(
                got.view(torch.uint8)[~wn], want.view(torch.uint8)[~wn]):
            bad = (got.float() != want.float()) & ~(gn & wn)
            fail(f"lm: the float8 cast of {dtype} differs on the card at "
                 f"{x[bad][:8].tolist()}: {got[bad][:8].float().tolist()} "
                 f"vs {want[bad][:8].float().tolist()} on the CPU")
        if not wn[:len(E4M3_CASES)][-5:].all():
            fail(f"lm: the float8 cast of {dtype} keeps a value past 464")
    return 2 * values.numel()


def lm_flash_check(torch, cfg) -> tuple:
    """One Attention of the config's shapes (bf16 input, fp32 weights
    cast per call), causal over LM_FLASH_TOKENS tokens: use_flash=True
    makes exactly one flash launch and agrees with the chunked path
    (use_flash=False, LM_FLASH_TOKENS >= chunk_threshold) within
    LM_FLASH_TOL.  Returns (launches, max err, call): ``call(flash)``
    runs the layer on either path, for timing."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.nn.attention import Attention
    from repro_torch.nn.layers import init_params
    with torch.device(DEVICE):
        attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, qkv_bias=cfg.qkv_bias,
                         out_bias=cfg.out_bias, rope_theta=cfg.rope_theta,
                         q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                         use_flash=True)
    init_params(attn, SEED + 6)
    if LM_FLASH_TOKENS < attn.chunk_threshold:
        fail("lm: the flash check's length would not take the chunked path")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    x = torch.randn(1, LM_FLASH_TOKENS, cfg.d_model, generator=g,
                    device=DEVICE).to(torch.bfloat16)

    def call(flash: bool):
        attn.use_flash = flash
        with torch.inference_mode():
            return attn(x)

    before = flash_attention.launches
    got = call(True)
    torch.cuda.synchronize()
    launches = flash_attention.launches - before
    if launches != 1:
        fail(f"lm: Attention(use_flash=True) made {launches} flash "
             "launches in one call (1 expected)")
    before = flash_attention.launches
    want = call(False)
    if flash_attention.launches != before:
        fail("lm: Attention(use_flash=False) launched the flash kernel")
    err = _close(torch, "lm: Attention flash vs chunked", got, want,
                 LM_FLASH_TOL, LM_FLASH_TOL)
    return launches, err, call


def lm_hold_bf16(torch, model) -> None:
    """Hold the Linear weights and biases and the embedding table in
    bf16 (norm scales stay fp32): every call casts them to bf16 anyway,
    so the same bits come out."""
    from repro_torch.nn.layers import Embedding, Linear
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Linear, Embedding)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(torch.bfloat16)


def lm_times(torch, model) -> dict:
    """Prefill ms at LM_PROMPT and LM_LONG_PROMPT tokens and decode ms a
    step at LM_SLOTS slots (CUDA events; the decode rewrites one
    position of a cache filled to LM_CHECK_PROMPT), and a decode step's
    device us and device kernels (torch.profiler)."""
    cfg = model.cfg
    out = {}
    with torch.inference_mode():
        for n in (LM_PROMPT, LM_LONG_PROMPT):
            [p] = lm_prompts(cfg, 1, n, SEED + 8)
            toks = torch.as_tensor(p.astype(np.int64), device=DEVICE)[None]
            out[f"prefill_{n}"] = time_ms(
                torch, lambda t=toks: model.prefill(t, max_len=LM_MAX_LEN),
                calls=3, reps=3, warmup=1)
        cache = model.init_cache(LM_SLOTS, LM_MAX_LEN)
        cache.length = LM_CHECK_PROMPT
        tok = torch.zeros(LM_SLOTS, 1, dtype=torch.int64, device=DEVICE)
        out["decode"] = time_ms(torch, lambda: model.decode_step(tok, cache),
                                calls=10, reps=3, warmup=2)
        out["profile"] = device_per_call(
            torch, lambda: model.decode_step(tok, cache), calls=1)
    return out


def lm_phase(torch, smi) -> int:
    """The dense decoder at full width (qwen1.5-4b: 40 layers, d_model
    2560, 20 heads x 128, kv 20, d_ff 6912, vocab 151936, QKV bias,
    untied head; bf16 compute, float8_e4m3fn KV cache; fp32 weights
    drawn on the card from seed 0) behind `ServeEngine`: (1) 8 requests
    over 4 slots, recycled; (2) at 1 slot, greedy tokens equal to the
    hand-rolled prefill -> decode_step loop bit for bit; (3) decode after
    prefill against the full forward; (4) the float8 cast on the card
    against the CPU; (5) flash through the LM's Attention layer; (6)
    times; (7) the lm_serve twin at its defaults.  Returns the flash
    launches of the phase's main path (its one use_flash call)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.models.registry import build_model
    from repro_torch.nn.layers import init_params
    from repro_torch.orchestration import lm_serve

    t0 = time.perf_counter()
    cfg = lm_config()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        model = init_params(build_model(cfg, DEVICE), SEED)
    n_params = sum(p.numel() for p in model.parameters())
    fp32_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    flash_attention.launches = 0

    # (1) the engine, 8 requests over 4 slots
    flags = lm_finite_spy(torch, model)
    prompts = lm_prompts(cfg, LM_REQUESTS, LM_PROMPT, SEED)
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(LM_REQUESTS)]
    done, t_engine = lm_engine_run(torch, cfg, model, LM_SLOTS, prompts,
                                   temps)
    lm_unspy(model)
    finite = bool(torch.stack(flags).all())
    tokens = [t for r in done for t in r.generated]
    if (len(done) != LM_REQUESTS
            or not all(r.done and len(r.generated) >= LM_NEW for r in done)
            or not all(0 <= t < cfg.vocab_size for t in tokens)
            or not finite):
        fail(f"lm: engine served {len(done)} of {LM_REQUESTS} requests, "
             f"lengths {[len(r.generated) for r in done]}, tokens in range "
             f"{all(0 <= t < cfg.vocab_size for t in tokens)}, logits "
             f"finite {finite}")

    # (2) the engine against its own bookkeeping, greedy at one slot
    [greedy_req], _ = lm_engine_run(torch, cfg, model, 1, prompts[:1], [0.0])
    manual = lm_greedy(torch, model, prompts[0], LM_NEW)
    if greedy_req.generated != manual:
        fail(f"lm: engine tokens {greedy_req.generated} != prefill -> "
             f"decode_step loop {manual}")

    # (3) decode after prefill vs the full forward; (4) the float8 cast
    decode_err, fp8_gap, logit_scale = lm_decode_check(torch, model)
    n_cast = lm_cast_check(torch)

    # (5) flash through the LM's own Attention layer
    launches, flash_err, call = lm_flash_check(torch, cfg)
    torch.cuda.synchronize()
    main_launches = flash_attention.launches
    if main_launches != 1:
        fail(f"lm: {main_launches} flash launches on the phase's path (1 "
             "expected: the use_flash call)")
    flash_ms, chunked_ms = (time_ms(torch, lambda f=f: call(f), calls=5,
                                    reps=3, warmup=1) for f in (True, False))

    # (6) times, fp32-held weights, then bf16-held
    t_times = time.perf_counter()
    times = lm_times(torch, model)
    t_times = time.perf_counter() - t_times
    kv_bytes = (model.init_cache(LM_SLOTS, LM_MAX_LEN).k.numel() * 2
                * torch.empty(0, dtype=model.kv_dtype()).element_size())
    lm_hold_bf16(torch, model)
    bf16_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    held = lm_greedy(torch, model, prompts[0], LM_NEW)
    if held != manual:
        fail(f"lm: bf16-held weights gave tokens {held} != {manual}")
    times16 = lm_times(torch, model)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()

    # (7) the twin at its defaults
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = lm_serve.main([])
    for line in out.getvalue().splitlines():
        phase("lm", f"twin: {line}")
    if rc != 0:
        fail(f"lm: lm_serve.main([]) returned {rc}")

    bound = fp32_bytes / PEAK_BYTES_PER_S * 1e3
    bound16 = bf16_bytes / PEAK_BYTES_PER_S * 1e3
    cast_bound = (fp32_bytes + bf16_bytes * 2) / PEAK_BYTES_PER_S * 1e3
    phase("lm", f"{cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} x {cfg.resolved_head_dim} heads, "
          f"kv {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params} parameters ({fp32_bytes / 1e9:.2f} GB fp32) drawn "
          f"on the card in {t_build:.1f}s; KV cache {LM_SLOTS} x "
          f"{LM_MAX_LEN} {cfg.kv_cache_dtype} {kv_bytes / 1e9:.3f} GB; "
          f"peak {peak_gb:.2f} GB")
    phase("lm", f"engine: {len(done)} requests ({LM_PROMPT}-token prompts, "
          f"{LM_NEW} new, every other at temperature 0.8) over {LM_SLOTS} "
          f"slots in {t_engine:.2f}s, {len(tokens)} tokens "
          f"({len(tokens) / t_engine:.1f} tok/s), all logits finite; at 1 "
          f"slot greedy tokens equal to prefill -> decode_step bit for bit "
          f"({len(manual)} tokens)")
    phase("lm", f"decode after a {LM_CHECK_PROMPT}-token prefill vs the "
          f"full forward (bf16 cache): max |diff| {decode_err:.4e} (logits "
          f"up to {logit_scale:.3f}; rtol {LM_DECODE_RTOL}, atol "
          f"{LM_DECODE_ATOL}); float8 cache vs bf16 cache: max |diff| "
          f"{fp8_gap:.4e}; float8 cast on the card equal to the CPU's on "
          f"{n_cast} values (NaN past 464)")
    phase("lm", f"flash through Attention ({cfg.n_heads} x "
          f"{cfg.resolved_head_dim}, kv {cfg.n_kv_heads}, bf16, 1 x "
          f"{LM_FLASH_TOKENS}, causal): {launches} launch a call, max err "
          f"{flash_err:.3e} vs the chunked path (tol {LM_FLASH_TOL}); "
          f"layer {flash_ms:.4f} ms with flash vs {chunked_ms:.4f} ms "
          f"chunked")
    phase("lm", f"times ({smi}): prefill {LM_PROMPT} tokens "
          f"{times[f'prefill_{LM_PROMPT}']:.3f} ms, {LM_LONG_PROMPT} tokens "
          f"{times[f'prefill_{LM_LONG_PROMPT}']:.3f} ms; decode a step at "
          f"{LM_SLOTS} slots {times['decode']:.3f} ms "
          f"({LM_SLOTS / times['decode'] * 1e3:.1f} tok/s), device "
          f"{times['profile']['device_us'] / 1e3:.3f} ms in "
          f"{times['profile']['kernels']:.0f} kernels + "
          f"{times['profile']['memsets']:.0f} memsets; bound: weights "
          f"read once {bound:.3f} ms ({fp32_bytes / 1e9:.2f} GB), as cast "
          f"a call {cast_bound:.3f} ms (+ {2 * bf16_bytes / 1e9:.2f} GB "
          f"written and read in bf16)")
    phase("lm", f"bf16-held Linear weights and embedding table (same "
          f"tokens): prefill {LM_PROMPT} "
          f"{times16[f'prefill_{LM_PROMPT}']:.3f} ms, {LM_LONG_PROMPT} "
          f"{times16[f'prefill_{LM_LONG_PROMPT}']:.3f} ms; decode "
          f"{times16['decode']:.3f} ms "
          f"({LM_SLOTS / times16['decode'] * 1e3:.1f} tok/s), device "
          f"{times16['profile']['device_us'] / 1e3:.3f} ms in "
          f"{times16['profile']['kernels']:.0f} kernels; bound "
          f"{bound16:.3f} ms ({bf16_bytes / 1e9:.2f} GB)")
    phase("lm", f"phase {time.perf_counter() - t0:.1f}s (the fp32-held "
          f"times {t_times:.1f}s)")
    return main_launches


# ---------------------------------------------------------------------------
# LM serving: the other families at full width
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("granite-moe-3b-a800m", "rwkv6-3b", "zamba2-1.2b")
# the engine families' depth: their 32 / 32 / 38 layers at full width
# took 42 / 157 / 49 s of the script (NVIDIA H100 80GB HBM3, 700.00 W),
# most of it per layer (rwkv6's Python-loop scans), so the script cuts
# them to this many layers to stay inside its time limit
FAMILY_LAYERS = 8
WHISPER_ARCH = "whisper-medium"
# Whisper's 30-second window is 1500 frames, but an encoder length at or
# past the chunk threshold (1024) must be a multiple of its 512-query and
# 1024-key chunks, in the reference as in the port: 1500 raises in both
# (tests/test_torch_lm_families.py), so the encoder takes 1024 frames
WHISPER_FRAMES = 1024
WHISPER_PROMPT, WHISPER_NEW = 4, 16
# granite-moe-3b-a800m drops assignments past capacity (factor 1.0), and
# the drops of a full forward differ from those of prefill + decode: the
# decode check takes the first prompt length whose prefill and whose
# full forward both drop nothing (at 7 neither can: one group of 7
# tokens, then 8 groups of 1, each under the 8-slot capacity)
MOE_CHECK_PROMPTS = (LM_CHECK_PROMPT, 15, 7)
# decode after prefill vs the full forward is held twice: in the
# config's bf16 compute at [lm]'s tolerance (RWKV6 at FAMILY_RWKV_ATOL),
# and with the same fp32 weights in fp32 compute at FAMILY_FP32_TOL,
# where the two forms differ only in the order of their fp32 sums.
# RWKV6's chunked form rounds its wkv output to bf16 before the
# LayerNorm and its recurrent step does not (repro/nn/ssm.py:335 and
# :355, copied as written); over 32 layers that is the reference's own
# bf16 gap, as large in both packages at the smoke width
# (tests/test_torch_lm_families.py), and larger at full width
FAMILY_RWKV_ATOL = 0.5
FAMILY_FP32_TOL = 1e-3


def family_config(arch: str):
    """`arch` at full width; an engine family at FAMILY_LAYERS layers."""
    import dataclasses
    from repro_torch.models.registry import get_config
    cfg = get_config(arch)
    if arch in FAMILY_ARCHS:
        cfg = dataclasses.replace(cfg, num_layers=FAMILY_LAYERS)
    return cfg


def family_build(torch, arch: str) -> tuple:
    """The model of `arch` built and drawn on the card from SEED (fp32
    weights, the config's bf16 compute): (cfg, model, parameters, fp32
    bytes, seconds)."""
    from repro_torch.models.registry import build_model
    from repro_torch.nn.layers import init_params
    cfg = family_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        model = init_params(build_model(cfg, DEVICE), SEED)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    return cfg, model, n, nbytes, time.perf_counter() - t0


@contextlib.contextmanager
def compute_dtype(model, dtype: str):
    """The model with its config's compute dtype replaced, for a check."""
    import dataclasses
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    try:
        yield
    finally:
        model.cfg = cfg


def family_gap(torch, cfg, got, want, dtype: str) -> float:
    """max |got - want|, failing past the dtype's tolerance."""
    if dtype == "float32":
        rtol = atol = FAMILY_FP32_TOL
    else:
        rtol = LM_DECODE_RTOL
        atol = FAMILY_RWKV_ATOL if cfg.family == "ssm" else LM_DECODE_ATOL
    gap = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"lm-families: {cfg.name} in {dtype} compute, decode after "
             f"prefill differs from the full forward by {gap:.3e} (rtol "
             f"{rtol}, atol {atol}; logits up to "
             f"{want.abs().max().item():.3f})")
    return gap


def family_drops(out, cfg) -> float:
    """The mean drop fraction over the layers of an MoE model's output."""
    return out.aux["moe_drop_fraction"].item() / cfg.num_layers


def family_decode_check(torch, cfg, model) -> tuple:
    """Decode after a prefill against the full forward's last position,
    in bf16 and in fp32 compute: (prompt length, {dtype: max |diff|},
    logit scale, the MoE drop fractions tried as (prompt, prefill,
    forward) in both dtypes)."""
    tried = []
    for length in (MOE_CHECK_PROMPTS if cfg.moe is not None
                   else (LM_CHECK_PROMPT,)):
        [toks] = lm_prompts(cfg, 1, length + 1, SEED + 3)
        toks = torch.as_tensor(toks.astype(np.int64), device=DEVICE)[None]
        runs = {}
        for dtype in (cfg.compute_dtype, "float32"):
            with compute_dtype(model, dtype), torch.inference_mode():
                full = model(toks)
                out, cache = model.prefill(toks[:, :-1], max_len=LM_MAX_LEN)
                dec = model.decode_step(toks[:, -1:], cache)[0]
            runs[dtype] = (out, full, dec)
        if cfg.moe is not None:
            drops = [(family_drops(o, cfg), family_drops(f, cfg))
                     for o, f, _ in runs.values()]
            tried.append((length, drops))
            if any(any(d) for d in drops):
                continue
        gaps = {dtype: family_gap(torch, cfg, dec.logits[:, 0],
                                  full.logits[:, -1], dtype)
                for dtype, (_, full, dec) in runs.items()}
        return (length, gaps,
                runs["float32"][1].logits[:, -1].abs().max().item(), tried)
    fail(f"lm-families: {cfg.name} drops at every prompt length tried "
         f"(prompt, [(prefill, forward) in bf16 and fp32]): {tried}")


def family_times(torch, cfg, model) -> dict:
    """Prefill ms at LM_PROMPT and LM_LONG_PROMPT tokens (and at each an
    MoE model's drop fraction), decode ms a step at LM_SLOTS slots (CUDA
    events; the cache at LM_CHECK_PROMPT), and the device us and kernels
    of one long prefill and of one decode step (torch.profiler)."""
    out = {}
    with torch.inference_mode():
        for n, calls in ((LM_PROMPT, 3), (LM_LONG_PROMPT, 1)):
            [p] = lm_prompts(cfg, 1, n, SEED + 8)
            toks = torch.as_tensor(p.astype(np.int64), device=DEVICE)[None]
            out[f"prefill_{n}"] = time_ms(
                torch, lambda t=toks: model.prefill(t, max_len=LM_MAX_LEN),
                calls=calls, reps=3, warmup=1)
            if cfg.moe is not None:
                out[f"drops_{n}"] = family_drops(
                    model.prefill(toks, max_len=LM_MAX_LEN)[0], cfg)
        out["prefill_profile"] = device_per_call(
            torch, lambda: model.prefill(toks, max_len=LM_MAX_LEN), calls=1)
        cache = model.init_cache(LM_SLOTS, LM_MAX_LEN)
        cache.length = LM_CHECK_PROMPT
        tok = torch.zeros(LM_SLOTS, 1, dtype=torch.int64, device=DEVICE)
        out["decode"] = time_ms(torch, lambda: model.decode_step(tok, cache),
                                calls=10, reps=3, warmup=2)
        out["profile"] = device_per_call(
            torch, lambda: model.decode_step(tok, cache), calls=1)
    return out


def family_serve(torch, smi, arch: str) -> None:
    """One engine family at full width (FAMILY_LAYERS layers): (1)
    ServeEngine, 8
    requests over 4 slots; (2) at 1 slot the engine's greedy tokens
    equal to the hand-rolled prefill -> decode_step loop bit for bit;
    (3) decode after prefill against the full forward; (4) times."""
    t0 = time.perf_counter()
    cfg, model, n_params, fp32_bytes, t_build = family_build(torch, arch)

    flags = lm_finite_spy(torch, model)
    prompts = lm_prompts(cfg, LM_REQUESTS, LM_PROMPT, SEED)
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(LM_REQUESTS)]
    done, t_engine = lm_engine_run(torch, cfg, model, LM_SLOTS, prompts,
                                   temps)
    lm_unspy(model)
    finite = bool(torch.stack(flags).all())
    tokens = [t for r in done for t in r.generated]
    in_range = all(0 <= t < cfg.vocab_size for t in tokens)
    if (len(done) != LM_REQUESTS
            or not all(r.done and len(r.generated) >= LM_NEW for r in done)
            or not in_range or not finite):
        fail(f"lm-families: {cfg.name} engine served {len(done)} of "
             f"{LM_REQUESTS} requests, lengths "
             f"{[len(r.generated) for r in done]}, tokens in range "
             f"{in_range}, logits finite {finite}")

    [greedy_req], _ = lm_engine_run(torch, cfg, model, 1, prompts[:1], [0.0])
    manual = lm_greedy(torch, model, prompts[0], LM_NEW)
    if greedy_req.generated != manual:
        fail(f"lm-families: {cfg.name} engine tokens {greedy_req.generated}"
             f" != prefill -> decode_step loop {manual}")

    length, decode_err, scale, tried = family_decode_check(torch, cfg, model)
    times = family_times(torch, cfg, model)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bf16_bytes = n_params * 2
    del model
    torch.cuda.empty_cache()

    bound16 = bf16_bytes / PEAK_BYTES_PER_S * 1e3
    cast_bound = (fp32_bytes + bf16_bytes * 2) / PEAK_BYTES_PER_S * 1e3
    prof, pre = times["profile"], times["prefill_profile"]
    drops = (f"; drop fractions (prompt, [(prefill, forward) in bf16 and "
             f"fp32]) {tried}" if tried else "")
    long_drops = (f" (drop fraction {times[f'drops_{LM_LONG_PROMPT}']:.4f},"
                  f" at {LM_PROMPT} {times[f'drops_{LM_PROMPT}']:.4f})"
                  if cfg.moe is not None else "")
    phase("lm-families", f"{cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}; {n_params} parameters "
          f"({fp32_bytes / 1e9:.2f} GB fp32) drawn on the card in "
          f"{t_build:.1f}s; engine: {len(done)} requests ({LM_PROMPT}-token "
          f"prompts, {LM_NEW} new, every other at temperature 0.8) over "
          f"{LM_SLOTS} slots x {LM_MAX_LEN} in {t_engine:.2f}s, "
          f"{len(tokens)} tokens ({len(tokens) / t_engine:.1f} tok/s), all "
          f"logits finite; at 1 slot greedy tokens equal to prefill -> "
          f"decode_step bit for bit ({len(manual)} tokens)")
    phase("lm-families", f"{cfg.name}: decode after a {length}-token "
          f"prefill vs the full forward: max |diff| bf16 "
          f"{decode_err[cfg.compute_dtype]:.4e} (rtol {LM_DECODE_RTOL}, "
          f"atol {FAMILY_RWKV_ATOL if cfg.family == 'ssm' else LM_DECODE_ATOL})"
          f", fp32 compute {decode_err['float32']:.4e} (tol "
          f"{FAMILY_FP32_TOL}); logits up to {scale:.3f}{drops}")
    phase("lm-families", f"{cfg.name} times ({smi}): prefill {LM_PROMPT} "
          f"tokens {times[f'prefill_{LM_PROMPT}']:.3f} ms, {LM_LONG_PROMPT} "
          f"tokens {times[f'prefill_{LM_LONG_PROMPT}']:.3f} ms{long_drops}, "
          f"device {pre['device_us'] / 1e3:.3f} ms in {pre['kernels']:.0f} "
          f"kernels; "
          f"decode a step at {LM_SLOTS} slots {times['decode']:.3f} ms "
          f"({LM_SLOTS / times['decode'] * 1e3:.1f} tok/s), device "
          f"{prof['device_us'] / 1e3:.3f} ms in {prof['kernels']:.0f} "
          f"kernels + {prof['memsets']:.0f} memsets; bound: bf16 weights "
          f"read once {bound16:.3f} ms ({bf16_bytes / 1e9:.2f} GB), fp32 "
          f"weights as cast a call {cast_bound:.3f} ms; peak "
          f"{peak_gb:.2f} GB; {time.perf_counter() - t0:.1f}s")


def whisper_serve(torch, smi) -> None:
    """Whisper at full width and depth through its own protocol: encode
    WHISPER_FRAMES stubbed frame embeddings (random, from the seed),
    prefill a WHISPER_PROMPT-token decoder prompt with them, then
    WHISPER_NEW greedy decode steps; every decoded position's logits
    against the full forward's over the same tokens; times."""
    t0 = time.perf_counter()
    cfg, model, n_params, fp32_bytes, t_build = family_build(
        torch, WHISPER_ARCH)
    from repro_torch.nn.transformer import torch_dtype
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    frames = torch.randn(1, WHISPER_FRAMES, cfg.d_model, generator=g,
                         device=DEVICE).to(torch_dtype(cfg.compute_dtype))
    [prompt] = lm_prompts(cfg, 1, WHISPER_PROMPT, SEED + 10)
    toks = torch.as_tensor(prompt.astype(np.int64), device=DEVICE)[None]
    gaps = {}
    for dtype in (cfg.compute_dtype, "float32"):
        audio = frames.to(torch_dtype(dtype))
        with compute_dtype(model, dtype), torch.inference_mode():
            out, cache = model.prefill(toks, max_len=LM_MAX_LEN,
                                       audio_embeds=audio)
            logits, generated = [out.logits[:, -1]], []
            while True:
                generated.append(int(torch.argmax(logits[-1][0])))
                if len(generated) == WHISPER_NEW:
                    break
                out, cache = model.decode_step(
                    torch.tensor([[generated[-1]]], device=DEVICE), cache)
                logits.append(out.logits[:, -1])
            seq = torch.cat([toks, torch.tensor([generated[:-1]],
                                                device=DEVICE)], dim=1)
            full = model(seq, audio_embeds=audio).logits[
                0, WHISPER_PROMPT - 1:]
        got = torch.cat(logits)
        finite = bool(torch.isfinite(got).all())
        if (not finite or len(generated) != WHISPER_NEW
                or not all(0 <= t < cfg.vocab_size for t in generated)):
            fail(f"lm-families: {cfg.name} in {dtype} generated "
                 f"{generated}, logits finite {finite}")
        # every decoded position against the full forward's
        gaps[dtype] = family_gap(torch, cfg, got, full, dtype)
        if dtype == cfg.compute_dtype:
            served, served_cache = generated, cache
    generated, cache = served, served_cache

    with torch.inference_mode():
        encode_ms = time_ms(torch, lambda: model.encode(frames), calls=1,
                            reps=3, warmup=1)
        tok = torch.tensor([[generated[-1]]], device=DEVICE)
        decode_ms = time_ms(torch, lambda: model.decode_step(tok, cache),
                            calls=10, reps=3, warmup=2)
        prof = device_per_call(torch, lambda: model.decode_step(tok, cache),
                               calls=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dec_bytes = sum(p.numel() for n, p in model.named_parameters()
                    if not n.startswith("encoder")) * 2
    del model
    torch.cuda.empty_cache()
    phase("lm-families", f"{cfg.name}: {cfg.enc_layers} + "
          f"{cfg.dec_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}; {n_params} parameters "
          f"({fp32_bytes / 1e9:.2f} GB fp32) drawn on the card in "
          f"{t_build:.1f}s; {WHISPER_FRAMES} frames encoded, a "
          f"{WHISPER_PROMPT}-token prompt prefilled, {WHISPER_NEW} greedy "
          f"tokens {generated[:8]}...; every decoded position vs the full "
          f"forward: max |diff| bf16 {gaps[cfg.compute_dtype]:.4e} (rtol "
          f"{LM_DECODE_RTOL}, atol {LM_DECODE_ATOL}), fp32 compute "
          f"{gaps['float32']:.4e} (tol {FAMILY_FP32_TOL}); logits up to "
          f"{full.abs().max().item():.3f}")
    phase("lm-families", f"{cfg.name} times ({smi}): encode "
          f"{WHISPER_FRAMES} frames {encode_ms:.3f} ms; decode a step at 1 "
          f"slot {decode_ms:.3f} ms ({1e3 / decode_ms:.1f} tok/s), device "
          f"{prof['device_us'] / 1e3:.3f} ms in {prof['kernels']:.0f} "
          f"kernels + {prof['memsets']:.0f} memsets; bound: the decoder's "
          f"bf16 weights read once {dec_bytes / PEAK_BYTES_PER_S * 1e3:.3f}"
          f" ms ({dec_bytes / 1e9:.2f} GB); peak {peak_gb:.2f} GB; "
          f"{time.perf_counter() - t0:.1f}s")


def lm_families_phase(torch, smi) -> dict:
    """granite-moe-3b-a800m, rwkv6-3b and zamba2-1.2b behind ServeEngine
    (full width, FAMILY_LAYERS layers) and whisper-medium through prefill
    / decode_step (full width and depth), one model on the card at a
    time; then the lm_serve twin at
    `--arch rwkv6-3b-smoke`.  None of these families reaches a kernel of
    the port: every kernel's launches must stay 0 (returned by name)."""
    from repro_torch.orchestration import lm_serve
    t0 = time.perf_counter()
    zero_launches()
    for arch in FAMILY_ARCHS:
        family_serve(torch, smi, arch)
    whisper_serve(torch, smi)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = lm_serve.main(["--arch", "rwkv6-3b-smoke"])
    for line in out.getvalue().splitlines():
        phase("lm-families", f"twin: {line}")
    if rc != 0:
        fail(f"lm-families: lm_serve.main(['--arch', 'rwkv6-3b-smoke']) "
             f"returned {rc}")
    launches = read_launches()
    if any(launches.values()):
        fail(f"lm-families: a kernel of the port was launched: {launches} "
             "(no family here reaches one)")
    phase("lm-families", f"kernel launches {launches} (none on this path, "
          f"flash included, as in the reference); phase "
          f"{time.perf_counter() - t0:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# LM training: every family on the card against the CPU, the full-width
# checks, qwen1.5-4b trained at full depth, the train twin
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1.5-4b"
TRAIN_MOE_ARCH = "granite-moe-3b-a800m"
TRAIN_LR = 1e-3                 # tests/test_arch_smoke.py's AdamW
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ = 2, 64
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL = 1e-6, 1e-4   # |d| <= atol + rtol |g|
TRAIN_GRAD_MAX_MISSES = 2   # elements of a leaf past that, held by float64
TRAIN_REMAT_RTOL = 1e-6         # a leaf's largest |d| / its largest |g|
TRAIN_CHECK_LAYERS = 4
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 512
TRAIN_FULL_BATCH, TRAIN_FULL_SEQ = 1, 2048
TRAIN_FULL_STEPS = 6
TRAIN_TWIN_ARGS = ["--arch", "qwen1.5-4b-smoke", "--batch", "2", "--seq",
                   "32", "--ckpt-every", "3", "--log-every", "1"]


def train_config(arch: str):
    """The config [lm-train] trains `arch` at (full width; its CPU
    rehearsal sets `-smoke` configs here)."""
    from repro_torch.models.registry import get_config
    return get_config(arch)


def train_smoke_batch(cfg) -> dict:
    """tests/test_arch_smoke.py's `make_batch` (numpy, seeded)."""
    rng = np.random.default_rng(SEED)
    b, s = TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["audio_embeds"] = rng.normal(
            size=(b, s, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def on(torch, batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_grads(model) -> dict:
    return {k: p.grad.detach() for k, p in model.named_parameters()}


def train_float64_grads(torch, model, batch) -> dict:
    """The gradient of the same loss in float64 on the CPU (the judge of
    a gradient element that misses the rule)."""
    import copy
    import dataclasses
    from repro_torch.train.train_loop import make_loss_fn
    m64 = copy.deepcopy(model).to("cpu").double()
    m64.cfg = dataclasses.replace(model.cfg, compute_dtype="float64")
    b64 = {k: v.to("cpu").double() if v.is_floating_point() else v.to("cpu")
           for k, v in batch.items()}
    for p in m64.parameters():
        p.grad = None
    make_loss_fn(m64, m64.cfg)(b64)[0].backward()
    return train_grads(m64)


def train_grad_check(torch, name, got, want, judge) -> tuple:
    """Step-1 gradients, element by element: |d| <= 1e-6 + 1e-4 |g|.
    An element that misses must be no further from the float64 gradient
    (``judge()``) than the CPU's own error plus the rule (fp32 sums in
    another order over entries that cancel), and a leaf may hold at most
    TRAIN_GRAD_MAX_MISSES such elements.  Returns (the largest |d|
    over every leaf, the misses the float64 gradient accepted)."""
    worst, misses, g64 = 0.0, 0, None
    for k, w in want.items():
        g = got[k].to("cpu", torch.float32)
        w = w.to("cpu", torch.float32)
        d = (g - w).abs()
        worst = max(worst, float(d.max()))
        bad = d > TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * w.abs()
        if not bool(bad.any()):
            continue
        if g64 is None:
            g64 = judge()
        t = g64[k]
        ok = ((g.double() - t).abs() <= TRAIN_GRAD_ATOL
              + TRAIN_GRAD_RTOL * t.abs() + (w.double() - t).abs())
        if not bool(ok[bad].all()):
            fail(f"lm-train: {name} gradient {k}: "
                 f"{int((bad & ~ok).sum())} elements off the CPU's by more "
                 f"than 1e-6 + 1e-4 |g| and further from float64 than it")
        if int(bad.sum()) > TRAIN_GRAD_MAX_MISSES:
            fail(f"lm-train: {name} gradient {k}: {int(bad.sum())} elements "
                 f"off the CPU's by more than 1e-6 + 1e-4 |g| (at most "
                 f"{TRAIN_GRAD_MAX_MISSES} a leaf)")
        misses += int(bad.sum())
    return worst, misses


def train_pair(torch, arch: str):
    """(cfg, the model on the card, the same on the CPU) at the smoke
    config, drawn once on the CPU from SEED."""
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.nn.layers import init_params
    cfg = get_config(arch + "-smoke")
    cpu = init_params(build_model(cfg, "cpu"), SEED)
    card = build_model(cfg, DEVICE)
    card.load_state_dict(cpu.state_dict())
    return cfg, card, cpu


def train_one_step(torch, model, cfg, opt, batch, **kw) -> dict:
    from repro_torch.nn.layers import stack_groups
    from repro_torch.train.train_loop import make_train_step
    params = dict(model.named_parameters())
    step = make_train_step(model, cfg, opt, **kw)
    _, state, metrics = step(params, opt.init(params, stack_groups(params)),
                             batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": state}


def train_smoke_arch(torch, arch: str) -> str:
    """(a) one train step of `arch`'s smoke model on the card and on the
    CPU from the same state and batch (AdamW(1e-3)): the loss at rtol
    1e-5, the step-1 gradients by the rule."""
    from repro_torch.train.optimizer import AdamW
    cfg, card, cpu = train_pair(torch, arch)
    b = train_smoke_batch(cfg)
    got = train_one_step(torch, card, cfg, AdamW(learning_rate=TRAIN_LR),
                         on(torch, b, DEVICE))["metrics"]
    want = train_one_step(torch, cpu, cfg, AdamW(learning_rate=TRAIN_LR),
                          on(torch, b, "cpu"))["metrics"]
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    if not (np.isfinite(got["loss"]) and rel <= TRAIN_LOSS_RTOL):
        fail(f"lm-train: {arch} loss on the card {got['loss']!r} vs the "
             f"CPU's {want['loss']!r} (rtol {TRAIN_LOSS_RTOL})")
    fresh = train_pair(torch, arch)[2]
    worst, misses = train_grad_check(
        torch, arch, train_grads(card), train_grads(cpu),
        lambda: train_float64_grads(torch, fresh, on(torch, b, "cpu")))
    extra = "".join(f", {k} {got[k]:.4e}" for k in ("moe_lb_loss",
                                                    "moe_z_loss")
                    if cfg.moe is not None)
    return (f"{arch}: loss {got['loss']:.6f} (CPU {want['loss']:.6f}, rel "
            f"{rel:.2e}){extra}; gradients max |d| {worst:.3e}"
            + (f", {misses} elements past the rule held by float64"
               if misses else ""))


def train_smoke_adafactor(torch) -> str:
    """(a) command-r-plus-104b-smoke with Adafactor: the step on both
    devices (loss), then the update on identical gradients (the CPU's,
    from the same initial state): new parameters at rtol 1e-5."""
    from repro_torch.nn.layers import stack_groups
    from repro_torch.train.optimizer import Adafactor
    arch = "command-r-plus-104b"
    cfg, card, cpu = train_pair(torch, arch)
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    b = train_smoke_batch(cfg)
    got = train_one_step(torch, card, cfg, Adafactor(learning_rate=TRAIN_LR),
                         on(torch, b, DEVICE))["metrics"]
    want = train_one_step(torch, cpu, cfg, Adafactor(learning_rate=TRAIN_LR),
                          on(torch, b, "cpu"))["metrics"]
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    if rel > TRAIN_LOSS_RTOL:
        fail(f"lm-train: {arch} (Adafactor) loss {got['loss']!r} vs "
             f"{want['loss']!r}")
    card.load_state_dict(start)
    opt = Adafactor(learning_rate=TRAIN_LR)
    params = dict(card.named_parameters())
    grads = {k: p.grad.to(DEVICE) for k, p in cpu.named_parameters()}
    groups = stack_groups(params)
    opt.update_(grads, opt.init(params, groups), params, groups=groups)
    gap = 0.0
    for (k, p), q in zip(card.named_parameters(), cpu.parameters()):
        p, q = p.detach().cpu(), q.detach()
        gap = max(gap, float((p - q).abs().max()))
        if not torch.allclose(p, q, rtol=TRAIN_LOSS_RTOL, atol=1e-7):
            fail(f"lm-train: {arch} Adafactor on the card vs the CPU on "
                 f"identical gradients: {k} differs by "
                 f"{float((p - q).abs().max()):.3e} (rtol 1e-5, atol 1e-7)")
    return (f"{arch} + Adafactor: loss {got['loss']:.6f} (rel {rel:.2e}); "
            f"on identical gradients the card's new parameters within "
            f"{gap:.2e} of the CPU's (rtol 1e-5, atol 1e-7)")


def train_smoke_compressed(torch) -> str:
    """(a) qwen1.5-4b-smoke with ErrorFeedbackCompressor: the step on
    both devices (loss), then the compressor on identical gradients (the
    CPU's step-1 gradients): int8 codes, scales and residuals equal."""
    from repro_torch.distributed.compression import (ErrorFeedbackCompressor,
                                                     quantize_int8)
    from repro_torch.train.optimizer import AdamW
    arch = "qwen1.5-4b"
    cfg, card, cpu = train_pair(torch, arch)
    b = train_smoke_batch(cfg)
    comp = ErrorFeedbackCompressor()
    out = {}
    for name, model, dev in (("card", card, DEVICE), ("cpu", cpu, "cpu")):
        params = dict(model.named_parameters())
        bound = comp.bind(comp.init(params))
        out[name] = train_one_step(torch, model, cfg,
                                   AdamW(learning_rate=TRAIN_LR),
                                   on(torch, b, dev),
                                   grad_compression=bound)["metrics"]
        out[name + "_residual"] = bound.state.residual
    rel = abs(out["card"]["loss"] - out["cpu"]["loss"]) / abs(
        out["cpu"]["loss"])
    if rel > TRAIN_LOSS_RTOL:
        fail(f"lm-train: {arch} (compressed) loss {out['card']['loss']!r} "
             f"vs {out['cpu']['loss']!r}")
    n_codes, differ = 0, 0
    for k, p in cpu.named_parameters():
        g = p.grad.to(torch.float32)
        q_cpu, s_cpu = quantize_int8(g)
        q_card, s_card = quantize_int8(g.to(DEVICE))
        n_codes += q_cpu.numel()
        if not (torch.equal(q_card.cpu(), q_cpu)
                and float(s_card) == float(s_cpu)):
            fail(f"lm-train: {arch} int8 codes of {k} on the card differ "
                 "from the CPU's on identical gradients")
        # the codes of each device's own step (gradients within the rule)
        own = quantize_int8(card.get_parameter(k).grad.to(torch.float32))[0]
        differ += int((own.cpu() != q_cpu).sum())
    return (f"{arch} + ErrorFeedbackCompressor: loss "
            f"{out['card']['loss']:.6f} (rel {rel:.2e}); int8 codes and "
            f"scales equal on identical gradients ({n_codes} codes); on "
            f"each device's own gradients {differ} codes differ by a "
            "rounding step")


def train_full_width_model(torch, arch: str, layers: int, **over):
    """`arch` at full width with `layers` layers, fp32 weights drawn on
    the card from SEED, `over` replacing config fields."""
    import dataclasses
    from repro_torch.models.registry import build_model
    from repro_torch.nn.layers import init_params
    cfg = dataclasses.replace(train_config(arch), num_layers=layers, **over)
    with torch.no_grad():
        model = init_params(build_model(cfg, DEVICE), SEED)
    return cfg, model


def train_check_batch(torch, cfg, batch: int, seq: int, steps: int = 1):
    from repro_torch.data.synthetic import token_batches
    return [on(torch, b, DEVICE) for b in token_batches(
        batch=batch, seq=seq, vocab=cfg.vocab_size, steps=steps, seed=1)]


def train_loss_grads(torch, model, cfg, batch) -> tuple:
    """(metrics, gradients) of one forward and backward, the parameters
    left as they are."""
    from repro_torch.train.train_loop import make_loss_fn
    for p in model.parameters():
        p.grad = None
    total, metrics = make_loss_fn(model, cfg)(batch)
    total.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {k: g.clone() for k, g in train_grads(model).items()})


def train_remat_gap(torch, name, a, b) -> float:
    """The largest over leaves of max |d| / max |g|; fails past 1e-6."""
    gap = 0.0
    for k in b:
        scale = float(b[k].abs().max())
        if scale > 0:
            gap = max(gap, float((a[k] - b[k]).abs().max()) / scale)
    if gap > TRAIN_REMAT_RTOL:
        fail(f"lm-train: {name}: gradients differ by {gap:.3e} of a leaf's "
             f"largest entry ({TRAIN_REMAT_RTOL})")
    return gap


def train_remat_check(torch, arch: str, remat: str) -> str:
    """(b) `remat` against "none" at full width, 4 layers, fp32 compute:
    the loss and gradients bit for bit, or within 1e-6 relative."""
    import dataclasses
    cfg, model = train_full_width_model(torch, arch, TRAIN_CHECK_LAYERS,
                                        compute_dtype="float32", remat=remat)
    [batch] = train_check_batch(torch, cfg, TRAIN_CHECK_BATCH,
                                TRAIN_CHECK_SEQ)
    m_r, g_r = train_loss_grads(torch, model, cfg, batch)
    model.cfg = dataclasses.replace(cfg, remat="none")
    m_n, g_n = train_loss_grads(torch, model, model.cfg, batch)
    same = m_r["loss"] == m_n["loss"] and all(
        torch.equal(g_r[k], g_n[k]) for k in g_n)
    gap = 0.0 if same else train_remat_gap(torch, f"{arch} {remat}", g_r,
                                           g_n)
    if not same and abs(m_r["loss"] - m_n["loss"]) > TRAIN_REMAT_RTOL * abs(
            m_n["loss"]):
        fail(f"lm-train: {arch} remat {remat} loss {m_r['loss']!r} vs "
             f"{m_n['loss']!r}")
    extra = "".join(f", {k} {m_r[k]:.6e}" for k in ("moe_lb_loss",
                                                    "moe_z_loss",
                                                    "moe_drop_fraction")
                    if cfg.moe is not None)
    del model, g_r, g_n
    torch.cuda.empty_cache()
    return (f"{arch} at full width, {TRAIN_CHECK_LAYERS} layers, fp32: "
            f"remat {remat!r} vs 'none' "
            + ("bit for bit" if same else
               f"loss {m_r['loss']!r} vs {m_n['loss']!r}, gradients within "
               f"{gap:.3e} of a leaf's largest")
            + f" (loss {m_r['loss']:.6f}{extra})")


def train_micro_and_update_check(torch) -> str:
    """(b) qwen1.5-4b at full width, 4 layers, fp32: `make_train_step`
    with n_microbatches=2 against 1 (losses rtol 1e-5, gradients by the
    rule) from the same state; then the in-place sliced AdamW against
    the functional one on the same gradients, twice: parameters and
    moments bit for bit."""
    from repro_torch.train.optimizer import CHUNKED_UPDATE_THRESHOLD, AdamW
    from repro_torch.train.train_loop import make_train_step
    cfg, model = train_full_width_model(torch, TRAIN_ARCH,
                                        TRAIN_CHECK_LAYERS,
                                        compute_dtype="float32")
    [batch] = train_check_batch(torch, cfg, TRAIN_CHECK_BATCH,
                                TRAIN_CHECK_SEQ)
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = AdamW(learning_rate=TRAIN_LR)
    runs = {}
    for n in (1, 2):
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(start[k])
        step = make_train_step(model, cfg, opt, n_microbatches=n)
        _, _, metrics = step(params, opt.init(params), batch)
        runs[n] = (float(metrics["loss"]),
                   {k: g.clone() for k, g in train_grads(model).items()})
    rel = abs(runs[2][0] - runs[1][0]) / abs(runs[1][0])
    if rel > TRAIN_LOSS_RTOL:
        fail(f"lm-train: n_microbatches=2 loss {runs[2][0]!r} vs 1's "
             f"{runs[1][0]!r}")
    worst, _ = train_grad_check(
        torch, "n_microbatches=2", runs[2][1], runs[1][1],
        lambda: fail("lm-train: n_microbatches=2 gradients miss the rule "
                     "against n=1 (no float64 judge at full width)"))
    del runs[2]
    # the in-place, sliced update against the functional one
    grads = runs[1][1]
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(start[k])
    plain_p = {k: v.clone() for k, v in start.items()}
    state, plain_s = opt.init(params), opt.init(plain_p)
    sliced = [k for k, p in params.items()
              if p.numel() > CHUNKED_UPDATE_THRESHOLD]
    for _ in range(2):
        _, state, _ = opt.update_(grads, state, params)
        plain_p, plain_s, _ = opt.update(grads, plain_s, plain_p)
    for k, p in params.items():
        for name, a, b in (("parameter", p.detach(), plain_p[k]),
                           ("m", state.m[k], plain_s.m[k]),
                           ("v", state.v[k], plain_s.v[k])):
            if not torch.equal(a, b):
                fail(f"lm-train: in-place AdamW {name} of {k} differs from "
                     f"the functional update by "
                     f"{float((a - b).abs().max()):.3e}")
    n = sum(p.numel() for p in params.values())
    del model, params, start, plain_p, plain_s, state, grads, runs
    torch.cuda.empty_cache()
    return (f"{TRAIN_ARCH} at full width, {TRAIN_CHECK_LAYERS} layers "
            f"({n} parameters), fp32, batch {TRAIN_CHECK_BATCH} x "
            f"{TRAIN_CHECK_SEQ}: n_microbatches=2 vs 1 loss rel {rel:.2e}, "
            f"gradients max |d| {worst:.3e}; in-place AdamW "
            f"({len(sliced)} leaves in row slices: "
            f"{', '.join(sliced)}) equal to the functional update bit for "
            "bit, parameters and moments, over 2 updates")


def train_flops_bound(cfg, n_params: int, n_gather: int, batch: int,
                      seq: int) -> dict:
    """The step's bound, its phases in sequence: 6 N T for the forward
    and backward plus 2 N T for the remat forward at 989 TFLOP/s (bf16),
    N without the `n_gather` elements of an untied embedding table,
    which is read by a gather and enters no product; the causal
    attention's QK and PV products, which the reference takes in fp32,
    4 x 2 S^2 D H L B for the forward, remat forward and backward at 67
    TFLOP/s (fp32, TF32 off); the AdamW update's bytes (read p, g, m, v;
    write p, m, v, all fp32) and three fp32 -> bf16 casts of every
    weight a step, the table's included (forward, recompute, backward:
    read 4 bytes, write 2) at 3.35 TB/s."""
    tokens = batch * seq
    remat = 2 if cfg.remat == "layer" else 0
    flops = (6 + remat) * (n_params - n_gather) * tokens
    attn = ((4 if remat else 3) * 2 * seq * seq * cfg.resolved_head_dim
            * cfg.n_heads * cfg.num_layers * batch)
    adam = n_params * 4 * (4 + 3)
    casts = (3 if remat else 2) * n_params * (4 + 2)
    out = {"matmul_ms": flops / PEAK_BF16_FLOPS * 1e3,
           "attn_ms": attn / PEAK_FP32_FLOPS * 1e3,
           "adamw_ms": adam / PEAK_BYTES_PER_S * 1e3,
           "casts_ms": casts / PEAK_BYTES_PER_S * 1e3,
           "flops": flops, "attn_flops": attn, "adam_bytes": adam,
           "cast_bytes": casts}
    out["bound_ms"] = (out["matmul_ms"] + out["attn_ms"] + out["adamw_ms"]
                       + out["casts_ms"])
    return out


def train_roofline_line(cfg, bound: dict, step_ms: float) -> str:
    """`repro_torch.launch.roofline.analyze` of (c)'s step (one card, no
    collectives) beside `train_flops_bound`: the roofline takes the
    reference's analytic FLOPs (2 N T a pass, 4 passes under remat
    "layer", the causal attention's quadratic term at bf16 rate) and its
    HBM bytes (weights 3 passes a microbatch, activations, the optimizer
    state read and written once); the bound takes its phases in
    sequence, the attention at the fp32 rate, the AdamW update's bytes
    and the weight casts."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline
    shape = ShapeConfig("lm-train (c)", TRAIN_FULL_SEQ, TRAIN_FULL_BATCH,
                        "train")
    row = roofline.analyze({"arch": TRAIN_ARCH, "shape": shape.name,
                            "mesh": "1", "n_chips": 1, "n_microbatches": 1,
                            "collectives": {"per_axis": {}}}, shape=shape)
    return (f"roofline.analyze: compute {row.compute_s * 1e3:.1f} ms "
            f"({row.compiled_flops / 1e12:.1f} TFLOP at 989 TFLOP/s), memory "
            f"{row.memory_s * 1e3:.1f} ms at 3.35 TB/s, collective 0, bound "
            f"by {row.bottleneck}, MFU at the median step "
            f"{row.model_flops / 989e12 / (step_ms / 1e3) * 100:.1f}%; "
            f"beside train_flops_bound {bound['bound_ms']:.1f} ms "
            f"({cfg.name})")


def train_full_run(torch, smi, figures: dict) -> str:
    """(c) qwen1.5-4b at full width and depth (3.95 B fp32 parameters
    drawn on the card, bf16 compute, remat "layer", pick_optimizer's
    AdamW), TRAIN_FULL_STEPS steps of batch 1 x 2048 from
    token_batches(seed=1) through make_train_step: peak memory, every
    step's loss and grad_norm (finite), the median step of steps 2-6,
    tokens/s, one step and one optimizer update under torch.profiler,
    and the bound; then one step at batch 2 with n_microbatches=2, whose
    peak may exceed the 1-batch run's by at most that run's activations
    (its peak over the memory held between steps) and the fp32
    whole-leaf gradients of the embedding table and the head: no second
    gradient buffer.  Its peak goes into ``figures["lm-train"]`` for
    `[dryrun]` (a)."""
    from repro_torch.launch.specs import pick_optimizer
    from repro_torch.models.registry import build_model
    from repro_torch.nn.layers import init_params, stack_groups
    from repro_torch.train.train_loop import make_train_step
    cfg = train_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        model = init_params(build_model(cfg, DEVICE), SEED)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    opt = pick_optimizer(cfg)
    state = opt.init(params, stack_groups(params))
    step = make_train_step(model, cfg, opt)
    batches = train_check_batch(torch, cfg, TRAIN_FULL_BATCH, TRAIN_FULL_SEQ,
                                TRAIN_FULL_STEPS)
    losses, norms, step_ms = [], [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, metrics = step(params, state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    static = torch.cuda.memory_allocated()
    figures["lm-train"] = {"peak": peak}
    reserved = torch.cuda.max_memory_reserved()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    if not all(np.isfinite(losses + norms)):
        fail(f"lm-train: {cfg.name} losses {losses}, grad norms {norms}")
    med = statistics.median(step_ms[1:])
    tokens = TRAIN_FULL_BATCH * TRAIN_FULL_SEQ
    prof = device_per_call(torch, lambda: step(params, state, batches[-1]),
                           calls=1)
    grads = train_grads(model)
    upd = device_per_call(torch, lambda: opt.update_(grads, state, params),
                          calls=1)
    upd_ms = time_ms(torch, lambda: opt.update_(grads, state, params),
                     calls=1, reps=3, warmup=1)
    del grads
    n_gather = 0 if cfg.tie_embeddings else params["embed.table"].numel()
    bound = train_flops_bound(cfg, n_params, n_gather, TRAIN_FULL_BATCH,
                              TRAIN_FULL_SEQ)
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:6]
    phase("lm-train", f"(c) {cfg.name} at full width and depth ({smi}): "
          f"{cfg.num_layers} layers, {n_params} fp32 parameters drawn on "
          f"the card in {t_build:.1f}s, {cfg.compute_dtype} compute, remat "
          f"{cfg.remat!r}, {type(opt).__name__} (moments "
          f"{str(opt.moment_dtype).split('.')[-1]}), batch "
          f"{TRAIN_FULL_BATCH} x {TRAIN_FULL_SEQ}: losses "
          f"{[round(x, 4) for x in losses]}, grad_norm "
          f"{[round(x, 4) for x in norms]}; step ms "
          f"{[round(x, 3) for x in step_ms]}, median of steps 2-"
          f"{TRAIN_FULL_STEPS} {med:.3f} ms ({tokens / med * 1e3:.1f} "
          f"tokens/s); peak {peak / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated), {static / 1e9:.2f} GB held "
          f"between steps, {reserved / 1e9:.2f} GB reserved at most, "
          f"{retries} allocation retries (cache flushed and retried)")
    phase("lm-train", f"(c) one step under torch.profiler: device "
          f"{prof['device_us'] / 1e3:.3f} ms in {prof['kernels']:.0f} "
          f"kernels + {prof['memsets']:.0f} memsets, top "
          + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in top)
          + f"; the optimizer update alone {upd_ms:.3f} ms, device "
          f"{upd['device_us'] / 1e3:.3f} ms in {upd['kernels']:.0f} "
          f"kernels ({100 * upd['device_us'] / prof['device_us']:.1f}% of "
          f"the step's device time); bound {bound['bound_ms']:.1f} ms = "
          f"matmuls {bound['flops'] / 1e12:.1f} TFLOP (the "
          f"{n_gather} elements of the gathered table left out) "
          f"{bound['matmul_ms']:.1f} ms + fp32 causal attention "
          f"{bound['attn_flops'] / 1e12:.2f} TFLOP {bound['attn_ms']:.1f} "
          f"ms + AdamW "
          f"{bound['adam_bytes'] / 1e9:.1f} GB {bound['adamw_ms']:.1f} ms"
          f" + weight casts {bound['cast_bytes'] / 1e9:.1f} GB "
          f"{bound['casts_ms']:.1f} ms ({bound['bound_ms'] / med * 100:.1f}"
          f"% of the median step)")
    phase("lm-train", f"(c) {train_roofline_line(cfg, bound, med)}")
    # one step at batch 2 in two microbatches of the run's size: its
    # peak may pass (c)'s by (c)'s activations (the second microbatch's)
    # and the whole-leaf gradients of the embedding table and the head,
    # which the second backward makes before adding them into `.grad`;
    # a second gradient buffer would be the gradients' whole size
    activations = peak - static
    whole_leaves = [k for k in ("embed.table", "lm_head.w") if k in params]
    leaf_bytes = sum(params[k].numel() * 4 for k in whole_leaves)
    allowance = activations + leaf_bytes
    grad_bytes = sum(p.grad.numel() * p.grad.element_size()
                     for p in params.values())
    if allowance >= grad_bytes:
        fail(f"lm-train: the microbatched step's allowance "
             f"{allowance / 1e9:.2f} GB cannot tell a second gradient "
             f"buffer ({grad_bytes / 1e9:.2f} GB)")
    micro_step = make_train_step(model, cfg, opt, n_microbatches=2)
    [batch2] = train_check_batch(torch, cfg, 2 * TRAIN_FULL_BATCH,
                                 TRAIN_FULL_SEQ)
    torch.cuda.reset_peak_memory_stats()
    _, state, metrics2 = micro_step(params, state, batch2)
    loss2 = float(metrics2["loss"])
    peak2 = torch.cuda.max_memory_allocated()
    if not np.isfinite(loss2) or peak2 > peak + allowance:
        fail(f"lm-train: n_microbatches=2 at batch 2: loss {loss2}, peak "
             f"{peak2 / 1e9:.2f} GB above the 1-batch run's "
             f"{peak / 1e9:.2f} GB + {activations / 1e9:.2f} GB of its "
             f"activations + {leaf_bytes / 1e9:.2f} GB of whole-leaf "
             f"gradients ({', '.join(whole_leaves)})")
    del model, params, state, step, micro_step, batches, batch2
    torch.cuda.empty_cache()
    return (f"n_microbatches=2 at batch {2 * TRAIN_FULL_BATCH}: loss "
            f"{loss2:.4f}, peak {peak2 / 1e9:.2f} GB (the 1-batch run's "
            f"{peak / 1e9:.2f} GB + {(peak2 - peak) / 1e9:.2f}) against "
            f"{(peak + allowance) / 1e9:.2f} GB = that peak + "
            f"{activations / 1e9:.2f} GB of its activations + "
            f"{leaf_bytes / 1e9:.2f} GB of the whole-leaf gradients of "
            f"{', '.join(whole_leaves)} (fp32, from their shapes); a "
            f"second gradient buffer would be {grad_bytes / 1e9:.2f} GB "
            f"more")


def train_twin(argv: list) -> tuple:
    """`repro_torch.launch.train.main(argv)` with its stdout captured and
    each step's loss read from its train step: (rc, losses, lines)."""
    from repro_torch.launch import train as twin
    losses = []
    make = twin.make_train_step

    def spying(*a, **kw):
        step = make(*a, **kw)

        def wrapped(params, opt_state, batch):
            out = step(params, opt_state, batch)
            losses.append(float(out[2]["loss"]))
            return out
        return wrapped

    out = io.StringIO()
    twin.make_train_step = spying
    try:
        with contextlib.redirect_stdout(out):
            rc = twin.main(argv)
    finally:
        twin.make_train_step = make
    return rc, losses, out.getvalue().splitlines()


def train_twin_check(torch) -> str:
    """(d) the train twin: 6 steps checkpointing every 3, restarted with
    --steps 8 on the same directory (it must restore at step >= 3), and
    an uninterrupted 8-step run: steps 7-8 equal exactly."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="lm_train_twin_") as tmp:
        ck = os.path.join(tmp, "ck")
        rc1, first, out1 = train_twin(TRAIN_TWIN_ARGS + [
            "--steps", "6", "--ckpt-dir", ck])
        rc2, second, out2 = train_twin(TRAIN_TWIN_ARGS + [
            "--steps", "8", "--ckpt-dir", ck])
        rc3, whole, _ = train_twin(TRAIN_TWIN_ARGS + [
            "--steps", "8", "--ckpt-dir", os.path.join(tmp, "whole")])
    for line in out1 + out2:
        phase("lm-train", f"twin: {line}")
    restored = [int(line.split()[-1]) for line in out2
                if line.startswith("restored checkpoint at step")]
    if (rc1, rc2, rc3) != (0, 0, 0) or not restored or restored[0] < 3:
        fail(f"lm-train: twin exits {rc1}, {rc2}, {rc3}; restored at "
             f"{restored}")
    resumed = whole[restored[0]:]
    if second != resumed or not out2[-1].endswith("at step 8"):
        fail(f"lm-train: resumed losses {second} != uninterrupted "
             f"{resumed}")
    return (f"twin: 6 steps, restart at step {restored[0]}, steps "
            f"{restored[0] + 1}-8 losses {second} equal to the uninterrupted"
            f" run's exactly; first run {[round(x, 4) for x in first]}")


def train_part(torch, name: str, fn, *args) -> str:
    """Run one part with every kernel's launch count set to 0 just before
    and read just after; every count must stay 0."""
    zero_launches()
    line = fn(torch, *args)
    launches = read_launches()
    if any(launches.values()):
        fail(f"lm-train: {name}: a kernel of the port was launched: "
             f"{launches} (LM training reaches none)")
    return line


def lm_train_phase(torch, smi, figures: dict) -> dict:
    """LM training on the card, one model at a time: (a) all 10 arch ids
    at smoke size, card against CPU, with AdamW, then Adafactor and the
    int8 error-feedback compressor; (b) remat and microbatches at full
    width and 4 layers against their plain counterparts, and the
    in-place AdamW against the functional one; (c) qwen1.5-4b trained at
    full width and depth; (d) the train twin's exact resume.  No kernel
    of the port is on these paths (the reference's LM training reaches
    no Pallas kernel): every launch count must stay 0 in every part."""
    import gc
    from repro_torch.models.registry import ARCH_IDS
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase("lm-train", f"start: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          "held by the earlier phases")
    for name, fn, args in (
            [(f"(a) {a}", train_smoke_arch, (a,)) for a in ARCH_IDS]
            + [("(a) Adafactor", train_smoke_adafactor, ()),
               ("(a) compressor", train_smoke_compressed, ())]):
        phase("lm-train", f"(a) {train_part(torch, name, fn, *args)}")
    phase("lm-train", f"(a) all {len(ARCH_IDS)} families: one step on the "
          f"card equal to the CPU's (loss rtol {TRAIN_LOSS_RTOL}, step-1 "
          f"gradients |d| <= {TRAIN_GRAD_ATOL} + {TRAIN_GRAD_RTOL} |g|); "
          f"{time.perf_counter() - t0:.1f}s")
    t1 = time.perf_counter()
    for name, fn, args in (
            ("(b) remat layer", train_remat_check, (TRAIN_ARCH, "layer")),
            ("(b) microbatches", train_micro_and_update_check, ()),
            ("(b) remat dots", train_remat_check, (TRAIN_MOE_ARCH, "dots"))):
        phase("lm-train", f"(b) {train_part(torch, name, fn, *args)}")
    phase("lm-train", f"(b) {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    phase("lm-train", f"(c) {train_part(torch, '(c)', train_full_run, smi, figures)}"
          f"; {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    phase("lm-train", f"(d) {train_part(torch, '(d)', train_twin_check)}; "
          f"{time.perf_counter() - t1:.1f}s")
    launches = read_launches()
    phase("lm-train", f"kernel launches 0 in every part (none on this path, "
          f"as in the reference); phase {time.perf_counter() - t0:.1f}s")
    return launches


def lm_mesh_config(arch: str):
    """`arch` at full width, LM_MESH_LAYERS layers (whisper's encoder and
    decoder each), fp32 compute and KV cache (`[lm-mesh]` (e) and (f)
    serve it: a float8 cache would round K/V that the split ranks sum in
    another order to another step)."""
    import dataclasses
    from repro_torch.models.registry import get_config
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, num_layers=LM_MESH_LAYERS,
        enc_layers=cfg.enc_layers and LM_MESH_LAYERS,
        dec_layers=cfg.dec_layers and LM_MESH_LAYERS,
        compute_dtype="float32", kv_cache_dtype="")


def lm_mesh_audio(torch, rows: int, cfg, seed: int):
    """LM_MESH_TP_FRAMES frame embeddings for `rows` sequences (whisper's
    stubbed front end), on the card."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (rows, LM_MESH_TP_FRAMES, cfg.d_model)).astype(np.float32)).to(DEVICE)


def lm_mesh_batch(torch, cfg, seq: int = LM_MESH_SEQ,
                  rows: int = LM_MESH_BATCH) -> dict:
    """The global batch every rank is handed: tokens from the seed and a
    loss mask whose counts differ between the data halves of each of the
    two microbatches (rows 1 and 2 cut, where there are such rows); frame
    embeddings for an audio model."""
    rng = np.random.default_rng(SEED + 7)
    b, s = rows, seq
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int64)
    mask = np.ones((b, s), np.float32)
    if b > 2:
        mask[1, s // 4:] = 0.0
        mask[2, : s // 2] = 0.0
    out = {k: torch.from_numpy(v).to(DEVICE)
           for k, v in (("tokens", toks[:, :-1]), ("labels", toks[:, 1:]),
                        ("loss_mask", mask))}
    if cfg.family == "audio":
        out["audio_embeds"] = lm_mesh_audio(torch, b, cfg, SEED + 10)
    return out


def lm_mesh_compressor(kind: str | None):
    """The ``grad_compression`` of an `[lm-mesh]` (i) run (None: none)."""
    from repro_torch.distributed import compression
    if kind is None:
        return None
    if kind == "int8":
        return compression.compress_int8_stateless
    return compression.ErrorFeedbackCompressor().bind()


@contextlib.contextmanager
def lm_mesh_code_log(torch, keep_ratio: bool = False):
    """Every compression the train steps of the block make, recorded: a
    list of {leaf: (int8 codes on the host, scale, flat indices of the
    codes whose x / scale lies within LM_MESH_TIE of a half-integer,
    x / scale there)} in the gradient's leaf order, with `keep_ratio`
    the first compression's x / scale whole on the host ("ratio0"), and
    the `all_max` calls each made."""
    from repro_torch.distributed import collectives, compression
    from repro_torch.train import train_loop
    log = {"codes": [], "calls": [], "ratio0": []}
    real = (train_loop._compress, compression.quantize_int8,
            collectives.all_max)
    quant = []

    def quantize(x, amax=None):
        q, scale = real[1](x, amax)
        ratio = x / scale
        tie = (ratio - torch.floor(ratio) - 0.5).abs() < LM_MESH_TIE
        at = torch.nonzero(tie.reshape(-1))[:, 0]
        quant.append((q.cpu(), float(scale), at.cpu(),
                      ratio.reshape(-1)[at].cpu()))
        if keep_ratio and not log["codes"]:
            log["ratio0"].append(ratio.cpu())
        return q, scale

    def all_max(x, axis):
        log["calls"][-1] += 1
        return real[2](x, axis)

    def compress(fn, grads, groups, whole_max=None):
        quant.clear()
        log["calls"].append(0)
        compression.quantize_int8, collectives.all_max = quantize, all_max
        try:
            out = real[0](fn, grads, groups, whole_max)
        finally:
            compression.quantize_int8, collectives.all_max = real[1:]
        if not log["codes"]:
            log["ratio0"] = dict(zip(grads, log["ratio0"]))
        log["codes"].append(dict(zip(grads, quant)))
        return out

    train_loop._compress = compress
    try:
        yield log
    finally:
        train_loop._compress = real[0]


def lm_mesh_grad_slice(step, name: str, whole):
    """This rank's slice of a whole gradient-shaped tensor: its part over
    "model" (`ModelLayout.rank_part`), then its slice over "data" where
    the step reduce-scatters the leaf (ZeRO-1) or FSDP cut it."""
    part = step.layout.rank_part(name, whole)
    dim = step.data_dims[name]
    if dim >= 0:
        data = step.plan.data_axis
        width = part.shape[dim] // data.size
        part = part.narrow(dim, data.index * width, width)
    return part


def lm_mesh_grad_bytes(torch, step) -> int:
    """The fp32 bytes of this rank's gradient slices by the layout's
    reckoning (what an error-feedback residual holds)."""
    total = 0
    for k, shape in step.layout.full.items():
        held = lm_mesh_grad_slice(step, k, torch.empty(shape, device="meta"))
        total += held.numel() * 4
    return total


def lm_mesh_code_check(torch, step, log: dict, ref_path: str) -> dict:
    """(i) on a rank: its codes of every step against its slices of the
    one-rank run's (saved beside `ref_path`): the scales within 1e-6 +
    1e-4 |s|; the first step's differing codes each where the one
    rank's x / scale lies within LM_MESH_TIE of a tie, at most
    LM_MESH_MAX_MISSES in a leaf of up to LM_MESH_CAP_ELEMENTS, and in a
    larger one each with the two x within 1e-6 + 1e-4 |x| of each other
    (x = ratio x scale, each run's own); later steps' listed.  Returns
    {leaf: mask} of the codes that differed in any step
    (`lm_mesh_compare`'s exemption) and what it found."""
    ref = torch.load(ref_path + ".codes", mmap=True, weights_only=True)
    exempt, where, faults, largest = {}, [], [], 0
    for i, (mine, theirs) in enumerate(zip(log["codes"], ref)):
        for k, (q, scale, _, _) in mine.items():
            q_ref, s_ref, ties, tie_ratio = theirs[k]
            if not abs(scale - s_ref) <= 1e-6 + 1e-4 * abs(s_ref):
                faults.append(f"step {i + 1} {k}: scale {scale!r} vs "
                              f"{s_ref!r}")
            miss = q != lm_mesh_grad_slice(step, k, q_ref)
            n = int(miss.sum())
            if not n:
                continue
            exempt[k] = exempt[k] | miss if k in exempt else miss
            where.append(f"step {i + 1} {k}: {n} of {miss.numel()}")
            if i:
                continue
            largest = max(largest, n)
            # the one rank's x / scale at its ties (NaN elsewhere), sliced
            at = torch.full((q_ref.numel(),), float("nan"))
            at[ties] = tie_ratio
            at = lm_mesh_grad_slice(step, k, at.reshape(q_ref.shape))[miss]
            untied = int(torch.isnan(at).sum())
            x_ref = at.double() * s_ref
            x_got = log["ratio0"][k][miss].double() * scale
            apart = int(((x_got - x_ref).abs()
                         > 1e-6 + 1e-4 * x_ref.abs()).sum())
            capped = (q_ref.numel() <= LM_MESH_CAP_ELEMENTS
                      and n > LM_MESH_MAX_MISSES)
            if untied or apart or capped:
                faults.append(f"step 1 {k}: {n} of {q_ref.numel()} codes "
                              f"differ, {untied} away from a tie, {apart} "
                              "with gradients apart past the rule")
    return {"exempt": exempt, "code_where": where, "code_faults": faults,
            "code_misses": sum(int(m.sum()) for m in exempt.values()),
            "first_most": largest}


class LoggedOptimizer:
    """`opt` whose in-place update records the gradient it reads each
    step (every leaf as the rank holds it: its slices the ZeRO-1
    reduce-scatter's or FSDP's).  Alone (a one-rank run, `picks` None)
    the whole gradient goes to the host (``log["steps"]``) with the flat
    indices of each leaf's elements small that step (``log["small"]``:
    not zero and within LM_MESH_GRAD_SMALL x the mean |g| of the leaf's
    nonzero elements, found on the card; every element of a leaf of at
    most LM_MESH_CAP_ELEMENTS), and ``log["ms"]``, the host time that
    took, is taken off the step's.  On a plan, `picks` ({leaf: flat
    indices into this rank's gradient slice, int32 on the host, or None
    for the whole slice}: the elements the one-rank run kept every step,
    `lm_mesh_grad_picks`) are gathered on the card after the update, a
    leaf at a time, and copied to the host (``log["picked"]``), and at
    step 1 those of `picks1` too (what it kept of step 1 alone,
    ``log["picked1"]``): no barrier, and the card holds nothing of it
    past the update's peak; the step's time includes it."""

    def __init__(self, torch, opt):
        self.torch, self.opt, self.picks, self.picks1 = torch, opt, None, {}
        self.log = {"steps": [], "small": [], "picked": [], "picks": {},
                    "picks1": {}, "picked1": {},
                    "ms": 0.0}

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update_(self, grads, *args, **kwargs):
        torch = self.torch
        if self.picks is not None:
            out = self.opt.update_(grads, *args, **kwargs)

            def take(picks):
                return {k: grads[k].detach().reshape(-1).cpu() if idx is None
                        else grads[k].detach().reshape(-1).index_select(
                            0, idx.to(DEVICE)).cpu()
                        for k, idx in picks.items()}
            if not self.log["picked"]:
                self.log["picked1"] = take(self.picks1)
            self.log["picked"].append(take(self.picks))
            return out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.log["steps"].append({k: g.detach().to("cpu", copy=True)
                                  for k, g in grads.items()})
        found = {}
        for k, g in grads.items():
            a = g.detach().abs().reshape(-1)
            if a.numel() <= LM_MESH_CAP_ELEMENTS:
                found[k] = torch.arange(a.numel())
                continue
            nonzero = a > 0
            mean = a.sum() / nonzero.sum().clamp(min=1)
            found[k] = torch.nonzero(
                nonzero & (a <= LM_MESH_GRAD_SMALL * mean))[:, 0].cpu()
        self.log["small"].append(found)
        torch.cuda.synchronize()
        self.log["ms"] += 1e3 * (time.perf_counter() - t0)
        return self.opt.update_(grads, *args, **kwargs)


def lm_mesh_feeds(model, shapes: dict) -> dict:
    """Which elements a step-1 root feeds, per leaf, from the layer's
    layout (`lm_mesh_verdicts`): {leaf: ("row", row size)} for an
    embedding table (its row), {leaf: ("head", layer, dim, unit)} for
    the leaves of an RWKV6 time mix that `RWKV6TimeMix.split_` reads by
    head (r, k, v and g by columns, o by rows, ``bonus_u`` by its head
    dim, ``ln_x``, the decay's ``dec_b`` and ``dec_base`` by channels;
    the head of an element is its index on `dim` // `unit`); any other
    leaf is absent (an element feeds itself alone).  `shapes`: {leaf:
    whole shape}."""
    from repro_torch.nn.layers import Embedding
    from repro_torch.nn.ssm import RWKV6TimeMix
    out = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, Embedding):
            out[pre + "table"] = ("row", int(np.prod(
                shapes[pre + "table"][1:])))
        elif isinstance(mod, RWKV6TimeMix):
            hd = mod.head_dim
            for leaf, dim, unit in (
                    ("r.w", 1, hd), ("k.w", 1, hd), ("v.w", 1, hd),
                    ("g.w", 1, hd), ("o.w", 0, hd), ("bonus_u", 0, 1),
                    ("ln_x.scale", 0, hd), ("ln_x.bias", 0, hd),
                    ("dec_b", 1, hd), ("dec_base", 0, hd)):
                if pre + leaf in shapes:
                    out[pre + leaf] = ("head", name, dim, unit)
    return out


def lm_mesh_coord(whole, shape, dim: int):
    """The index on `dim` of flat indices `whole` into a leaf of
    `shape` (numpy or torch integers)."""
    stride = int(np.prod(shape[dim + 1:]))
    return (whole // stride) % shape[dim]


def lm_mesh_feed_keys(name: str, whole, shape, feeds: dict) -> list:
    """The feed key of each element at flat indices `whole` (numpy) of
    leaf `name` (`lm_mesh_feeds`): a root feeds the elements of its
    key."""
    kind = feeds.get(name)
    if kind is None:
        return [("element", name, int(w)) for w in whole]
    if kind[0] == "row":
        return [("row", name, int(r)) for r in whole // kind[1]]
    _, layer, dim, unit = kind
    return [("head", layer, int(h))
            for h in lm_mesh_coord(whole, shape, dim) // unit]


def lm_mesh_grad_store(torch, log: dict, feeds: dict) -> tuple:
    """What a one-rank run keeps of its gradients for `lm_mesh_compare`:
    ``{"all": {leaf: (idx, gradient each step [steps, n])}, "first":
    {leaf: (idx, step-1 gradient [1, n])}}``, idx the sorted flat indices
    (int32 where they fit), or None for the whole leaf; and
    (candidates, elements kept).  Every step is kept of the elements
    small at some step (`LoggedOptimizer`) and of what a step-1 root
    candidate (its own |g| in (0, LM_MESH_GRAD_ATOL] at step 1) feeds
    (`lm_mesh_feeds`: its table row, its time-mix head in every leaf of
    the layer read by head: a knock-on is judged by its later steps);
    a candidate that feeds itself alone keeps its step-1 gradient (a
    root's later steps are not held).  A compressed run ((i)) keeps
    nothing: its gradients are int8 codes times a scale, never near
    rounding, and its elements past the tolerance are where a code
    differed, held by the code rule."""
    steps = log["steps"]
    store = {"all": {}, "first": {}}
    if not steps:
        return store, (0, 0)
    first = steps[0]
    shapes = {k: tuple(g.shape) for k, g in first.items()}
    cand = {}
    for k, g in first.items():
        a = g.abs().reshape(-1)
        cand[k] = torch.nonzero((a > 0) & (a <= LM_MESH_GRAD_ATOL))[:, 0]
    heads = {}   # time-mix layer -> the heads holding a candidate
    for k, idx in cand.items():
        kind = feeds.get(k)
        if kind is not None and kind[0] == "head" and idx.numel():
            heads.setdefault(kind[1], set()).update(
                (lm_mesh_coord(idx, shapes[k], kind[2]) // kind[3]).tolist())

    def kept_at(mask, grads):
        """(idx, [len(grads), n]) of the flat `grads` at `mask`."""
        if mask.all():
            return None, torch.stack(grads)
        idx = torch.nonzero(mask)[:, 0]
        return (idx.to(torch.int32) if mask.numel() < 2 ** 31 else idx,
                torch.stack([g[idx] for g in grads]))

    kept = 0
    for k in first:
        shape = shapes[k]
        mask = torch.zeros(first[k].numel(), dtype=torch.bool)
        mask[torch.cat([s[k] for s in log["small"]])] = True
        kind = feeds.get(k)
        if kind is None:
            alone = torch.zeros_like(mask)
            alone[cand[k]] = True
            alone &= ~mask
            if alone.any():
                store["first"][k] = kept_at(alone, [first[k].reshape(-1)])
                kept += store["first"][k][1].shape[-1]
        elif kind[0] == "row" and cand[k].numel():
            rows = torch.zeros(shape[0], dtype=torch.bool)
            rows[torch.unique(cand[k] // kind[1])] = True
            mask |= rows.repeat_interleave(kind[1])
        elif kind[0] == "head" and heads.get(kind[1]):
            _, layer, dim, unit = kind
            fed = torch.isin(torch.arange(shape[dim]) // unit,
                             torch.tensor(sorted(heads[layer])))
            view = [1] * len(shape)
            view[dim] = -1
            mask |= fed.reshape(view).expand(shape).reshape(-1)
        store["all"][k] = kept_at(mask, [s[k].reshape(-1) for s in steps])
        kept += store["all"][k][1].shape[-1]
    return store, (sum(int(c.numel()) for c in cand.values()), kept)


def lm_mesh_grad_picks(torch, step, ref_path: str, opt) -> None:
    """Point `opt` (a `LoggedOptimizer` on a plan) at the elements of this
    rank's gradient slices that the one-rank run kept (its store beside
    `ref_path`, `lm_mesh_grad_store`): ``opt.picks`` (every step) and
    ``opt.picks1`` (step 1 alone), also in ``opt.log``, each {leaf:
    their flat indices into the slice, ascending, int32 on the host, or
    None for the whole slice, where the store keeps the whole leaf or at
    least half the slice}.  The store's indices mark a mask of the whole
    leaf on the card, cut as the rank holds it (`lm_mesh_slice_coords`)."""
    store = torch.load(ref_path + ".grads", mmap=True, weights_only=True)
    opt.picks, opt.picks1 = opt.log["picks"], opt.log["picks1"]
    for part, picks in (("all", opt.picks), ("first", opt.picks1)):
        for k, (idx, _) in store[part].items():
            picks[k] = None if idx is None else \
                lm_mesh_local_picks(torch, step, k, idx)


def lm_mesh_local_picks(torch, step, name: str, idx):
    """The flat indices into this rank's gradient slice of leaf `name` of
    the whole leaf's elements at `idx`, ascending, int32 on the host (None
    where they are half the slice or more: the whole slice is copied)."""
    full = step.layout.full[name]
    mask = torch.zeros(int(np.prod(full)), dtype=torch.bool, device=DEVICE)
    for lo in range(0, idx.numel(), 1 << 24):
        mask[idx[lo:lo + (1 << 24)].to(DEVICE).long()] = True
    mask = mask.reshape(full)
    for d, v in enumerate(lm_mesh_slice_coords(torch, step, name)):
        if v.numel() != full[d]:
            mask = mask.index_select(d, v.to(DEVICE))
    mask = mask.reshape(-1)
    if 2 * int(mask.sum()) >= mask.numel():
        return None
    return torch.nonzero(mask)[:, 0].to(torch.int32).cpu()


def lm_mesh_slice_coords(torch, step, name: str, data_slice: bool = True):
    """The whole leaf `name`'s coordinates, dim by dim, of what this rank
    holds of it in order: its part over "model" (`ModelLayout.rank_part`
    of an index vector: a fused leaf's pieces), then, with `data_slice`,
    its slice over "data" where the step reduce-scatters the leaf
    (ZeRO-1) or FSDP cut it (`lm_mesh_grad_slice`)."""
    full = step.layout.full[name]
    data = step.plan.data_axis
    vecs = []
    for d, n in enumerate(full):
        v = torch.arange(n)
        if d == step.model_dims[name]:
            shape = [1] * len(full)
            shape[d] = n
            v = step.layout.rank_part(name, v.reshape(shape)).reshape(-1)
        if data_slice and d == step.data_dims[name]:
            width = v.numel() // data.size
            v = v.narrow(0, data.index * width, width)
        vecs.append(v)
    return vecs


def lm_mesh_whole_index(torch, step, name: str, flat, data_slice=True):
    """Flat indices into the whole leaf `name` of the elements at `flat`
    (flat indices) of what this rank holds of it (`lm_mesh_slice_coords`:
    with `data_slice`, its gradient slice)."""
    full = step.layout.full[name]
    vecs = lm_mesh_slice_coords(torch, step, name, data_slice)
    coords, rest = [], flat.clone()
    for v in reversed(vecs):
        coords.append(rest % v.numel())
        rest = rest // v.numel()
    whole = torch.zeros_like(flat)
    for d, c in enumerate(reversed(coords)):
        whole = whole * full[d] + vecs[d][c]
    return whole


def lm_mesh_train(torch, arch: str, plan=None, ref_path=None,
                  placed: bool = False, serve: bool = False,
                  seq: int = LM_MESH_SEQ, micro: int = LM_MESH_MICRO,
                  rows: int = LM_MESH_BATCH, reckon: bool = False,
                  compressor: str | None = None,
                  lr: float = LM_MESH_LR, optimizer: str = "adamw") -> dict:
    """`arch` (`lm_mesh_config`) drawn on the card from SEED and trained
    LM_MESH_STEPS steps with `optimizer` ("adamw", or "adafactor": no
    weight decay, as the reference's default) at `lr`, on `plan`'s ranks
    (ZeRO-1; with
    `placed`, over parameters placed first by `MeshPlan.place_params_`:
    FSDP) or on this rank alone: metrics and ms a step, the bytes of
    parameters and optimizer state held, peak GB, `torch.distributed`
    calls (per op and per mesh axis too) and their host ms.  Alone, the
    final parameters are saved to `ref_path`; on a plan, this rank's
    parameters are held to that file's slices of them (rtol
    LM_MESH_RTOL, atol LM_MESH_ATOL).  With `serve`, a prefill and
    greedy decode follow (`lm_mesh_serve`), on a plan from the one-rank
    run's final weights.  `seq`: the tokens of a row; `micro`: the
    microbatches of a step; `rows`: the rows of the batch; `reckon`: the
    bytes held against the layout's reckoning without a placement
    (`lm_mesh_placement`); `compressor`: the ``grad_compression`` of (i)
    (`lm_mesh_compressor`), its codes saved beside `ref_path` alone and
    held to them on a plan (`lm_mesh_code_check`).  Each step's
    gradient is recorded (`LoggedOptimizer`): alone, the elements where
    it is small at some step, every step-1 root candidate and what each
    feeds go beside `ref_path` (`lm_mesh_grad_store`); on a plan, this
    rank's gradient at those elements, by which the parameter elements
    past the tolerance are judged (`lm_mesh_compare`)."""
    from repro_torch.distributed.partition import tree_bytes
    from repro_torch.models.registry import build_model
    from repro_torch.nn.layers import init_params, stack_groups
    from repro_torch.train.optimizer import Adafactor, AdamW
    from repro_torch.train.train_loop import make_train_step
    cfg = lm_mesh_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        model = init_params(build_model(cfg, DEVICE), SEED)
    if placed:
        plan.place_params_(model)
    opt = {"adamw": AdamW, "adafactor": Adafactor}[optimizer](
        learning_rate=lr)
    grads = {"steps": [], "small": [], "picked": [], "picks": {},
             "picks1": {}, "picked1": {}, "ms": 0.0}
    if compressor is None:   # (i) keeps nothing: see lm_mesh_grad_store
        opt = LoggedOptimizer(torch, opt)
        grads = opt.log
    comp = lm_mesh_compressor(compressor)
    step = make_train_step(model, cfg, opt, plan=plan, zero1=True,
                           n_microbatches=micro, grad_compression=comp)
    picks_s = time.perf_counter()
    if plan is not None and compressor is None:
        lm_mesh_grad_picks(torch, step, ref_path, opt)
    picks_s = time.perf_counter() - picks_s
    params = dict(model.named_parameters())
    state = (step.init_opt_state(params) if plan is not None
             else opt.init(params, stack_groups(params)))
    batch = lm_mesh_batch(torch, cfg, seq, rows)
    metrics, step_ms = [], []
    logging = (lm_mesh_code_log(torch, plan is not None)
               if comp is not None else contextlib.nullcontext())
    with collective_clock(plan.mesh if plan is not None else None) as coll, \
            logging as log:
        for _ in range(LM_MESH_STEPS):
            torch.cuda.synchronize()
            copied = grads["ms"]
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0)
                           - (grads["ms"] - copied))
            metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "step_ms": step_ms, "lr": lr,
           "optimizer": optimizer,
           "seq_cut": getattr(model, "head_seq", None) is not None,
           "calls": coll["calls"] / LM_MESH_STEPS,
           "per_op": {k: v / LM_MESH_STEPS
                      for k, v in coll["per_op"].items()},
           "per_axis": {k: v / LM_MESH_STEPS
                        for k, v in coll["per_axis"].items()},
           "coll_ms": coll["ms"] / LM_MESH_STEPS,
           "param_bytes": tree_bytes({k: p.detach()
                                      for k, p in params.items()}),
           "opt_bytes": tree_bytes(state),
           "peak": torch.cuda.max_memory_allocated(),
           "grad_log_bytes": sum(g.numel() * g.element_size()
                                 for s in grads["steps"] + grads["picked"]
                                 + [grads["picked1"]] for g in s.values()),
           "picks_s": picks_s}
    if comp is not None:
        out["all_max"] = log["calls"]
        if compressor == "int8_ef":
            out["residual_bytes"] = sum(
                r.numel() * r.element_size()
                for r in comp.state.residual.values())
            out["residual_reckoned"] = (
                lm_mesh_grad_bytes(torch, step) if plan is not None
                else sum(p.numel() * 4 for p in params.values()))
    if plan is None:
        torch.save({k: p.detach().cpu() for k, p in params.items()},
                   ref_path)
        t0 = time.perf_counter()
        store, (out["grad_candidates"], out["grad_store_elements"]) = \
            lm_mesh_grad_store(torch, grads, lm_mesh_feeds(model, {
                k: tuple(p.shape) for k, p in params.items()}))
        torch.save(store, ref_path + ".grads")
        out["grad_store"] = os.path.getsize(ref_path + ".grads")
        out["store_s"] = time.perf_counter() - t0
        del store
        if comp is not None:
            torch.save(log["codes"], ref_path + ".codes")
    else:
        exempt = None
        if comp is not None:
            found = lm_mesh_code_check(torch, step, log, ref_path)
            exempt = found.pop("exempt")
            out.update(found)
        t0 = time.perf_counter()
        out.update(lm_mesh_compare(torch, step, params, ref_path, exempt,
                                   grads, lr,
                                   lm_mesh_feeds(model, step.layout.full)))
        out["compare_s"] = time.perf_counter() - t0
        if placed or reckon:
            out.update(lm_mesh_placement(step, params))
        out["time_mix"] = {
            "cut": getattr(model.blocks[0].tm, "cut", None),
            "value_dim": getattr(model.blocks[0].tm, "value_dim", None)
        } if cfg.family == "ssm" else None
    if serve:
        if plan is not None:
            lm_mesh_load_ref(torch, step, params, ref_path)
        out["serve"] = lm_mesh_serve(torch, model, cfg, plan)
    grads["steps"].clear()
    grads["picked"].clear()
    grads["picked1"].clear()
    del model, params, state, step, batch, comp, grads, opt
    torch.cuda.empty_cache()
    return out


def lm_mesh_ref_slice(step, name: str, want):
    """This rank's slice of a whole leaf `want`: its part over "model"
    where the step split it (`ModelLayout.rank_part`: a fused leaf's
    pieces), and its slice over "data" where FSDP cut it."""
    want = step.layout.rank_part(name, want)
    dim = step.data_dims[name] if step.fsdp else -1
    if dim >= 0:
        data = step.plan.data_axis
        width = want.shape[dim] // data.size
        want = want.narrow(dim, data.index * width, width)
    return want


def lm_mesh_load_ref(torch, step, params, ref_path) -> None:
    """This rank's slices of the one-rank run's final parameters (from
    `ref_path`) written into `params`."""
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(lm_mesh_ref_slice(step, k, ref[k]).to(DEVICE))


def lm_mesh_serve(torch, model, cfg, plan=None) -> dict:
    """A prefill of LM_MESH_PROMPT tokens (the global batch's rows, this
    data rank's block of them on a plan) and LM_MESH_DECODE greedy
    decode steps, under the plan's rules (with LM_MESH_SEQ_RULES the KV
    cache is cut by sequence): the logits of every step and the tokens
    on the host, the cache bytes held (its leaves' shapes, its wkv
    state's bytes where it has one) and the whole cache's for the same
    rows, prefill ms and decode ms a step."""
    import contextlib
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.models.registry import build_model
    rng = np.random.default_rng(SEED + 8)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_MESH_BATCH, LM_MESH_PROMPT))).to(DEVICE)
    extras = ({"audio_embeds": lm_mesh_audio(torch, LM_MESH_BATCH, cfg,
                                             SEED + 11)}
              if cfg.family == "audio" else {})
    rows = (0, LM_MESH_BATCH)
    ctx = contextlib.nullcontext()
    if plan is not None:
        axis = plan.batch_axis
        tokens = collectives.split_chunk(tokens, axis, 0)
        extras = {k: collectives.split_chunk(v, axis, 0)
                  for k, v in extras.items()}
        rows = (axis.index * tokens.shape[0],
                (axis.index + 1) * tokens.shape[0])
        ctx = use_sharding(plan.mesh, plan.param_rules, plan.act_rules)
    max_len = LM_MESH_PROMPT + LM_MESH_DECODE
    logits, picked, decode_ms, gathers = [], [], [], []
    with torch.no_grad(), ctx:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collectives.seq_observers.append(gathers.append)
        try:
            out, cache = model.prefill(tokens, max_len=max_len, **extras)
        finally:
            collectives.seq_observers.remove(gathers.append)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        for _ in range(LM_MESH_DECODE):
            last = out.logits[:, -1]
            logits.append(last.cpu().numpy())
            tok = torch.argmax(last, dim=-1)[:, None]
            picked.append(tok.cpu().numpy())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, cache = model.decode_step(tok, cache)
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(out.logits[:, -1].cpu().numpy())
    # the same rows' cache on a whole model (meta tensors: no memory)
    enc = ({"enc_len": LM_MESH_TP_FRAMES} if cfg.family == "audio" else {})
    whole = build_model(cfg, "meta").init_cache(tokens.shape[0], max_len,
                                                **enc)
    first = next(v for v in vars(cache).values()
                 if isinstance(v, torch.Tensor))
    shapes = {k: tuple(v.shape) for k, v in vars(cache).items()
              if isinstance(v, torch.Tensor)}
    wkv = getattr(cache, "wkv", None)
    return {"logits": np.stack(logits, 1), "tokens": np.concatenate(picked, 1),
            "rows": rows, "cache_bytes": lm_cache_bytes(torch, cache),
            "whole_cache_bytes": lm_cache_bytes(torch, whole),
            "cut": any(getattr(cache, k, None) is not None
                       for k in ("seq", "enc_seq")),
            "cache_shape": tuple(first.shape), "cache_shapes": shapes,
            "state_bytes": (wkv.numel() * wkv.element_size()
                            if wkv is not None else 0),
            "prefill_ms": prefill_ms,
            "decode_ms": statistics.median(decode_ms),
            "prefill_gathers": len(gathers)}


def lm_cache_bytes(torch, cache) -> int:
    """The bytes of every tensor a cache holds."""
    return sum(v.numel() * v.element_size() for v in vars(cache).values()
               if isinstance(v, torch.Tensor))


def lm_mesh_compare(torch, step, params, ref_path, exempt=None,
                    grads=None, lr: float = LM_MESH_LR,
                    feeds: dict | None = None) -> dict:
    """This rank's parameters, every leaf whole as it holds it, against
    its slices of the one-rank run's (read from `ref_path` mapped, a leaf
    at a time): elements past the tolerance, the largest difference, and
    the split it checked.  On the slice whose update this rank wrote
    (`lm_mesh_grad_slice`), `exempt` ((i): {leaf: mask over the slice}
    of the codes that differed) holds those elements to LM_MESH_STEPS x
    `lr` (the run's) more, and every other element past the strict
    tolerance is judged by its gradients (`lm_mesh_readings`, this
    rank's recorded in `grads`, the `LoggedOptimizer`'s log, then
    `lm_mesh_verdicts` over the whole run, `feeds` its
    `lm_mesh_feeds`): ``misses`` counts those that fail, ``judged``
    those that pass by every step's rule, ``roots`` and ``knock_ons``
    those that pass as parted at step 1 or fed by such (``judged_leaves``
    all that pass, by leaf), ``past`` all past the tolerance.  Where
    ZeRO-1's all-gather brought the rest of a leaf from the other data
    ranks, an element there past the strict tolerance passes only where
    it equals, bit for bit, the copy of the data rank that wrote it, one
    past the strict tolerance there too (its own verdict is that rank's):
    ``mirrored`` counts those; any other is a miss (a stale or broken
    all-gather, `lm_mesh_mirror`)."""
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    store = torch.load(ref_path + ".grads", mmap=True, weights_only=True)
    worst, split, where, wide, past = 0.0, 0, [], 0, 0
    data = step.plan.data_axis
    mine, theirs, records = {}, [], []
    for k, p in params.items():
        split += step.model_dims[k] >= 0
        want = lm_mesh_ref_slice(step, k, ref[k]).to(DEVICE)
        got = p.detach()
        diff = (got - want).abs()
        strict = LM_MESH_ATOL + LM_MESH_RTOL * want.abs()
        worst = max(worst, float(diff.max()))
        dim = step.data_dims[k] if step.zero else -1
        if dim >= 0:   # ZeRO-1: this rank wrote one data slice of the leaf
            width = got.shape[dim] // data.size
            lo = data.index * width
            own = torch.zeros(got.shape[dim], dtype=torch.bool,
                              device=got.device)
            own[lo:lo + width] = True
            shape = [1] * got.dim()
            shape[dim] = -1
            out = ((diff > strict) & ~own.reshape(shape)).reshape(-1)
            if out.any():
                at = torch.nonzero(out)[:, 0]
                theirs.append((k, lm_mesh_whole_index(
                    torch, step, k, at.cpu(), data_slice=False).tolist(),
                    got.reshape(-1)[at].cpu().tolist()))
            got, want, diff, strict = (t.narrow(dim, lo, width)
                                       for t in (got, want, diff, strict))
        over = (diff > strict).reshape(-1)
        if over.any():   # what the other data ranks' copies answer to
            at = torch.nonzero(over)[:, 0]
            for w, v in zip(lm_mesh_whole_index(torch, step, k,
                                                at.cpu()).tolist(),
                            got.reshape(-1)[at].cpu().tolist()):
                mine[(k, w)] = v
        bound = strict
        if exempt is not None and k in exempt:
            mask = exempt[k].to(DEVICE)
            wide += int((diff > strict)[mask].sum())
            bound = torch.where(mask, strict + LM_MESH_STEPS * lr, strict)
        bad = diff > bound
        if not bad.any():
            continue
        past += int(bad.sum())
        records.append(lm_mesh_readings(torch, step, k, torch.nonzero(
            bad.reshape(-1))[:, 0], got, want, grads, store))
    found = lm_mesh_verdicts(records, feeds or {}, lr)
    misses = found["failed"]
    where += [f"{k}: {n} of {total}, " + "; ".join(faults)
              for k, (n, total, faults) in found["faults"].items()]
    mirrored = 0
    if step.zero and data.size > 1:
        axes = step.plan.mesh.axes
        column = axes["model"].index if "model" in axes else 0
        everyone = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(everyone, (column, mine))
        owned = {key: v for c, held in everyone if c == column
                 for key, v in held.items()}
        mirrored, faults = lm_mesh_mirror(theirs, owned)
        for k, lines in faults.items():
            misses += len(lines)
            where.append(f"{k}: {len(lines)} all-gathered from another "
                         f"data rank, " + "; ".join(lines[:4]))
    return {"misses": misses, "worst": worst, "split": split,
            "leaves": len(params), "where": where, "wide": wide,
            "past": past, "judged": found["judged"],
            "roots": found["roots"], "knock_ons": found["knock_ons"],
            "judged_leaves": found["by_leaf"], "mirrored": mirrored}


def lm_mesh_mirror(theirs: list, owned: dict) -> tuple:
    """The elements past the strict tolerance that ZeRO-1's all-gather
    brought from another data rank (`theirs`: [(leaf, whole flat
    indices, values)]) against the writing rank's copies of the elements
    it found past it (`owned`: {(leaf, whole flat index): value}): each
    passes only equal bit for bit.  Returns (how many passed, {leaf:
    the faults})."""
    mirrored, faults = 0, {}
    for k, whole, values in theirs:
        for w, v in zip(whole, values):
            if owned.get((k, w)) == v:
                mirrored += 1
                continue
            faults.setdefault(k, []).append(
                f"{k}[{w}]: {v!r}, the writing data rank's "
                + (f"{owned[(k, w)]!r}" if (k, w) in owned
                   else "within the tolerance"))
    return mirrored, faults


def lm_mesh_readings(torch, step, name: str, flat, got, want, grads,
                     store) -> dict:
    """What `lm_mesh_verdicts` reads of the elements at `flat` (flat
    indices) of this rank's slice of leaf `name`, past the strict
    tolerance: their whole flat indices and the leaf's whole shape,
    parameters (``got``, the one-rank run's ``want``), and gradients
    each step, this rank's (``mine``, recorded where the one-rank run
    kept its, `LoggedOptimizer`) and the one-rank run's (``one``,
    `store`, its `lm_mesh_grad_store`), with ``kept`` where both were
    kept (``first_only`` where only step 1 was, later steps NaN; ``why``
    says why none were)."""
    at = flat.cpu()
    whole = lm_mesh_whole_index(torch, step, name, at).numpy()
    steps = max(len(grads["picked"]) if grads is not None else 0, 1)
    n = len(whole)
    rec = {"leaf": name, "whole": whole,
           "shape": tuple(step.layout.full[name]),
           "got": got.reshape(-1)[flat].cpu().numpy().astype(np.float64),
           "want": want.reshape(-1)[flat].cpu().numpy().astype(np.float64),
           "kept": np.zeros(n, bool), "first_only": np.zeros(n, bool),
           "mine": np.full((steps, n), np.nan),
           "one": np.full((steps, n), np.nan), "why": None}
    if grads is None or not grads["picked"]:
        rec["why"] = "no gradient kept (a compressed run)"
        return rec
    local = at.numpy()

    def find(sorted_idx, keys):
        """(positions of `keys` in `sorted_idx`, found); None: every key
        at its own place."""
        if sorted_idx is None:
            return keys, np.ones(len(keys), bool)
        sorted_idx = sorted_idx.numpy()
        if not len(sorted_idx):
            return np.zeros(len(keys), np.int64), np.zeros(len(keys), bool)
        pos = np.minimum(np.searchsorted(sorted_idx, keys),
                         len(sorted_idx) - 1)
        return pos, sorted_idx[pos] == keys

    for part, picks, picked in (
            ("all", grads["picks"], [s.get(name) for s in grads["picked"]]),
            ("first", grads["picks1"], [grads["picked1"].get(name)])):
        if name not in store[part] or picked[0] is None:
            continue
        idx, values = store[part][name]
        there, mine_kept = find(picks[name], local)
        pos, one_kept = find(idx, whole)
        use = mine_kept & one_kept & ~rec["kept"]
        if not use.any():
            continue
        values = values.numpy()
        rec["mine"][:len(picked), use] = np.stack(
            [g.numpy()[there[use]] for g in picked])
        rec["one"][:len(picked), use] = values[:, pos[use]]
        rec["kept"] |= use
        if part == "first":
            rec["first_only"] |= use
    return rec


def lm_mesh_verdicts(records: list, feeds: dict, lr: float) -> dict:
    """The verdict on one rank's run of every parameter element past the
    strict tolerance, from its `lm_mesh_readings` (`records`, one a
    leaf).  An element whose gradients were not kept fails; one kept
    passes, its drift within LM_MESH_STEPS x `lr` of the strict
    tolerance, as
      * judged, where every step's two gradients are within
        LM_MESH_GRAD_ATOL + LM_MESH_GRAD_RTOL |g| of each other (g the
        one rank's);
      * a root, where its step-1 gradients are, and are both non-zero
        and within LM_MESH_GRAD_ATOL of zero: there Adam's first step
        ``g / (|g| + eps)`` may part the runs, so its later steps are
        not held;
      * a knock-on, where its step-1 gradients are within the rule and
        later ones are not, and a root of this run feeds it (the same
        key, `lm_mesh_feed_keys`: its table row, its time-mix head, or
        itself).
    Any other fails; so does one of which only the step-1 gradients were
    kept (``first_only``: a step-1 candidate that feeds itself alone)
    where it is not a root.  Returns the counts, the roots [(leaf, whole
    flat index, this rank's step-1 gradient, one rank's)], the knock-ons
    [(leaf, index)], those that passed by leaf, and {leaf: (failed,
    past, first faults)}."""
    looked, root_keys = [], set()
    for r in records:
        mine, one, kept = r["mine"], r["one"], r["kept"]
        with np.errstate(invalid="ignore"):   # steps not kept are NaN
            within = np.abs(mine - one) <= LM_MESH_GRAD_ATOL \
                + LM_MESH_GRAD_RTOL * np.abs(one)
        drift = np.abs(r["got"] - r["want"]) <= LM_MESH_ATOL \
            + LM_MESH_RTOL * np.abs(r["want"]) + LM_MESH_STEPS * lr
        near = (mine[0] != 0) & (one[0] != 0) \
            & (np.abs(mine[0]) <= LM_MESH_GRAD_ATOL) \
            & (np.abs(one[0]) <= LM_MESH_GRAD_ATOL)
        root = kept & within[0] & near & drift
        judged = kept & within.all(axis=0) & drift & ~root
        knock = kept & within[0] & ~within.all(axis=0) & drift & ~root
        keys = lm_mesh_feed_keys(r["leaf"], r["whole"], r["shape"], feeds)
        root_keys.update(keys[j] for j in np.nonzero(root)[0])
        looked.append((r, keys, within, drift, root, judged, knock))
    out = {"judged": 0, "roots": [], "knock_ons": [], "failed": 0,
           "by_leaf": {}, "faults": {}}
    for r, keys, within, drift, root, judged, knock in looked:
        name, whole = r["leaf"], r["whole"]
        fed = np.array([k in root_keys for k in keys], bool)
        ok = root | judged | (knock & fed)
        out["judged"] += int(judged.sum())
        out["roots"] += [(name, int(whole[j]), float(r["mine"][0, j]),
                          float(r["one"][0, j]))
                         for j in np.nonzero(root)[0]]
        out["knock_ons"] += [(name, int(whole[j]))
                             for j in np.nonzero(knock & fed)[0]]
        if ok.any():
            out["by_leaf"][name] = int(ok.sum())
        bad = np.nonzero(~ok)[0]
        if not len(bad):
            continue
        out["failed"] += len(bad)
        faults = []
        for j in bad[:4]:
            if not r["kept"][j]:
                why = r["why"] or ("one rank's gradient not kept (never "
                                   f"within {LM_MESH_GRAD_SMALL} x its "
                                   "leaf's mean, nor fed by a step-1 root "
                                   "candidate)")
            elif not drift[j]:
                why = f"drift past {LM_MESH_STEPS} x lr more"
            elif not within[0, j]:
                why = "step-1 gradients apart past the rule"
            elif "first_only" in r and r["first_only"][j]:
                why = ("only its step-1 gradients kept (a step-1 candidate"
                       " feeding itself alone), and not a root")
            else:
                why = "later gradients apart past the rule, no root feeding it"
            faults.append(f"{name}[{int(whole[j])}]: {float(r['got'][j])!r}"
                          f" vs {float(r['want'][j])!r}, {why}"
                          + (f"; gradients {r['mine'][:, j].tolist()} vs "
                             f"one rank's {r['one'][:, j].tolist()}"
                             if r["kept"][j] else ""))
        out["faults"][name] = (len(bad), len(whole), faults)
    return out


def lm_mesh_judged_lines(runs: list, smi: str) -> None:
    """Each run's parameter elements past the strict tolerance
    (`lm_mesh_compare`), a line a run with any: those judged by every
    step's gradients, by leaf, the roots (parted at step 1: each with
    its two step-1 gradients) and the knock-ons they feed, those
    all-gathered equal to the writing data rank's, and those that
    failed; then what was kept for it: each one-rank run's host copies
    while it ran, its step-1 root candidates and its store on disk, the
    ranks' recorded gradients: `runs` [(label, rank, its run, the
    one-rank run)]."""
    total, failed, mirrored, roots, knocks = 0, 0, 0, 0, 0
    for label, rank, run, one in runs:
        total += run["judged"]
        failed += run["misses"]
        mirrored += run["mirrored"]
        roots += len(run["roots"])
        knocks += len(run["knock_ons"])
        if run["past"] or run["mirrored"] or run["misses"]:
            phase("lm-mesh", f"{label} rank {rank} (lr {run['lr']}): "
                  f"{run['past']} parameter elements of its update slice "
                  f"past rtol {LM_MESH_RTOL} / atol {LM_MESH_ATOL}, "
                  f"{run['judged']} judged by their gradients (each "
                  f"step's within {LM_MESH_GRAD_ATOL} + {LM_MESH_GRAD_RTOL}"
                  f" |g| of one rank's, drift within {LM_MESH_STEPS} x lr "
                  f"more), {len(run['roots'])} roots (step 1 within the "
                  f"rule and within {LM_MESH_GRAD_ATOL} of zero on both, "
                  f"this rank's and one rank's)"
                  + "".join(f", {k}[{w}] {g:.3e} vs {o:.3e}"
                            for k, w, g, o in run["roots"][:8])
                  + f", {len(run['knock_ons'])} knock-ons fed by a root"
                  + "".join(f", {k}[{w}]" for k, w in run["knock_ons"][:8])
                  + "; passed by leaf"
                  + "".join(f", {k} {n}"
                            for k, n in run["judged_leaves"].items())
                  + f"; {run['mirrored']} all-gathered past it, equal to "
                  f"the writing data rank's"
                  + (f"; {run['misses']} not: {'; '.join(run['where'])}"
                     if run["misses"] else ""))
    kept = {id(one): one for _, _, _, one in runs}.values()
    phase("lm-mesh", f"judged by their gradients: {total} parameter elements "
          f"by every step, {roots} roots, {knocks} knock-ons over "
          f"{len(runs)} rank runs, {mirrored} all-gathered copies of "
          f"such equal to the writing rank's, {failed} not accounted for; "
          f"kept for it: each one-rank run's gradient each step on the "
          f"host while it ran, "
          f"{min(one['grad_log_bytes'] for one in kept) / 1e9:.3f}-"
          f"{max(one['grad_log_bytes'] for one in kept) / 1e9:.3f} GB, "
          f"and on disk its elements within {LM_MESH_GRAD_SMALL} x the "
          f"mean |g| at some step (every element of a leaf of at most "
          f"{LM_MESH_CAP_ELEMENTS}), its step-1 root candidates (|g| in "
          f"(0, {LM_MESH_GRAD_ATOL}]) and what each feeds (its table row, "
          f"its time-mix head): "
          + ", ".join(f"{one['grad_store'] / 1e6:.1f} MB "
                      f"({one['grad_store_elements']} elements, "
                      f"{one['grad_candidates']} candidates, "
                      f"{one['store_s']:.1f}s)"
                      for one in kept)
          + "; a rank's gradient at those elements of its slices, "
          f"{min(r['grad_log_bytes'] for _, _, r, _ in runs) / 1e6:.1f}-"
          f"{max(r['grad_log_bytes'] for _, _, r, _ in runs) / 1e6:.1f} MB "
          f"a run on the host, its picks "
          f"{sum(r['picks_s'] for _, _, r, _ in runs):.1f}s and its "
          f"comparison {sum(r['compare_s'] for _, _, r, _ in runs):.1f}s "
          f"over the rank runs ({smi})")


def lm_mesh_placement(step, params) -> dict:
    """(d)'s and (f)'s placement checked on this rank: the bytes its
    parameters hold against the layout's reckoning (each leaf's part
    over "model", `ModelLayout.rank_part` of its whole shape on meta
    tensors, over the data ranks where its "embed" dim is cut), and the
    leaves that came out whole on a dim the placement cut (must be
    none)."""
    import torch
    layout = step.layout
    data = step.plan.data_axis.size
    reckoned, uncut = 0, []
    for k, p in params.items():
        held = layout.rank_part(k, torch.empty(layout.full[k],
                                               device="meta"))
        n = held.numel() * p.element_size()
        dim = step.data_dims[k]
        if dim >= 0:
            n //= data
            if p.shape[dim] == held.shape[dim]:
                uncut.append(k)
        reckoned += n
    cut = sum(1 for d in step.data_dims.values() if d >= 0)
    return {"reckoned": reckoned, "uncut": uncut, "cut": cut,
            "model_dims": dict(layout.model_dims)}


def lm_mesh_expected_bytes(torch, arch: str) -> tuple:
    """(whole parameter bytes, a rank's parameter bytes at model=2)
    from the model's own split on a meta copy (no card memory)."""
    from repro_torch.distributed.collectives import Axis
    from repro_torch.models.registry import build_model
    cfg = lm_mesh_config(arch)
    model = build_model(cfg, "meta")
    whole = sum(p.numel() * 4 for p in model.parameters())
    model.split_(Axis("model", LM_MESH_MODEL, 0))
    return whole, sum(p.numel() * 4 for p in model.parameters())


def lm_mesh_pipeline(torch, mesh=None, ref_path: str | None = None) -> dict:
    """(c): `pipeline_apply` over `mesh`'s stage ranks (one full-width
    qwen1.5-4b DecoderBlock a stage, fp32, drawn from SEED + 100 +
    stage), or with no mesh the LM_MESH_STAGES blocks in sequence on
    this rank, a microbatch at a time (the pipeline's shapes, so the
    same products).  First the forward under `torch.no_grad()` (what a
    caller that wants no gradient pays), then the forward and backward
    of ``sum(out * ct)`` for a cotangent drawn from SEED + 10: its
    gradient in the input and in every block's parameters.  Alone, those
    gradients are saved to `ref_path`; on a mesh, this rank's (the
    input's, its stage's block's) are held to that file's under
    LM_MESH_GRAD_ATOL + LM_MESH_GRAD_RTOL |g|, and the elements past it
    returned ({leaf: (flat indices, this rank's, one rank's)}) for
    `lm_mesh_pipeline_judge`.  Returns the output on the host and each
    part's ms, `torch.distributed` calls and host ms inside them, and the
    gradient run's peak bytes."""
    from repro_torch.distributed.pipeline_parallel import pipeline_apply
    cfg = lm_mesh_config("qwen1.5-4b")
    stages = (range(LM_MESH_STAGES) if mesh is None
              else [mesh.axes["stage"].index])
    x, ct, mine = lm_mesh_pipeline_inputs(torch, cfg, torch.float32, stages)
    if mesh is None:
        def run(x):
            outs = []
            for h in x.split(1):  # LM_MESH_STAGES microbatches of one row
                for blk in mine.values():
                    h = blk(h)[0]
                outs.append(h)
            return torch.cat(outs)
    else:
        pipe = pipeline_apply(lambda blk, y: blk(y)[0], mesh,
                              n_microbatches=LM_MESH_STAGES)

        def run(x):
            return pipe(list(mine.values()), x)
    res = {}

    def timed(key, fn):
        with collective_clock() as coll:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
        res.update({f"{key}ms": 1e3 * (time.perf_counter() - t0),
                    f"{key}calls": coll["calls"],
                    f"{key}coll_ms": coll["ms"]})
        return got

    with torch.no_grad():
        run(x)   # warm: the first call's handles and buffers
        out = timed("", lambda: run(x))
    res["out"] = out.cpu().numpy()
    del out
    warm = x.clone().requires_grad_(True)   # and the gradient's path
    (run(warm) * ct).sum().backward()
    for blk in mine.values():
        blk.zero_grad(set_to_none=True)
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x = x.clone().requires_grad_(True)
    y = timed("fwd_", lambda: run(x))
    timed("bwd_", lambda: (y * ct).sum().backward())
    res["peak"] = torch.cuda.max_memory_allocated()
    res["same"] = bool(torch.equal(y.detach().cpu(),
                                   torch.from_numpy(res["out"])))
    grads = {"x": x.grad}
    for s, blk in mine.items():
        grads.update({f"{s}.{k}": p.grad for k, p in blk.named_parameters()})
    if mesh is None:
        torch.save({k: g.cpu() for k, g in grads.items()}, ref_path)
        return res
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    res["misses"], res["checked"] = {}, 0
    for k, g in grads.items():
        want = ref[k].to(DEVICE)
        res["checked"] += g.numel()
        bad = ((g - want).abs() > LM_MESH_GRAD_ATOL
               + LM_MESH_GRAD_RTOL * want.abs()).reshape(-1)
        if bad.any():
            at = torch.nonzero(bad)[:, 0]
            res["misses"][k] = (at.cpu().numpy(),
                                g.reshape(-1)[at].cpu().numpy(),
                                want.reshape(-1)[at].cpu().numpy())
    return res


def lm_mesh_pipeline_inputs(torch, cfg, dtype, stages) -> tuple:
    """(c)'s input [LM_MESH_STAGES, LM_MESH_SEQ, d] (SEED + 9), cotangent
    (SEED + 10) and {stage: DecoderBlock (SEED + 100 + stage)} of
    `stages` on the card, in `dtype`."""
    from repro_torch.nn.layers import init_params
    from repro_torch.nn.transformer import DecoderBlock
    shape = (LM_MESH_STAGES, LM_MESH_SEQ, cfg.d_model)
    x, ct = (torch.from_numpy(np.random.default_rng(SEED + seed)
                              .standard_normal(shape).astype(np.float32)
                              ).to(DEVICE, dtype) for seed in (9, 10))
    blocks = {}
    for stage in stages:
        with torch.device(DEVICE):
            blocks[stage] = init_params(DecoderBlock(cfg),
                                        SEED + 100 + stage).to(dtype)
    return x, ct, blocks


def lm_mesh_pipeline_judge(torch, misses: dict) -> dict:
    """(c)'s gradient elements past the rule (`misses`: {leaf: (flat
    indices, the pipeline's, the one-rank stack's)}, leaf "x" or
    "{stage}.{name}") judged against the same stack in float64 on this
    rank, as `tests/test_torch_lm_train_arch.py` judges by a float64
    gradient: an element passes where the one-rank stack is off float64
    by more than the rule and the pipeline no further than it plus the
    rule.  Returns {leaf: (elements, passed, the first faults)}."""
    cfg = lm_mesh_config("qwen1.5-4b")
    x, ct, blocks = lm_mesh_pipeline_inputs(torch, cfg, torch.float64,
                                            range(LM_MESH_STAGES))
    x.requires_grad_(True)
    h = x
    for blk in blocks.values():
        h = blk(h)[0]
    (h * ct).sum().backward()
    exact = {"x": x.grad}
    for s, blk in blocks.items():
        exact.update({f"{s}.{k}": p.grad for k, p in blk.named_parameters()})
    out = {}
    for k, (at, got, want) in misses.items():
        t = exact[k].reshape(-1)[torch.from_numpy(at).to(DEVICE)].cpu().numpy()
        rule = LM_MESH_GRAD_ATOL + LM_MESH_GRAD_RTOL * np.abs(t)
        off = np.abs(want - t)
        ok = (off > rule) & (np.abs(got - t) <= off + rule)
        out[k] = (len(at), int(ok.sum()), [
            f"{k}[{int(at[j])}]: {float(got[j])!r}, one rank's "
            f"{float(want[j])!r}, float64 {float(t[j])!r}"
            for j in np.nonzero(~ok)[0][:4]])
    del exact, blocks, x, h
    torch.cuda.empty_cache()
    return out


def lm_mesh_pipeline_check(torch, pipe: list, one: dict, smi: str) -> None:
    """(c): every stage's output within (a)'s limits of the blocks in
    sequence and the same on every stage, the gradient run's output equal
    to the forward alone's; every stage's gradients (the input's whole,
    its block's) within LM_MESH_GRAD_ATOL + LM_MESH_GRAD_RTOL |g| of the
    one-rank stack's, an element past it judged by the float64 stack
    (`lm_mesh_pipeline_judge`)."""
    want = one["out"]
    got = next(p["out"] for p in pipe if p["out"] is not None)
    gap = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=LM_MESH_RTOL, atol=LM_MESH_ATOL) \
            or len({p["sum"] for p in pipe}) != 1 \
            or not all(p["same"] for p in pipe):
        fail(f"lm-mesh (c): the pipeline's output is {gap:.3e} off the "
             f"blocks in sequence (rtol {LM_MESH_RTOL} / atol "
             f"{LM_MESH_ATOL}), or differs between stages: "
             f"{[p['sum'] for p in pipe]}, or with the gradient from the "
             f"forward alone: {[p['same'] for p in pipe]}")
    misses = {}
    for p in pipe:
        for k, (at, g, w) in p["misses"].items():
            if k in misses:   # the input's gradient, held on every stage
                at, g, w = (np.concatenate([a, b]) for a, b in
                            zip(misses[k], (at, g, w)))
            misses[k] = (at, g, w)
    judged = lm_mesh_pipeline_judge(torch, misses) if misses else {}
    faults = [f"{k}: {n - ok} of {n} past the rule not accounted for by "
              f"float64: {'; '.join(lines)}"
              for k, (n, ok, lines) in judged.items() if ok < n]
    if faults:
        fail("lm-mesh (c) gradient: " + " | ".join(faults))
    past = sum(n for n, _, _ in judged.values())
    checked = sum(p["checked"] for p in pipe)
    peaks = ", ".join(f"{p['peak'] / 1e9:.2f}" for p in pipe)
    phase("lm-mesh", f"(c) pipeline_apply over {LM_MESH_STAGES} stages, one "
          f"qwen1.5-4b DecoderBlock a stage, {LM_MESH_STAGES} microbatches "
          f"of 1 x {LM_MESH_SEQ}: within {gap:.2e} of the blocks in "
          f"sequence on each microbatch (rtol {LM_MESH_RTOL} / atol "
          f"{LM_MESH_ATOL}), every stage the same output; the gradient of "
          f"sum(out * ct) (the input's on every stage, each stage's "
          f"block's, {checked} elements) within {LM_MESH_GRAD_ATOL} + "
          f"{LM_MESH_GRAD_RTOL} |g| of the one-rank stack's but {past}, "
          f"each judged by the float64 stack"
          + "".join(f", {k} {n}" for k, (n, _, _) in judged.items())
          + f"; forward alone (no_grad) {max(p['ms'] for p in pipe):.1f} ms"
          f" and {pipe[0]['calls']} torch.distributed calls "
          f"({max(p['coll_ms'] for p in pipe):.1f} host ms inside them) "
          f"against {one['ms']:.1f} ms in sequence on one rank; with the "
          f"gradient: forward {max(p['fwd_ms'] for p in pipe):.1f} ms, "
          f"{pipe[0]['fwd_calls']} calls ({max(p['fwd_coll_ms'] for p in pipe):.1f}"
          f" host ms), backward {max(p['bwd_ms'] for p in pipe):.1f} ms, "
          f"{pipe[0]['bwd_calls']} calls ({max(p['bwd_coll_ms'] for p in pipe):.1f}"
          f" host ms), against {one['fwd_ms']:.1f} / {one['bwd_ms']:.1f} ms"
          f" on one rank; peak {peaks} GB a rank against "
          f"{one['peak'] / 1e9:.2f} GB on one rank "
          f"({smi})")


def lm_mesh_rank(paths: dict) -> dict:
    """What each spawned rank of `[lm-mesh]` runs: (a) and (b) on the
    (data, model) plan, (d) on it over placed parameters, (e) as (d)
    under the act rule "seq" -> "model" and its serving, (f) each of
    LM_MESH_TP_RUNS placed and served, (h) each of LM_MESH_SEQ_FAMILIES
    so under the rule, (i) (a) with each of LM_MESH_COMPRESSORS, then
    (c) on the stage mesh, with every kernel's launch count read (the
    path reaches none)."""
    import torch
    from repro_torch.distributed import partition
    full_fp32(torch)
    zero_launches()
    plan = partition.make_plan(model_parallel=LM_MESH_MODEL, device=DEVICE)
    out = {}
    for arch in LM_MESH_ARCHS:
        torch.distributed.barrier()
        out[arch] = lm_mesh_train(torch, arch, plan, paths[arch])
    torch.distributed.barrier()
    out["fsdp"] = lm_mesh_train(torch, LM_MESH_ARCHS[0], plan,
                                paths[LM_MESH_ARCHS[0]], placed=True)
    seq_plan = partition.make_plan(model_parallel=LM_MESH_MODEL,
                                   device=DEVICE,
                                   act_rules=LM_MESH_SEQ_RULES)
    torch.distributed.barrier()
    out["seq"] = lm_mesh_train(torch, LM_MESH_ARCHS[0], seq_plan,
                               paths[LM_MESH_ARCHS[0]], placed=True,
                               serve=True)
    out["tp"] = {}
    for arch, rules in LM_MESH_TP_RUNS:
        torch.distributed.barrier()
        out["tp"][lm_mesh_tp_label(arch, rules)] = lm_mesh_train(
            torch, arch, seq_plan if rules else plan, paths[arch],
            placed=True, serve=True, seq=LM_MESH_TP_SEQ,
            micro=LM_MESH_TP_MICRO)
    torch.distributed.barrier()
    out["adafactor"] = lm_mesh_train(
        torch, LM_MESH_ADAFACTOR, plan, paths["adafactor"], placed=True,
        seq=LM_MESH_TP_SEQ, micro=LM_MESH_TP_MICRO, optimizer="adafactor")
    for arch in LM_MESH_SEQ_FAMILIES:
        torch.distributed.barrier()
        out["tp"][lm_mesh_tp_label(arch, LM_MESH_SEQ_RULES)] = lm_mesh_train(
            torch, arch, seq_plan, paths[arch], placed=True, serve=True,
            seq=LM_MESH_TP_SEQ, micro=LM_MESH_TP_MICRO)
    out["compress"] = {}
    for kind in LM_MESH_COMPRESSORS:
        torch.distributed.barrier()
        out["compress"][kind] = lm_mesh_train(
            torch, LM_MESH_ARCHS[0], plan, paths[kind], compressor=kind)
    mesh = partition.make_mesh(stages=LM_MESH_STAGES)
    torch.distributed.barrier()
    pipe = lm_mesh_pipeline(torch, mesh, paths["pipeline"])
    pipe["sum"] = float(np.abs(pipe["out"]).sum())
    if plan.rank:
        pipe["out"] = None
    out["pipeline"] = pipe
    out["launches"] = read_launches()
    out["rank"] = plan.rank
    return out


def lm_mesh_line(label: str, run: dict, smi: str) -> str:
    med = statistics.median(run["step_ms"][1:])
    return (f"{label}: step {med:.1f} ms median of steps 2-{LM_MESH_STEPS} "
            f"({smi}), {run['calls']:.0f} torch.distributed calls and "
            f"{run['coll_ms']:.1f} host ms inside them a step; peak "
            f"{run['peak'] / 1e9:.2f} GB; {run['param_bytes'] / 1e9:.3f} GB "
            f"of parameters and {run['opt_bytes'] / 1e9:.3f} GB of "
            f"optimizer state held")


def lm_mesh_uneven_rank(paths: dict) -> dict:
    """What each of the 16 spawned ranks of `[lm-mesh]` (g) runs: each of
    LM_MESH_UNEVEN_ARCHS on (data=1, model=16), held to its one-rank run
    saved at ``paths[arch]`` (rwkv6-3b then served from that run's final
    weights), with the wall-clock times it entered and passed its first
    barrier (the world's start-up) and every kernel's launch count."""
    import torch
    from repro_torch.distributed import partition
    entered = time.time()
    full_fp32(torch)
    zero_launches()
    plan = partition.make_plan(model_parallel=LM_MESH_UNEVEN_MODEL,
                               device=DEVICE)
    torch.distributed.barrier()
    ready = time.time()
    out = {}
    for arch in LM_MESH_UNEVEN_ARCHS:
        torch.distributed.barrier()
        out[arch] = lm_mesh_train(torch, arch, plan, paths[arch],
                                  seq=LM_MESH_UNEVEN_SEQ, micro=1,
                                  rows=LM_MESH_UNEVEN_ROWS, reckon=True,
                                  serve=arch in LM_MESH_UNEVEN_SERVED)
    out.update(rank=plan.rank, entered=entered, ready=ready,
               launches=read_launches())
    return out


# each leaf kind of (g) and the dim it must be cut on over "model":
# granite's experts by hidden width and attention's weights at rest by
# fused columns; rwkv6's time-mix weights at rest by fused columns (o by
# rows; the layer runs by value columns) and its channel mix split by its
# hidden width
LM_MESH_UNEVEN_DIMS = {
    "granite-moe-3b-a800m": {"ffn.wi": 2, "ffn.wg": 2, "ffn.wo": 1,
                             "attn.wq.w": 1, "attn.wk.w": 1,
                             "attn.wv.w": 1, "attn.wo.w": 0},
    "rwkv6-3b": {"tm.r.w": 1, "tm.k.w": 1, "tm.v.w": 1, "tm.g.w": 1,
                 "tm.o.w": 0, "cm.k.w": 1, "cm.v.w": 0, "cm.r.w": 1}}
LM_MESH_UNEVEN_WHAT = {
    "granite-moe-3b-a800m": "experts by hidden width, attention cut at rest",
    "rwkv6-3b": "the time mix by value columns, its weights cut at rest"}
LM_MESH_UNEVEN_SERVED = ("rwkv6-3b",)


def lm_mesh_uneven_cache(cfg, rows: int) -> dict:
    """The layout's reckoning of an rwkv6 cache a rank of (g) holds for
    `rows` sequences: the token shifts whole, the wkv state's value
    columns of every head (its shape and bytes, fp32)."""
    p, h = cfg.ssm_head_dim, cfg.d_model // cfg.ssm_head_dim
    q = p // LM_MESH_UNEVEN_MODEL
    wkv = (cfg.num_layers, rows, h, p, q)
    state = int(np.prod(wkv)) * 4
    return {"wkv": wkv, "state_bytes": state,
            "cache_bytes": state + 2 * cfg.num_layers * rows * cfg.d_model
            * 4, "value_dim": q}


def lm_mesh_uneven_check(arch: str, world: list, one: dict,
                         smi: str) -> None:
    """(g) for `arch`: every rank's metrics each step within LM_MESH_RTOL
    / LM_MESH_ATOL of one rank's, its final parameters at (a)'s limits
    (`lm_mesh_compare`'s judged ones included), its parameter bytes
    equal to its layout's reckoning and its optimizer's to two moments
    of them and a step count, each leaf kind of LM_MESH_UNEVEN_DIMS cut
    on its dim, model-axis calls every step; rwkv6-3b's time mix cut by
    value columns, and its serving from the one-rank run's final
    weights: tokens equal, logits within LM_MESH_RTOL / LM_MESH_ATOL,
    the wkv state and the cache a rank holds equal to the layout's
    reckoning (`lm_mesh_uneven_cache`)."""
    keys = ("loss", "total_loss", "tokens", "grad_norm") + (
        ("moe_lb_loss", "moe_z_loss", "moe_drop_fraction")
        if arch.startswith("granite") else ())
    label = f"(g) {arch} (data=1, model={LM_MESH_UNEVEN_MODEL})"
    cfg = lm_mesh_config(arch)
    want_dims = LM_MESH_UNEVEN_DIMS[arch]
    reckoned = lm_mesh_uneven_cache(cfg, LM_MESH_BATCH)
    for run in world:
        got, r = run[arch], run["rank"]
        for step, (g, w) in enumerate(zip(got["metrics"], one["metrics"])):
            for k in keys:
                if not abs(g[k] - w[k]) <= LM_MESH_RTOL * abs(w[k]) \
                        + LM_MESH_ATOL:
                    fail(f"lm-mesh {label} rank {r} step {step + 1}: {k} "
                         f"{g[k]!r} vs one rank's {w[k]!r} (rtol "
                         f"{LM_MESH_RTOL} / atol {LM_MESH_ATOL})")
        if got["misses"]:
            fail(f"lm-mesh {label} rank {r}: {got['misses']} parameter "
                 f"elements past rtol {LM_MESH_RTOL} / atol {LM_MESH_ATOL} "
                 f"of one rank's that their gradients do not account for "
                 f"(largest difference {got['worst']:.3e}): "
                 f"{'; '.join(got['where'])}")
        if got["uncut"] or got["param_bytes"] != got["reckoned"] \
                or got["opt_bytes"] != 2 * got["reckoned"] + 4:
            fail(f"lm-mesh {label} rank {r}: {got['param_bytes']} parameter "
                 f"and {got['opt_bytes']} optimizer bytes held against the "
                 f"layout's {got['reckoned']} (and two moments of it and a "
                 f"4-byte step), whole where cut: {got['uncut']}")
        dims = {k: d for k, d in got["model_dims"].items()
                if any(k.endswith(sfx) for sfx in want_dims)}
        wrong = {k: d for k, d in dims.items() if d != next(
            v for sfx, v in want_dims.items() if k.endswith(sfx))}
        if wrong or len(dims) != len(want_dims) * LM_MESH_LAYERS:
            fail(f"lm-mesh {label} rank {r}: leaves cut on the wrong dim "
                 f"over model: {wrong} (of {sorted(dims)})")
        # at data=1 the model axis' line is the whole world: its calls
        # name the default group ("world")
        if got["per_axis"].get("world", 0) + got["per_axis"].get(
                "model", 0) <= 1:
            fail(f"lm-mesh {label} rank {r}: {got['per_axis']} calls a "
                 "step by axis (the split needs model-axis calls)")
        if arch not in LM_MESH_UNEVEN_SERVED:
            continue
        tm = got["time_mix"]
        if tm != {"cut": "value", "value_dim": reckoned["value_dim"]}:
            fail(f"lm-mesh {label} rank {r}: the time mix is cut {tm}, not "
                 f"by value columns ({reckoned['value_dim']} of "
                 f"{cfg.ssm_head_dim} a rank)")
        sv, served = got["serve"], one["serve"]
        gap = float(np.abs(sv["logits"] - served["logits"]).max())
        if not np.array_equal(sv["tokens"], served["tokens"]) \
                or not np.allclose(sv["logits"], served["logits"],
                                   rtol=LM_MESH_RTOL, atol=LM_MESH_ATOL):
            fail(f"lm-mesh {label} rank {r}: serving from the cache cut by "
                 f"value columns gave tokens {sv['tokens'].tolist()} against "
                 f"one rank's {served['tokens'].tolist()}, logits "
                 f"{gap:.3e} off (rtol {LM_MESH_RTOL} / atol "
                 f"{LM_MESH_ATOL})")
        if sv["cache_shapes"]["wkv"] != reckoned["wkv"] \
                or sv["state_bytes"] != reckoned["state_bytes"] \
                or sv["cache_bytes"] != reckoned["cache_bytes"]:
            fail(f"lm-mesh {label} rank {r}: the cache holds "
                 f"{sv['cache_shapes']}, {sv['state_bytes']} wkv state and "
                 f"{sv['cache_bytes']} bytes in all, the layout's "
                 f"{reckoned}")
    rank0 = world[0][arch]
    meds = [statistics.median(run[arch]["step_ms"][1:]) for run in world]
    per_op = ", ".join(f"{k} {v:.0f}" for k, v in rank0["per_op"].items()
                       if v)
    per_axis = ", ".join(f"{k} {v:.0f}" for k, v in
                         sorted(rank0["per_axis"].items()))
    one_ms = statistics.median(one["step_ms"][1:])
    whole = sorted({re.sub(r"\.\d+\.", ".*.", k)
                    for k, d in rank0["model_dims"].items() if d < 0})
    extra = (f", moe_drop_fraction "
             f"{[round(m['moe_drop_fraction'], 4) for m in one['metrics']]}"
             if "moe_drop_fraction" in keys else "")
    phase("lm-mesh", lm_mesh_line(f"{label} one rank", one, smi)
          + f"; losses {[round(m['loss'], 5) for m in one['metrics']]}"
          + extra)
    judged = [run[arch].get("judged", 0) for run in world]
    phase("lm-mesh", lm_mesh_line(f"{label} rank 0", rank0, smi)
          + f" ({rank0['param_bytes'] / one['param_bytes']:.3f} and "
          f"{rank0['opt_bytes'] / one['opt_bytes']:.3f} of one rank's, the "
          f"layout's reckoning); calls a step by op: {per_op}; by axis: "
          f"{per_axis}; {rank0['split']} of {rank0['leaves']} leaves split "
          f"over model ({LM_MESH_UNEVEN_WHAT[arch]}), whole: {whole}; "
          f"largest parameter difference "
          f"{max(run[arch]['worst'] for run in world):.2e} over the ranks, "
          f"{sum(judged)} elements judged by their gradients "
          f"({min(judged)}-{max(judged)} a rank)")
    line = (f"{label} vs one rank ({LM_MESH_LAYERS} layers at full width, "
            f"{LM_MESH_STEPS} steps of {LM_MESH_UNEVEN_ROWS} x "
            f"{LM_MESH_UNEVEN_SEQ} at lr {one['lr']}; the model axis is the "
            f"world, its calls \"world\"): {', '.join(keys)} each step "
            f"within rtol {LM_MESH_RTOL} / atol {LM_MESH_ATOL} and final "
            f"parameters at (a)'s limits on all {len(world)} ranks; step "
            f"{min(meds):.1f}-{max(meds):.1f} ms a rank ({smi}; one rank "
            f"{one_ms:.1f}), peak "
            f"{min(run[arch]['peak'] for run in world) / 1e9:.2f}-"
            f"{max(run[arch]['peak'] for run in world) / 1e9:.2f} GB a rank "
            f"(one rank {one['peak'] / 1e9:.2f})")
    if arch in LM_MESH_UNEVEN_SERVED:
        sv, served = rank0["serve"], one["serve"]
        gaps = [float(np.abs(run[arch]["serve"]["logits"]
                             - served["logits"]).max()) for run in world]
        line += (f"; served {LM_MESH_BATCH} rows from its final weights: "
                 f"prefill {LM_MESH_PROMPT} tokens "
                 f"{sv['prefill_ms']:.1f} ms (one rank "
                 f"{served['prefill_ms']:.1f}), decode {sv['decode_ms']:.1f}"
                 f" ms a step (one rank {served['decode_ms']:.1f}), "
                 f"{LM_MESH_DECODE} greedy tokens equal to one rank's on "
                 f"every rank, logits within {max(gaps):.2e}; the wkv state "
                 f"{sv['cache_shapes']['wkv']} a rank "
                 f"({reckoned['value_dim']} of {cfg.ssm_head_dim} value "
                 f"columns of every head), {sv['state_bytes'] / 1e6:.3f} MB "
                 f"of state and {sv['cache_bytes'] / 1e6:.3f} MB of cache "
                 f"held against the whole "
                 f"{sv['whole_cache_bytes'] / 1e6:.3f} MB, the layout's "
                 f"reckoning")
    phase("lm-mesh", line)


def lm_mesh_uneven(torch, smi, figures: dict, tmp: str) -> dict:
    """(g): each arch's one-rank run on the card alone, then the world of
    LM_MESH_UNEVEN_MODEL gloo ranks sharing it (`lm_mesh_uneven_rank`),
    each arch held to its one-rank run (`lm_mesh_uneven_check`; the
    parameter elements past the tolerance judged by their gradients,
    `lm_mesh_compare`).  Returns every kernel's launches in the
    world (all must be 0); the ranks' runs go into
    ``figures["lm-mesh-uneven"][arch]`` for `[dryrun]` (b'''')."""
    import gc
    from repro_torch.distributed.launch import run_ranks
    t0 = time.perf_counter()
    paths = {arch: os.path.join(tmp, f"uneven{i}.pt")
             for i, arch in enumerate(LM_MESH_UNEVEN_ARCHS)}
    one = {arch: lm_mesh_train(torch, arch, None, paths[arch],
                               seq=LM_MESH_UNEVEN_SEQ, micro=1,
                               rows=LM_MESH_UNEVEN_ROWS,
                               serve=arch in LM_MESH_UNEVEN_SERVED)
           for arch in LM_MESH_UNEVEN_ARCHS}
    gc.collect()
    torch.cuda.empty_cache()
    started = time.time()
    world = run_ranks(lm_mesh_uneven_rank, LM_MESH_UNEVEN_MODEL,
                      args=(paths,), backend="gloo", device=DEVICE + ":0",
                      threads=1, timeout_s=LM_MESH_UNEVEN_TIMEOUT_S)
    world_s = time.time() - started
    world.sort(key=lambda r: r["rank"])
    lm_mesh_judged_lines([(f"(g) {arch}", run["rank"], run[arch], one[arch])
                          for run in world for arch in LM_MESH_UNEVEN_ARCHS],
                         smi)
    figures["lm-mesh-uneven"] = {
        arch: [{"rank": run["rank"], **run[arch]} for run in world]
        for arch in LM_MESH_UNEVEN_ARCHS}
    for arch in LM_MESH_UNEVEN_ARCHS:
        lm_mesh_uneven_check(arch, world, one[arch], smi)
    entered = max(g["entered"] for g in world) - started
    ready = max(g["ready"] for g in world) - started
    phase("lm-mesh", f"(g) start-up: the last rank entered {entered:.1f}s "
          f"and passed its first barrier {ready:.1f}s after the spawn; "
          f"world {world_s:.1f}s, (g) {time.perf_counter() - t0:.1f}s")
    launches = read_launches()
    for run in world:
        for k, v in run["launches"].items():
            launches[k] += v
    return launches


def lm_mesh_fsdp_check(world: list, want: dict, smi: str) -> None:
    """(d): each rank's FSDP run against the one-rank run of (a): the
    metrics each step and the final parameters at (a)'s limits, its
    parameter bytes equal to its placement's reckoning with no leaf
    whole on a dim the placement cut, and at most LM_MESH_FSDP_SHARE of
    the model's."""
    arch = LM_MESH_ARCHS[0]
    whole = want["param_bytes"]
    keys = ("loss", "total_loss", "tokens", "grad_norm")
    for run in world:
        got, r = run["fsdp"], run["rank"]
        for s, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in keys:
                if not abs(g[k] - w[k]) <= LM_MESH_RTOL * abs(w[k]) + 1e-7:
                    fail(f"lm-mesh (d) rank {r} step {s + 1}: {k} {g[k]!r} "
                         f"vs one rank's {w[k]!r} (rtol {LM_MESH_RTOL})")
        if got["misses"]:
            fail(f"lm-mesh (d) rank {r}: {got['misses']} parameter elements "
                 f"past rtol {LM_MESH_RTOL} / atol {LM_MESH_ATOL} of one "
                 f"rank's (largest difference {got['worst']:.3e}): "
                 f"{'; '.join(got['where'])}")
        if got["uncut"] or not got["cut"] \
                or got["param_bytes"] != got["reckoned"]:
            fail(f"lm-mesh (d) rank {r}: {got['param_bytes']} parameter "
                 f"bytes held against the placement's {got['reckoned']}; "
                 f"{got['cut']} leaves cut over data, whole where cut: "
                 f"{got['uncut']}")
        if got["param_bytes"] > LM_MESH_FSDP_SHARE * whole:
            fail(f"lm-mesh (d) rank {r}: {got['param_bytes']} parameter "
                 f"bytes, past {LM_MESH_FSDP_SHARE} of the model's {whole}")
        per_op = ", ".join(f"{k} {v:.0f}" for k, v in got["per_op"].items()
                           if v)
        phase("lm-mesh", lm_mesh_line(f"(d) FSDP rank {r}", got, smi)
              + f" ({got['param_bytes'] / whole:.3f} and "
              f"{got['opt_bytes'] / want['opt_bytes']:.3f} of one rank's); "
              f"calls a step: {per_op}; {got['cut']} of {got['leaves']} "
              f"leaves cut over data, largest parameter difference "
              f"{got['worst']:.2e}")
    phase("lm-mesh", f"(d) {arch} FSDP at (data={LM_MESH_DATA}, model="
          f"{LM_MESH_MODEL}) vs one rank: {', '.join(keys)} each step within "
          f"rtol {LM_MESH_RTOL}, final parameters within rtol "
          f"{LM_MESH_RTOL} / atol {LM_MESH_ATOL}, parameters at most "
          f"{LM_MESH_FSDP_SHARE} of the model's a rank")


def lm_mesh_seq_check(world: list, want: dict, fsdp: list, smi: str) -> None:
    """(e): each rank's run under sequence parallelism against the
    one-rank run of (a) at (a)'s limits, its calls a step per op and per
    axis, step ms and peak beside (d)'s; then its prefill and greedy
    decode from the one-rank run's final weights with the KV cache cut
    by sequence: tokens equal to the one-rank run's, logits within
    LM_MESH_RTOL / LM_MESH_ATOL, and the cache a rank holds against the
    whole cache of its rows."""
    keys = ("loss", "total_loss", "tokens", "grad_norm")
    d_peak = {run["rank"]: run["peak"] for run in fsdp}
    d_ms = {run["rank"]: statistics.median(run["step_ms"][1:])
            for run in fsdp}
    served = want["serve"]
    for run in world:
        got, r = run["seq"], run["rank"]
        for s, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in keys:
                if not abs(g[k] - w[k]) <= LM_MESH_RTOL * abs(w[k]) + 1e-7:
                    fail(f"lm-mesh (e) rank {r} step {s + 1}: {k} {g[k]!r} "
                         f"vs one rank's {w[k]!r} (rtol {LM_MESH_RTOL})")
        if got["misses"]:
            fail(f"lm-mesh (e) rank {r}: {got['misses']} parameter elements "
                 f"past rtol {LM_MESH_RTOL} / atol {LM_MESH_ATOL} of one "
                 f"rank's (largest difference {got['worst']:.3e}): "
                 f"{'; '.join(got['where'])}")
        if not got["per_axis"].get("model"):
            fail(f"lm-mesh (e) rank {r}: no call on the model axis: "
                 f"{got['per_axis']}")
        sv = got["serve"]
        rows = slice(*sv["rows"])
        gap = float(np.abs(sv["logits"] - served["logits"][rows]).max())
        if not sv["cut"] or not np.array_equal(sv["tokens"],
                                               served["tokens"][rows]) \
                or not np.allclose(sv["logits"], served["logits"][rows],
                                   rtol=LM_MESH_RTOL, atol=LM_MESH_ATOL):
            fail(f"lm-mesh (e) rank {r}: serving with the cache cut by "
                 f"sequence ({sv['cut']}) gave tokens {sv['tokens'].tolist()}"
                 f" against one rank's {served['tokens'][rows].tolist()}, "
                 f"logits {gap:.3e} off (rtol {LM_MESH_RTOL} / atol "
                 f"{LM_MESH_ATOL})")
        per_op = ", ".join(f"{k} {v:.0f}" for k, v in got["per_op"].items()
                           if v)
        per_axis = ", ".join(f"{k} {v:.0f}"
                             for k, v in sorted(got["per_axis"].items()))
        med = statistics.median(got["step_ms"][1:])
        phase("lm-mesh", lm_mesh_line(f"(e) FSDP + sequence parallel rank "
                                      f"{r}", got, smi)
              + f"; calls a step by op: {per_op}; by axis: {per_axis}; step "
              f"{med / d_ms[r]:.2f}x (d)'s {d_ms[r]:.1f} ms, peak "
              f"{got['peak'] / 1e9:.2f} GB against (d)'s "
              f"{d_peak[r] / 1e9:.2f}; largest parameter difference "
              f"{got['worst']:.2e}; served rows {sv['rows'][0]}-"
              f"{sv['rows'][1] - 1}: prefill {LM_MESH_PROMPT} tokens "
              f"{sv['prefill_ms']:.1f} ms (one rank {served['prefill_ms']:.1f}"
              f"), decode {sv['decode_ms']:.1f} ms a step (one rank "
              f"{served['decode_ms']:.1f}), {LM_MESH_DECODE} greedy tokens "
              f"equal to one rank's, logits within {gap:.2e}; KV cache "
              f"{tuple(sv['cache_shape'])} a layer stack, "
              f"{sv['cache_bytes'] / 1e6:.2f} MB held against the whole "
              f"{sv['whole_cache_bytes'] / 1e6:.2f} MB of its rows "
              f"({sv['cache_bytes'] / sv['whole_cache_bytes']:.3f})")
    phase("lm-mesh", f"(e) {LM_MESH_ARCHS[0]} FSDP with the act rule \"seq\" "
          f"-> \"model\" at (data={LM_MESH_DATA}, model={LM_MESH_MODEL}) vs "
          f"one rank: {', '.join(keys)} each step within rtol "
          f"{LM_MESH_RTOL}, final parameters within rtol {LM_MESH_RTOL} / "
          f"atol {LM_MESH_ATOL}; prefill and {LM_MESH_DECODE} greedy steps "
          f"from the same weights with the cache cut by sequence: tokens "
          f"equal")


def lm_mesh_tp_label(arch: str, rules) -> str:
    return f"{arch} seq" if rules else arch


def lm_mesh_tp_check(runs: dict, one: dict, smi: str) -> None:
    """(f): each of LM_MESH_TP_RUNS on every rank against the one-rank
    run of its arch at (a)'s limits, its parameter bytes equal to its
    layout's reckoning with no leaf whole on a dim the placement cut;
    then its prefill and greedy decode from the one-rank run's final
    weights: tokens equal, logits within LM_MESH_RTOL / LM_MESH_ATOL,
    the caches cut by heads (by sequence under the rule)."""
    keys = ("loss", "total_loss", "tokens", "grad_norm")
    for (arch, rules) in LM_MESH_TP_RUNS:
        label = lm_mesh_tp_label(arch, rules)
        want = one[arch]
        served = want["serve"]
        for got in runs[label]:
            r = got["rank"]
            for s, (g, w) in enumerate(zip(got["metrics"],
                                           want["metrics"])):
                for k in keys:
                    if not abs(g[k] - w[k]) <= (LM_MESH_RTOL * abs(w[k])
                                                + 1e-7):
                        fail(f"lm-mesh (f) {label} rank {r} step {s + 1}: "
                             f"{k} {g[k]!r} vs one rank's {w[k]!r} (rtol "
                             f"{LM_MESH_RTOL})")
            if got["misses"]:
                fail(f"lm-mesh (f) {label} rank {r}: {got['misses']} "
                     f"parameter elements past rtol {LM_MESH_RTOL} / atol "
                     f"{LM_MESH_ATOL} of one rank's (largest difference "
                     f"{got['worst']:.3e}): {'; '.join(got['where'])}")
            if got["uncut"] or not got["cut"] or not got["split"] \
                    or got["param_bytes"] != got["reckoned"]:
                fail(f"lm-mesh (f) {label} rank {r}: {got['param_bytes']} "
                     f"parameter bytes held against the layout's "
                     f"{got['reckoned']}; {got['split']} leaves split over "
                     f"model, {got['cut']} cut over data, whole where cut: "
                     f"{got['uncut']}")
            if not got["per_axis"].get("model"):
                fail(f"lm-mesh (f) {label} rank {r}: no call on the model "
                     f"axis: {got['per_axis']}")
            sv = got["serve"]
            rows = slice(*sv["rows"])
            gap = float(np.abs(sv["logits"] - served["logits"][rows]).max())
            if sv["cut"] != bool(rules) or not np.array_equal(
                    sv["tokens"], served["tokens"][rows]) \
                    or not np.allclose(sv["logits"], served["logits"][rows],
                                       rtol=LM_MESH_RTOL, atol=LM_MESH_ATOL):
                fail(f"lm-mesh (f) {label} rank {r}: serving (cut by "
                     f"sequence: {sv['cut']}) gave tokens "
                     f"{sv['tokens'].tolist()} against one rank's "
                     f"{served['tokens'][rows].tolist()}, logits "
                     f"{gap:.3e} off (rtol {LM_MESH_RTOL} / atol "
                     f"{LM_MESH_ATOL})")
            per_op = ", ".join(f"{k} {v:.0f}"
                               for k, v in got["per_op"].items() if v)
            per_axis = ", ".join(f"{k} {v:.0f}" for k, v in
                                 sorted(got["per_axis"].items()))
            med = statistics.median(got["step_ms"][1:])
            one_ms = statistics.median(want["step_ms"][1:])
            phase("lm-mesh", lm_mesh_line(f"(f) {label} rank {r}", got, smi)
                  + f" ({got['param_bytes'] / want['param_bytes']:.3f} and "
                  f"{got['opt_bytes'] / want['opt_bytes']:.3f} of one "
                  f"rank's, the layout's reckoning); calls a step by op: "
                  f"{per_op}; by axis: {per_axis}; step {med / one_ms:.1f}x "
                  f"one rank's {one_ms:.1f} ms, peak against one rank's "
                  f"{want['peak'] / 1e9:.2f} GB; {got['split']} of "
                  f"{got['leaves']} leaves split over model, {got['cut']} "
                  f"cut over data, largest parameter difference "
                  f"{got['worst']:.2e}; served rows {sv['rows'][0]}-"
                  f"{sv['rows'][1] - 1}: prefill {LM_MESH_PROMPT} tokens "
                  f"{sv['prefill_ms']:.1f} ms (one rank "
                  f"{served['prefill_ms']:.1f}), decode "
                  f"{sv['decode_ms']:.1f} ms a step (one rank "
                  f"{served['decode_ms']:.1f}), {LM_MESH_DECODE} greedy "
                  f"tokens equal to one rank's, logits within {gap:.2e}; "
                  f"cache {sv['cache_bytes'] / 1e6:.2f} MB held against "
                  f"the whole {sv['whole_cache_bytes'] / 1e6:.2f} MB of its "
                  f"rows ({sv['cache_bytes'] / sv['whole_cache_bytes']:.3f}"
                  f", cut by {'sequence' if sv['cut'] else 'heads'})")
        phase("lm-mesh", f"(f) {label} FSDP at (data={LM_MESH_DATA}, "
              f"model={LM_MESH_MODEL}), split by heads"
              + (", the act rule \"seq\" -> \"model\"" if rules else "")
              + f", vs one rank ({LM_MESH_LAYERS} layers at full width, "
              f"{LM_MESH_STEPS} steps of {LM_MESH_BATCH} x "
              f"{LM_MESH_TP_SEQ}): {', '.join(keys)} each step within rtol "
              f"{LM_MESH_RTOL}, final parameters within rtol "
              f"{LM_MESH_RTOL} / atol {LM_MESH_ATOL}; prefill and "
              f"{LM_MESH_DECODE} greedy steps from the same weights: "
              f"tokens equal")


def lm_mesh_adafactor_check(world: list, one: dict, smi: str) -> None:
    """(f) with Adafactor: LM_MESH_ADAFACTOR placed at (data, model) on
    every rank against its one-rank Adafactor run at (a)'s limits (the
    loss, total loss and tokens each step within rtol, the final
    parameters by `lm_mesh_compare`'s rule), its parameter bytes equal to
    its layout's reckoning with no leaf whole on a dim the placement
    cut, calls on the model axis."""
    keys = ("loss", "total_loss", "tokens")
    label = f"(f) {LM_MESH_ADAFACTOR} adafactor"
    for run in world:
        got, r = run["adafactor"], run["rank"]
        for s, (g, w) in enumerate(zip(got["metrics"], one["metrics"])):
            for k in keys:
                if not abs(g[k] - w[k]) <= LM_MESH_RTOL * abs(w[k]) + 1e-7:
                    fail(f"lm-mesh {label} rank {r} step {s + 1}: {k} "
                         f"{g[k]!r} vs one rank's {w[k]!r} (rtol "
                         f"{LM_MESH_RTOL})")
        if got["misses"]:
            fail(f"lm-mesh {label} rank {r}: {got['misses']} parameter "
                 f"elements past rtol {LM_MESH_RTOL} / atol {LM_MESH_ATOL} "
                 f"of one rank's (largest difference {got['worst']:.3e}): "
                 f"{'; '.join(got['where'])}")
        if got["uncut"] or not got["cut"] or not got["split"] \
                or got["param_bytes"] != got["reckoned"] \
                or not got["per_axis"].get("model"):
            fail(f"lm-mesh {label} rank {r}: {got['param_bytes']} parameter "
                 f"bytes held against the layout's {got['reckoned']}; "
                 f"{got['split']} leaves split over model, {got['cut']} cut "
                 f"over data, whole where cut: {got['uncut']}; calls by "
                 f"axis {got['per_axis']}")
        med = statistics.median(got["step_ms"][1:])
        one_ms = statistics.median(one["step_ms"][1:])
        phase("lm-mesh", lm_mesh_line(f"{label} rank {r}", got, smi)
              + f" ({got['param_bytes'] / one['param_bytes']:.3f} and "
              f"{got['opt_bytes'] / one['opt_bytes']:.3f} of one rank's); "
              f"step {med / one_ms:.1f}x one rank's {one_ms:.1f} ms, peak "
              f"against one rank's {one['peak'] / 1e9:.2f} GB; largest "
              f"parameter difference {got['worst']:.2e}")
    if not one["metrics"][-1]["loss"] < one["metrics"][0]["loss"]:
        fail(f"lm-mesh {label}: one rank's loss did not fall: "
             f"{[m['loss'] for m in one['metrics']]}")
    phase("lm-mesh", f"{label} FSDP at (data={LM_MESH_DATA}, model="
          f"{LM_MESH_MODEL}), split by heads, B and C alike on every model "
          f"rank, vs one rank with Adafactor (lr {LM_MESH_LR}, "
          f"{LM_MESH_STEPS} steps of {LM_MESH_BATCH} x {LM_MESH_TP_SEQ}): "
          f"{', '.join(keys)} each step within rtol {LM_MESH_RTOL}, final "
          f"parameters within rtol {LM_MESH_RTOL} / atol {LM_MESH_ATOL} or "
          f"judged by their gradients; losses "
          f"{[round(m['loss'], 5) for m in one['metrics']]}")


def lm_mesh_seq_families_check(runs: dict, one: dict, smi: str) -> None:
    """(h): rwkv6-3b's and whisper-medium's (f) runs under the act rule
    "seq" -> "model" against (f)'s one-rank runs at (a)'s limits: the
    residual cut in training and in the prefill, the bytes held equal to
    the layout's reckoning, calls on the model axis; then the prefill
    and greedy decode: tokens equal, logits within LM_MESH_RTOL /
    LM_MESH_ATOL, whisper's caches cut by sequence (rwkv6's state has
    no sequence dim)."""
    keys = ("loss", "total_loss", "tokens", "grad_norm")
    for arch in LM_MESH_SEQ_FAMILIES:
        label = lm_mesh_tp_label(arch, LM_MESH_SEQ_RULES)
        want = one[arch]
        served = want["serve"]
        whole_f = {r["rank"]: r for r in runs[arch]}
        for got in runs[label]:
            r = got["rank"]
            for s, (g, w) in enumerate(zip(got["metrics"],
                                           want["metrics"])):
                for k in keys:
                    if not abs(g[k] - w[k]) <= (LM_MESH_RTOL * abs(w[k])
                                                + 1e-7):
                        fail(f"lm-mesh (h) {label} rank {r} step {s + 1}: "
                             f"{k} {g[k]!r} vs one rank's {w[k]!r} (rtol "
                             f"{LM_MESH_RTOL})")
            if got["misses"]:
                fail(f"lm-mesh (h) {label} rank {r}: {got['misses']} "
                     f"parameter elements past rtol {LM_MESH_RTOL} / atol "
                     f"{LM_MESH_ATOL} of one rank's (largest difference "
                     f"{got['worst']:.3e}): {'; '.join(got['where'])}")
            sv = got["serve"]
            if not got["seq_cut"] or not sv["prefill_gathers"]:
                fail(f"lm-mesh (h) {label} rank {r}: the residual was not "
                     f"cut by sequence (training {got['seq_cut']}, "
                     f"{sv['prefill_gathers']} gathers in the prefill)")
            if got["uncut"] or not got["cut"] or not got["split"] \
                    or got["param_bytes"] != got["reckoned"]:
                fail(f"lm-mesh (h) {label} rank {r}: {got['param_bytes']} "
                     f"parameter bytes held against the layout's "
                     f"{got['reckoned']}; whole where cut: {got['uncut']}")
            if not got["per_axis"].get("model"):
                fail(f"lm-mesh (h) {label} rank {r}: no call on the model "
                     f"axis: {got['per_axis']}")
            rows = slice(*sv["rows"])
            gap = float(np.abs(sv["logits"] - served["logits"][rows]).max())
            has_kv = arch != "rwkv6-3b"
            if sv["cut"] != has_kv or not np.array_equal(
                    sv["tokens"], served["tokens"][rows]) \
                    or not np.allclose(sv["logits"], served["logits"][rows],
                                       rtol=LM_MESH_RTOL, atol=LM_MESH_ATOL):
                fail(f"lm-mesh (h) {label} rank {r}: serving (caches cut by "
                     f"sequence: {sv['cut']}) gave tokens "
                     f"{sv['tokens'].tolist()} against one rank's "
                     f"{served['tokens'][rows].tolist()}, logits "
                     f"{gap:.3e} off (rtol {LM_MESH_RTOL} / atol "
                     f"{LM_MESH_ATOL})")
            per_op = ", ".join(f"{k} {v:.0f}"
                               for k, v in got["per_op"].items() if v)
            per_axis = ", ".join(f"{k} {v:.0f}" for k, v in
                                 sorted(got["per_axis"].items()))
            med = statistics.median(got["step_ms"][1:])
            f_run = whole_f[r]
            f_ms = statistics.median(f_run["step_ms"][1:])
            phase("lm-mesh", lm_mesh_line(f"(h) {label} rank {r}", got, smi)
                  + f"; calls a step by op: {per_op}; by axis: {per_axis}; "
                  f"step {med / f_ms:.2f}x (f)'s {f_ms:.1f} ms without the "
                  f"rule, peak against (f)'s {f_run['peak'] / 1e9:.2f} GB; "
                  f"largest parameter difference {got['worst']:.2e}; "
                  f"served rows {sv['rows'][0]}-{sv['rows'][1] - 1}: "
                  f"prefill {LM_MESH_PROMPT} tokens {sv['prefill_ms']:.1f} "
                  f"ms ({sv['prefill_gathers']} sequence gathers; one rank "
                  f"{served['prefill_ms']:.1f}), decode "
                  f"{sv['decode_ms']:.1f} ms a step (one rank "
                  f"{served['decode_ms']:.1f}), {LM_MESH_DECODE} greedy "
                  f"tokens equal to one rank's, logits within {gap:.2e}; "
                  f"cache {sv['cache_bytes'] / 1e6:.2f} MB held against "
                  f"the whole {sv['whole_cache_bytes'] / 1e6:.2f} MB of its "
                  f"rows")
        phase("lm-mesh", f"(h) {label}: FSDP, split by heads, the act rule "
              f"\"seq\" -> \"model\" at (data={LM_MESH_DATA}, model="
              f"{LM_MESH_MODEL}) vs one rank ({LM_MESH_LAYERS} layers at full "
              f"width, {LM_MESH_STEPS} steps of {LM_MESH_BATCH} x "
              f"{LM_MESH_TP_SEQ}): {', '.join(keys)} each step within rtol "
              f"{LM_MESH_RTOL}, final parameters within rtol {LM_MESH_RTOL} "
              f"/ atol {LM_MESH_ATOL}, the residual cut in training and "
              f"prefill; {LM_MESH_DECODE} greedy tokens equal")


def lm_mesh_compress_check(world: list, one: dict, plain: dict,
                           smi: str) -> None:
    """(i): (a) with each of LM_MESH_COMPRESSORS on every rank against
    one rank with the same compressor: metrics at (a)'s limits, the code
    rule (`lm_mesh_code_check`), the final parameters at (a)'s limits
    but where a step's codes differed, at most LM_MESH_MAX_ALL_MAX
    `all_max` calls a compression, an error-feedback residual of the
    rank's gradient slices' bytes."""
    keys = ("loss", "total_loss", "tokens", "grad_norm")
    plain_ms = statistics.median(plain["step_ms"][1:])
    for kind in LM_MESH_COMPRESSORS:
        want = one[kind]
        one_ms = statistics.median(want["step_ms"][1:])
        for run in world:
            got, r = run["compress"][kind], run["rank"]
            for s, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
                for k in keys:
                    if not abs(g[k] - w[k]) <= LM_MESH_RTOL * abs(w[k]) + 1e-7:
                        fail(f"lm-mesh (i) {kind} rank {r} step {s + 1}: {k} "
                             f"{g[k]!r} vs one rank's {w[k]!r} (rtol "
                             f"{LM_MESH_RTOL})")
            if got["code_faults"]:
                fail(f"lm-mesh (i) {kind} rank {r}: the code rule: "
                     f"{'; '.join(got['code_faults'][:10])}")
            if got["misses"]:
                fail(f"lm-mesh (i) {kind} rank {r}: {got['misses']} "
                     f"parameter elements past rtol {LM_MESH_RTOL} / atol "
                     f"{LM_MESH_ATOL} of one rank's (STEPS x lr more where "
                     f"a code differed; largest difference "
                     f"{got['worst']:.3e}): {'; '.join(got['where'])}")
            calls = got["all_max"]
            if len(calls) != LM_MESH_STEPS or not all(
                    0 < n <= LM_MESH_MAX_ALL_MAX for n in calls):
                fail(f"lm-mesh (i) {kind} rank {r}: all_max calls a "
                     f"compression {calls} (1 to {LM_MESH_MAX_ALL_MAX})")
            residual = ""
            if kind == "int8_ef":
                if got["residual_bytes"] != got["residual_reckoned"]:
                    fail(f"lm-mesh (i) {kind} rank {r}: the residual holds "
                         f"{got['residual_bytes']} bytes, its gradient "
                         f"slices {got['residual_reckoned']}")
                residual = (f"; residual {got['residual_bytes'] / 1e9:.3f} "
                            f"GB = the gradient slices' reckoning (one rank "
                            f"{want['residual_bytes'] / 1e9:.3f})")
            where = got["code_where"]
            med = statistics.median(got["step_ms"][1:])
            own = run.get(LM_MESH_ARCHS[0])   # this rank's (a) run
            versus = (f"{med / statistics.median(own['step_ms'][1:]):.2f}x "
                      f"this rank's uncompressed (a) step" if own else
                      f"one rank uncompressed {plain_ms:.1f} ms")
            phase("lm-mesh", lm_mesh_line(f"(i) {kind} rank {r}", got, smi)
                  + f" (with the codes copied to the host each step); "
                  f"step {versus}, one rank compressed {one_ms:.1f} ms; "
                  f"all_max calls a compression {calls}"
                  f"{residual}; {got['code_misses']} codes differ from one "
                  f"rank's over {LM_MESH_STEPS} steps ("
                  + ("; ".join(where[:8]) + (f"; and {len(where) - 8} more"
                                             if len(where) > 8 else "")
                     if where else "none")
                  + f"), at most {got['first_most']} in a leaf on the "
                  f"first step, {got['wide']} of them past the strict "
                  f"parameter tolerance; largest parameter difference "
                  f"{got['worst']:.2e}")
        phase("lm-mesh", f"(i) {LM_MESH_ARCHS[0]} {kind} (data={LM_MESH_DATA}"
              f", model={LM_MESH_MODEL}) vs one rank with the same "
              f"compressor: {', '.join(keys)} each step within rtol "
              f"{LM_MESH_RTOL}; scales within 1e-6 + 1e-4 |s|, the first "
              f"step's codes equal but within {LM_MESH_TIE} of a tie (at "
              f"most {LM_MESH_MAX_MISSES} in a leaf of up to "
              f"{LM_MESH_CAP_ELEMENTS} elements, each in a larger one with "
              f"the two gradients within 1e-6 + 1e-4 |x|); final "
              f"parameters within "
              f"rtol {LM_MESH_RTOL} / atol {LM_MESH_ATOL} but {LM_MESH_STEPS}"
              f" x lr more where a code differed; one rank {one_ms:.1f} ms a "
              f"step (the codes copied to the host each step) against "
              f"{plain_ms:.1f} uncompressed ({smi})")


def lm_mesh_phase(torch, smi, figures: dict) -> dict:
    """The LM on the mesh (module docstring, `[lm-mesh]`): the one-rank
    runs alone first, then one world of LM_MESH_DATA x LM_MESH_MODEL
    gloo ranks sharing the card for (a) to (f), (h), (i) and (c), then one of
    LM_MESH_UNEVEN_MODEL for (g) (`lm_mesh_uneven`); (h) and (i) run in
    the first world, against one-rank runs of theirs.  Returns every
    kernel's launches (all must be 0); each rank's (a) run goes into
    ``figures["lm-mesh"]`` for `[dryrun]` (b), and so on."""
    import gc
    import tempfile
    from repro_torch.distributed.launch import run_ranks
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    zero_launches()
    ranks = LM_MESH_DATA * LM_MESH_MODEL
    tp_archs = tuple(dict.fromkeys(a for a, _ in LM_MESH_TP_RUNS))
    with tempfile.TemporaryDirectory(prefix="lm_mesh_") as tmp:
        paths = {a: os.path.join(tmp, f"{i}.pt") for i, a in enumerate(
            LM_MESH_ARCHS + tp_archs + LM_MESH_COMPRESSORS
            + ("adafactor", "pipeline"))}
        one = {a: lm_mesh_train(torch, a, None, paths[a],
                                serve=a == LM_MESH_ARCHS[0])
               for a in LM_MESH_ARCHS}
        one_tp = {a: lm_mesh_train(torch, a, None, paths[a], serve=True,
                                   seq=LM_MESH_TP_SEQ,
                                   micro=LM_MESH_TP_MICRO)
                  for a in tp_archs}
        one_ada = lm_mesh_train(torch, LM_MESH_ADAFACTOR, None,
                                paths["adafactor"], seq=LM_MESH_TP_SEQ,
                                micro=LM_MESH_TP_MICRO,
                                optimizer="adafactor")
        one_comp = {kind: lm_mesh_train(torch, LM_MESH_ARCHS[0], None,
                                        paths[kind], compressor=kind)
                    for kind in LM_MESH_COMPRESSORS}
        pipe_one = lm_mesh_pipeline(torch, None, paths["pipeline"])
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        world = run_ranks(lm_mesh_rank, ranks, args=(paths,),
                          backend="gloo", device=DEVICE + ":0",
                          timeout_s=LM_MESH_TIMEOUT_S)
        world_s = time.perf_counter() - t1
    runs = []
    for run in world:
        r = run["rank"]
        runs += [(f"{label} {arch}", r, run[arch], one[arch])
                 for label, arch in (("(a)", LM_MESH_ARCHS[0]),
                                     ("(b)", LM_MESH_ARCHS[1]))]
        runs += [(label, r, run[key], one[LM_MESH_ARCHS[0]])
                 for label, key in (("(d)", "fsdp"), ("(e)", "seq"))]
        runs += [(f"({part}) {label}", r, run["tp"][label], one_tp[arch])
                 for part, arch, label in
                 [("f", a, lm_mesh_tp_label(a, rules))
                  for a, rules in LM_MESH_TP_RUNS]
                 + [("h", a, lm_mesh_tp_label(a, LM_MESH_SEQ_RULES))
                    for a in LM_MESH_SEQ_FAMILIES]]
        runs.append((f"(f) {LM_MESH_ADAFACTOR} adafactor", r,
                     run["adafactor"], one_ada))
        runs += [(f"(i) {kind}", r, run["compress"][kind], one_comp[kind])
                 for kind in LM_MESH_COMPRESSORS]
    lm_mesh_judged_lines(runs, smi)
    figures["lm-mesh"] = sorted(
        ({"rank": run["rank"], **run[LM_MESH_ARCHS[0]]} for run in world),
        key=lambda r: r["rank"])
    figures["lm-mesh-fsdp"] = sorted(
        ({"rank": run["rank"], **run["fsdp"]} for run in world),
        key=lambda r: r["rank"])
    figures["lm-mesh-seq"] = sorted(
        ({"rank": run["rank"], **run["seq"]} for run in world),
        key=lambda r: r["rank"])
    figures["lm-mesh-tp"] = {
        label: sorted(({"rank": run["rank"], **run["tp"][label]}
                       for run in world), key=lambda r: r["rank"])
        for label in world[0]["tp"]}
    launches = read_launches()
    for run in world:
        for k, v in run["launches"].items():
            launches[k] += v
    if any(launches.values()):
        fail(f"lm-mesh: a kernel of the port was launched: {launches} (the "
             "LM mesh step reaches none)")
    for label, arch in (("(a)", LM_MESH_ARCHS[0]), ("(b)", LM_MESH_ARCHS[1])):
        want = one[arch]
        whole, split = lm_mesh_expected_bytes(torch, arch)
        if want["param_bytes"] != whole:
            fail(f"lm-mesh {label}: one rank holds {want['param_bytes']} "
                 f"parameter bytes, the model {whole}")
        if arch == LM_MESH_ARCHS[1] and not all(
                m["moe_drop_fraction"] > 0 for m in want["metrics"]):
            fail(f"lm-mesh {label}: no token dropped at capacity factor "
                 f"1.0: {[m['moe_drop_fraction'] for m in want['metrics']]}")
        phase("lm-mesh", lm_mesh_line(f"{label} {arch} one rank", want, smi)
              + f"; losses {[round(m['loss'], 5) for m in want['metrics']]}")
        keys = ("loss", "total_loss", "tokens", "grad_norm") + (
            ("moe_lb_loss", "moe_z_loss", "moe_drop_fraction")
            if arch == LM_MESH_ARCHS[1] else ())
        for run in world:
            got, r = run[arch], run["rank"]
            for s, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
                for k in keys:
                    if not abs(g[k] - w[k]) <= LM_MESH_RTOL * abs(w[k]) + 1e-7:
                        fail(f"lm-mesh {label} rank {r} step {s + 1}: {k} "
                             f"{g[k]!r} vs one rank's {w[k]!r} (rtol "
                             f"{LM_MESH_RTOL})")
            if got["misses"]:
                fail(f"lm-mesh {label} rank {r}: {got['misses']} parameter "
                     f"elements past rtol {LM_MESH_RTOL} / atol "
                     f"{LM_MESH_ATOL} of one rank's (largest difference "
                     f"{got['worst']:.3e}): {'; '.join(got['where'])}")
            if got["param_bytes"] != split:
                fail(f"lm-mesh {label} rank {r}: {got['param_bytes']} "
                     f"parameter bytes held, the split's reckoning {split}")
            if arch == LM_MESH_ARCHS[0] and (
                    got["param_bytes"] > LM_MESH_PARAM_SHARE * whole
                    or got["opt_bytes"] * LM_MESH_OPT_SHRINK
                    > want["opt_bytes"]):
                fail(f"lm-mesh {label} rank {r}: {got['param_bytes']} "
                     f"parameter and {got['opt_bytes']} optimizer bytes "
                     f"against one rank's {whole} and {want['opt_bytes']} "
                     f"(at most {LM_MESH_PARAM_SHARE} and "
                     f"1/{LM_MESH_OPT_SHRINK})")
            phase("lm-mesh", lm_mesh_line(f"{label} rank {r}", got, smi)
                  + f" ({got['param_bytes'] / whole:.3f} and "
                  f"{got['opt_bytes'] / want['opt_bytes']:.3f} of one "
                  f"rank's); {got['split']} of {got['leaves']} leaves split "
                  f"over model, largest parameter difference "
                  f"{got['worst']:.2e}")
        extra = (", moe_drop_fraction "
                 f"{[round(m['moe_drop_fraction'], 4) for m in want['metrics']]}"
                 if arch == LM_MESH_ARCHS[1] else "")
        phase("lm-mesh", f"{label} {arch} (data={LM_MESH_DATA}, model="
              f"{LM_MESH_MODEL}) vs one rank: {', '.join(keys)} each step "
              f"within rtol {LM_MESH_RTOL}, final parameters within rtol "
              f"{LM_MESH_RTOL} / atol {LM_MESH_ATOL}{extra}")
    lm_mesh_fsdp_check(world, one[LM_MESH_ARCHS[0]], smi)
    lm_mesh_seq_check(world, one[LM_MESH_ARCHS[0]], figures["lm-mesh-fsdp"],
                      smi)
    lm_mesh_tp_check(figures["lm-mesh-tp"], one_tp, smi)
    lm_mesh_adafactor_check(world, one_ada, smi)
    lm_mesh_seq_families_check(figures["lm-mesh-tp"], one_tp, smi)
    lm_mesh_compress_check(world, one_comp, one[LM_MESH_ARCHS[0]], smi)
    with tempfile.TemporaryDirectory(prefix="lm_mesh_g_") as tmp:
        for k, v in lm_mesh_uneven(torch, smi, figures, tmp).items():
            launches[k] += v
    if any(launches.values()):
        fail(f"lm-mesh (g): a kernel of the port was launched: {launches}")
    lm_mesh_pipeline_check(torch, [run["pipeline"] for run in world],
                           pipe_one, smi)
    phase("lm-mesh", f"kernel launches 0 (none on this path); world "
          f"{world_s:.1f}s, phase {time.perf_counter() - t0:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# the dry run against the card: [lm-train] (c) and [lm-mesh] (a) traced
# on meta tensors, the production cells of qwen2.5-32b, the card's memory
# ---------------------------------------------------------------------------

DRYRUN_TOL = 0.10           # a dry-run peak against the card's measured one
DRYRUN_CELLS = (("qwen2.5-32b", "train_4k"), ("qwen2.5-32b", "prefill_32k"),
                ("qwen2.5-32b", "decode_32k"),
                ("command-r-plus-104b", "train_4k"))
DRYRUN_TIMEOUT_S = 900
DRYRUN_WORKERS = 6          # trace processes beside [lm-mesh]


def dryrun_job(job: tuple):
    """One trace of `[dryrun]`, in a spawned process on the CPU (nothing
    touches the card): ("lm-train",) traces `[lm-train]` (c)'s step on
    one rank; ("lm-mesh",) rank 0 of `[lm-mesh]` (a) in a fake world of
    its ranks, ("lm-mesh-fsdp",) that of (d), ("lm-mesh-seq",) that of
    (e); ("lm-mesh-tp", arch, seq) that of an (f) run (under the "seq"
    rule where `seq`); ("lm-mesh-uneven", arch) rank 0 of (g)'s run of
    `arch` in a fake world of its 16 ranks; ("cell", arch, shape)
    `run_cell` at 16 x 16 (the cell's rule overrides applied) and its
    `analyze` row."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.dryrun import fake_world, run_cell, trace_train
    t0 = time.perf_counter()
    if job[0] == "lm-train":
        from repro_torch.launch.specs import pick_optimizer
        cfg = train_config(TRAIN_ARCH)
        tokens = ((TRAIN_FULL_BATCH, TRAIN_FULL_SEQ), torch.int32)
        out = trace_train(cfg, pick_optimizer(cfg),
                          {"tokens": tokens, "labels": tokens})
    elif job[0] in ("lm-mesh", "lm-mesh-fsdp", "lm-mesh-seq"):
        from repro_torch.distributed import partition
        from repro_torch.train.optimizer import AdamW
        cfg = lm_mesh_config(LM_MESH_ARCHS[0])
        shape = (LM_MESH_BATCH, LM_MESH_SEQ)
        batch = {"tokens": (shape, torch.int64), "labels": (shape, torch.int64),
                 "loss_mask": (shape, torch.float32)}
        with fake_world(LM_MESH_DATA * LM_MESH_MODEL):
            plan = partition.make_plan(
                model_parallel=LM_MESH_MODEL, device="cpu",
                act_rules=LM_MESH_SEQ_RULES if job[0] == "lm-mesh-seq"
                else None)
            out = trace_train(cfg, AdamW(learning_rate=LM_MESH_LR), batch,
                              plan=plan, n_microbatches=LM_MESH_MICRO,
                              place=job[0] != "lm-mesh")
    elif job[0] == "lm-mesh-tp":
        from repro_torch.distributed import partition
        from repro_torch.train.optimizer import AdamW
        cfg = lm_mesh_config(job[1])
        shape = (LM_MESH_BATCH, LM_MESH_TP_SEQ)
        batch = {"tokens": (shape, torch.int64), "labels": (shape, torch.int64),
                 "loss_mask": (shape, torch.float32)}
        if cfg.family == "audio":
            batch["audio_embeds"] = ((LM_MESH_BATCH, LM_MESH_TP_FRAMES,
                                      cfg.d_model), torch.float32)
        with fake_world(LM_MESH_DATA * LM_MESH_MODEL):
            plan = partition.make_plan(
                model_parallel=LM_MESH_MODEL, device="cpu",
                act_rules=LM_MESH_SEQ_RULES if job[2] else None)
            out = trace_train(cfg, AdamW(learning_rate=LM_MESH_LR), batch,
                              plan=plan, n_microbatches=LM_MESH_TP_MICRO,
                              place=True)
    elif job[0] == "lm-mesh-uneven":
        from repro_torch.distributed import partition
        from repro_torch.train.optimizer import AdamW
        cfg = lm_mesh_config(job[1])
        shape = (LM_MESH_UNEVEN_ROWS, LM_MESH_UNEVEN_SEQ)
        batch = {"tokens": (shape, torch.int64), "labels": (shape, torch.int64),
                 "loss_mask": (shape, torch.float32)}
        with fake_world(LM_MESH_UNEVEN_MODEL):
            plan = partition.make_plan(model_parallel=LM_MESH_UNEVEN_MODEL,
                                       device="cpu")
            out = trace_train(cfg, AdamW(learning_rate=LM_MESH_LR), batch,
                              plan=plan, n_microbatches=1)
    else:
        from repro_torch.launch.roofline import analyze
        row = run_cell(job[1], job[2], multi_pod=False, verbose=False)
        out = {"row": row, "roofline": analyze(row).as_dict()}
    out["seconds"] = time.perf_counter() - t0
    return out


def dryrun_peak(trace: dict) -> int:
    """The window a card's ``max_memory_allocated`` covers: the setup
    (build, split, state) and the step."""
    return max(trace["setup_peak"], trace["peak"]["total"])


def dryrun_gap(label: str, predicted: int, measured: int) -> float:
    gap = predicted / measured - 1.0
    if abs(gap) > DRYRUN_TOL:
        fail(f"dryrun {label}: the dry run's peak {predicted / 1e9:.3f} GB "
             f"is {gap * 100:+.1f}% off the card's {measured / 1e9:.3f} GB "
             f"(limit {DRYRUN_TOL * 100:.0f}%)")
    return gap


def dryrun_breakdown(trace: dict) -> str:
    p = trace["peak"]
    parts = sorted(trace.get("rest_by_part", {}).items(),
                   key=lambda kv: -kv[1])
    by_part = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts[:4])
    return (f"step peak {p['total'] / 1e9:.3f} GB = parameters "
            f"{p['params'] / 1e9:.3f} + gradients {p['grads'] / 1e9:.3f} + "
            f"optimizer {p['opt_state'] / 1e9:.3f} + gathered "
            f"{p['gathered'] / 1e9:.3f} + the rest "
            f"{p['rest'] / 1e9:.3f} (most of it: {by_part}); setup peak "
            f"{trace['setup_peak'] / 1e9:.3f} GB")


def dryrun_hbm_check(torch) -> str:
    """(d) `HBM_PER_CARD` against this card: its total memory less what
    the CUDA context and the other processes hold now (free and
    PyTorch's reserved bytes taken off), within 1%."""
    from repro_torch.launch.specs import HBM_PER_CARD
    total = torch.cuda.get_device_properties(0).total_memory
    free, _ = torch.cuda.mem_get_info()
    reserve = total - free - torch.cuda.memory_reserved()
    usable = total - reserve
    if abs(usable - HBM_PER_CARD) > 0.01 * HBM_PER_CARD:
        fail(f"dryrun (d): HBM_PER_CARD {HBM_PER_CARD} against this card's "
             f"{usable} ({total} total less {reserve} outside PyTorch)")
    return (f"(d) HBM_PER_CARD {HBM_PER_CARD} B against this card's "
            f"{usable} B ({total} total less {reserve} held outside "
            f"PyTorch's allocator now): {(HBM_PER_CARD / usable - 1) * 100:+.2f}%")


def dryrun_fsdp_check(trace: dict, ranks: list, smi: str,
                      label: str = "(b')", run: str = "(d)",
                      layout: str = "FSDP",
                      arch: str = LM_MESH_ARCHS[0]) -> None:
    """(b'): rank 0 of `[lm-mesh]` (d) traced against the card's rank 0:
    its calls a step per op and the bytes held equal, its peak within
    DRYRUN_TOL of the measured one ((b''): the same for (e); (b5) for
    each (h) run of `arch`)."""
    rank0 = ranks[0]
    per_op = {k: v["count"] for k, v in trace["collectives"]["per_op"].items()}
    held = trace["held"]
    if per_op != {k: round(v) for k, v in rank0["per_op"].items()} \
            or held != {"params": rank0["param_bytes"],
                        "opt_state": rank0["opt_bytes"]}:
        fail(f"dryrun {label}: the dry run's calls a step {per_op} and "
             f"{held} bytes held, rank 0's {rank0['per_op']}, "
             f"{rank0['param_bytes']} parameter and {rank0['opt_bytes']} "
             "optimizer bytes")
    gap = dryrun_gap(label, dryrun_peak(trace), rank0["peak"])
    by_axis = ", ".join(f"{k} {v['count']} ({v['bytes'] / 1e9:.3f} GB)"
                        for k, v in trace["collectives"]["per_axis"].items())
    phase("dryrun", f"{label} {arch} {layout} at (data="
          f"{LM_MESH_DATA}, model={LM_MESH_MODEL}), rank 0 of a fake world "
          f"of {LM_MESH_DATA * LM_MESH_MODEL} (the [lm-mesh] {run} run): calls a "
          f"step {per_op} and {held['params'] / 1e9:.3f} / "
          f"{held['opt_state'] / 1e9:.3f} GB of parameters / optimizer "
          f"state held, equal to rank 0's on the card; dry-run peak "
          f"{dryrun_peak(trace) / 1e9:.3f} GB against rank 0's "
          f"{rank0['peak'] / 1e9:.3f} GB ({smi}; ranks "
          + ", ".join(f"{r['peak'] / 1e9:.3f}" for r in ranks)
          + f"): {gap * 100:+.2f}% (limit {DRYRUN_TOL * 100:.0f}%); "
          f"{dryrun_breakdown(trace)}; by axis {by_axis}; traced in "
          f"{trace['seconds']:.1f}s")


def dryrun_tp_check(trace: dict, ranks: list, label: str, smi: str) -> None:
    """(b'''): rank 0 of an `[lm-mesh]` (f) run traced against the card's
    rank 0: its calls a step per op and per mesh axis and the bytes held
    equal; the traced peak printed beside the measured one."""
    rank0 = ranks[0]
    coll = trace["collectives"]
    per_op = {k: v["count"] for k, v in coll["per_op"].items()}
    per_axis = {k: v["count"] for k, v in coll["per_axis"].items()}
    held = trace["held"]
    if per_op != {k: round(v) for k, v in rank0["per_op"].items()} \
            or per_axis != {k: round(v) for k, v in
                            rank0["per_axis"].items()} \
            or held != {"params": rank0["param_bytes"],
                        "opt_state": rank0["opt_bytes"]}:
        fail(f"dryrun (b''') {label}: the dry run's calls a step {per_op}, "
             f"by axis {per_axis} and {held} bytes held, rank 0's "
             f"{rank0['per_op']}, {rank0['per_axis']}, "
             f"{rank0['param_bytes']} parameter and {rank0['opt_bytes']} "
             "optimizer bytes")
    gap = dryrun_peak(trace) / rank0["peak"] - 1.0
    phase("dryrun", f"(b''') {label} FSDP split by heads at (data="
          f"{LM_MESH_DATA}, model={LM_MESH_MODEL}), rank 0 of a fake world "
          f"of {LM_MESH_DATA * LM_MESH_MODEL} (the [lm-mesh] (f) run): calls "
          f"a step {per_op}, by axis {per_axis}, and "
          f"{held['params'] / 1e9:.3f} / {held['opt_state'] / 1e9:.3f} GB "
          f"of parameters / optimizer state held, equal to rank 0's on the "
          f"card; dry-run peak {dryrun_peak(trace) / 1e9:.3f} GB against "
          f"rank 0's {rank0['peak'] / 1e9:.3f} GB ({smi}): "
          f"{gap * 100:+.2f}% (reported, not held to a limit); "
          f"{dryrun_breakdown(trace)}; traced in {trace['seconds']:.1f}s")


def dryrun_uneven_check(trace: dict, ranks: list, smi: str,
                        arch: str) -> None:
    """(b''''): rank 0 of `[lm-mesh]` (g)'s run of `arch` traced against
    the card's rank 0: its calls a step per op and per mesh axis and the
    bytes held equal, the traced peak within DRYRUN_TOL."""
    rank0 = ranks[0]
    coll = trace["collectives"]
    per_op = {k: v["count"] for k, v in coll["per_op"].items()}
    per_axis = {k: v["count"] for k, v in coll["per_axis"].items()}
    held = trace["held"]
    if per_op != {k: round(v) for k, v in rank0["per_op"].items()} \
            or per_axis != {k: round(v) for k, v in
                            rank0["per_axis"].items()} \
            or held != {"params": rank0["param_bytes"],
                        "opt_state": rank0["opt_bytes"]}:
        fail(f"dryrun (b'''') (g) {arch}: the dry run's calls a step "
             f"{per_op}, by axis {per_axis} and {held} bytes held, rank "
             f"0's {rank0['per_op']}, {rank0['per_axis']}, "
             f"{rank0['param_bytes']} parameter and {rank0['opt_bytes']} "
             "optimizer bytes")
    gap = dryrun_gap(f"(b'''') {arch}", dryrun_peak(trace), rank0["peak"])
    phase("dryrun", f"(b'''') {arch} {LM_MESH_UNEVEN_WHAT[arch]}, at "
          f"(data=1, model={LM_MESH_UNEVEN_MODEL}), rank 0 of a fake world "
          f"of {LM_MESH_UNEVEN_MODEL} (the [lm-mesh] (g) run): calls a step "
          f"{per_op}, by axis {per_axis}, and {held['params'] / 1e9:.3f} / "
          f"{held['opt_state'] / 1e9:.3f} GB of parameters / optimizer "
          f"state held, equal to rank 0's on the card; dry-run peak "
          f"{dryrun_peak(trace) / 1e9:.3f} GB against rank 0's "
          f"{rank0['peak'] / 1e9:.3f} GB ({smi}; ranks "
          f"{min(r['peak'] for r in ranks) / 1e9:.3f}-"
          f"{max(r['peak'] for r in ranks) / 1e9:.3f}): {gap * 100:+.2f}% "
          f"(limit {DRYRUN_TOL * 100:.0f}%); {dryrun_breakdown(trace)}; "
          f"traced in {trace['seconds']:.1f}s")


def dryrun_jobs() -> list:
    """`[dryrun]`'s traces, in the order `dryrun_phase` reads them."""
    tp = [("lm-mesh-tp", arch, bool(rules))
          for arch, rules in LM_MESH_TP_RUNS]
    fam = [("lm-mesh-tp", arch, True) for arch in LM_MESH_SEQ_FAMILIES]
    return [("lm-train",), ("lm-mesh",), ("lm-mesh-fsdp",),
            ("lm-mesh-seq",)] + tp + [("cell",) + c for c in DRYRUN_CELLS] \
        + [("lm-mesh-uneven", arch) for arch in LM_MESH_UNEVEN_ARCHS] + fam


def dryrun_start():
    """Start `[dryrun]`'s traces (`dryrun_jobs`) in DRYRUN_WORKERS
    spawned processes on the CPU, the production cells (the longest)
    first: they read nothing of the card or of the phases' results, so
    they run beside `[lm-mesh]`, leaving host cores to its gloo ranks,
    and `dryrun_phase` collects them.  Returns (pool, futures in
    `dryrun_jobs` order, start)."""
    import concurrent.futures
    import multiprocessing
    jobs = dryrun_jobs()
    pool = concurrent.futures.ProcessPoolExecutor(
        min(len(jobs), DRYRUN_WORKERS),
        mp_context=multiprocessing.get_context("spawn"))
    order = sorted(range(len(jobs)), key=lambda i: jobs[i][0] != "cell")
    futures = {i: pool.submit(dryrun_job, jobs[i]) for i in order}
    return pool, [futures[i] for i in range(len(jobs))], time.perf_counter()


def dryrun_phase(torch, smi, figures: dict, started=None) -> dict:
    """The dry run (`repro_torch.launch.dryrun`) held to the card: (a)
    `[lm-train]` (c)'s step traced on one rank against its measured
    ``max_memory_allocated``; (b) rank 0 of `[lm-mesh]` (a) traced in a
    fake world of its 4 ranks against rank 0's measured peak, its
    `torch.distributed` calls a step (equal) and the parameter and
    optimizer bytes it held (equal); (b') the same for rank 0 of
    `[lm-mesh]` (d) (FSDP), its calls per op equal; (b'') the same for
    (e) (FSDP + sequence parallel); (b''') each (f) run (the families
    split by heads), its calls per op and per axis equal; (b'''') the
    same for each `[lm-mesh]` (g) run (granite's experts cut by hidden
    width and attention cut at rest, rwkv6's time mix by value columns,
    at model 16), its peak within DRYRUN_TOL too; (b5) as
    (b'') for each `[lm-mesh]` (h) run; (c)
    qwen2.5-32b's three cells and
    command-r-plus-104b's train_4k at 16 x 16, placed (FSDP), their
    ``"seq"`` overrides applied, `run_cell` and `analyze` rows; (d)
    `HBM_PER_CARD` against the card.  The traces run in
    spawned processes on the CPU, side by side; every kernel's launch
    count must stay 0.  ``started``: the traces `dryrun_start` began
    earlier (else they start here)."""
    t0 = time.perf_counter()
    zero_launches()
    pool, futures, begun = started or dryrun_start()
    with pool:
        done = dict(zip(dryrun_jobs(), [f.result(timeout=DRYRUN_TIMEOUT_S)
                                        for f in futures]))
    phase("dryrun", f"the traces' results {time.perf_counter() - t0:.1f}s "
          f"after this phase began, {time.perf_counter() - begun:.1f}s "
          "after they were started")
    one, mesh, placed, seq = (done[(job,)] for job in (
        "lm-train", "lm-mesh", "lm-mesh-fsdp", "lm-mesh-seq"))
    tp_traces = [done[("lm-mesh-tp", arch, bool(rules))]
                 for arch, rules in LM_MESH_TP_RUNS]
    fam_traces = [done[("lm-mesh-tp", arch, True)]
                  for arch in LM_MESH_SEQ_FAMILIES]
    cells = [done[("cell",) + c] for c in DRYRUN_CELLS]

    measured = figures["lm-train"]["peak"]
    gap = dryrun_gap("(a)", dryrun_peak(one), measured)
    phase("dryrun", f"(a) {TRAIN_ARCH} one rank, 1 x {TRAIN_FULL_SEQ}, "
          f"fp32 parameters, bf16 compute, AdamW (the [lm-train] (c) run): "
          f"dry-run peak {dryrun_peak(one) / 1e9:.3f} GB against the card's "
          f"max_memory_allocated {measured / 1e9:.3f} GB ({smi}): "
          f"{gap * 100:+.2f}% (limit {DRYRUN_TOL * 100:.0f}%); "
          f"{dryrun_breakdown(one)}; {one['flops'] / 1e12:.1f} TFLOP "
          f"counted; traced in {one['seconds']:.1f}s")
    rank0 = figures["lm-mesh"][0]
    calls = mesh["collectives"]["n_ops"]
    held = mesh["held"]
    if calls != rank0["calls"] or held != {"params": rank0["param_bytes"],
                                           "opt_state": rank0["opt_bytes"]}:
        fail(f"dryrun (b): the dry run's {calls} torch.distributed calls a "
             f"step and {held} bytes held, rank 0's {rank0['calls']} calls, "
             f"{rank0['param_bytes']} parameter and {rank0['opt_bytes']} "
             "optimizer bytes")
    gap = dryrun_gap("(b)", dryrun_peak(mesh), rank0["peak"])
    per_op = ", ".join(f"{k} {v['count']} ({v['bytes'] / 1e9:.3f} GB)"
                       for k, v in mesh["collectives"]["per_op"].items()
                       if v["count"])
    phase("dryrun", f"(b) {LM_MESH_ARCHS[0]} {LM_MESH_LAYERS} layers at "
          f"(data={LM_MESH_DATA}, model={LM_MESH_MODEL}), rank 0 of a fake "
          f"world of {LM_MESH_DATA * LM_MESH_MODEL} (the [lm-mesh] (a) run): "
          f"{calls} torch.distributed calls a step and "
          f"{held['params'] / 1e9:.3f} / {held['opt_state'] / 1e9:.3f} GB "
          f"of parameters / optimizer state held, equal to rank 0's on the "
          f"card; dry-run peak {dryrun_peak(mesh) / 1e9:.3f} GB against "
          f"rank 0's {rank0['peak'] / 1e9:.3f} GB ({smi}; ranks "
          + ", ".join(f"{r['peak'] / 1e9:.3f}" for r in figures["lm-mesh"])
          + f"): {gap * 100:+.2f}% (limit {DRYRUN_TOL * 100:.0f}%); "
          f"{dryrun_breakdown(mesh)}; calls {per_op}; traced in "
          f"{mesh['seconds']:.1f}s")
    dryrun_fsdp_check(placed, figures["lm-mesh-fsdp"], smi)
    dryrun_fsdp_check(seq, figures["lm-mesh-seq"], smi, "(b'')", "(e)",
                      "FSDP + sequence parallel")
    for (arch, rules), trace in zip(LM_MESH_TP_RUNS, tp_traces):
        label = lm_mesh_tp_label(arch, rules)
        dryrun_tp_check(trace, figures["lm-mesh-tp"][label], label, smi)
    for arch in LM_MESH_UNEVEN_ARCHS:
        dryrun_uneven_check(done[("lm-mesh-uneven", arch)],
                            figures["lm-mesh-uneven"][arch], smi, arch)
    for arch, trace in zip(LM_MESH_SEQ_FAMILIES, fam_traces):
        label = lm_mesh_tp_label(arch, LM_MESH_SEQ_RULES)
        dryrun_fsdp_check(trace, figures["lm-mesh-tp"][label], smi, "(b5)",
                          "(h)", "FSDP split by heads + sequence parallel",
                          arch=arch)
    for (arch, shape), cell in zip(DRYRUN_CELLS, cells):
        row, roof = cell["row"], cell["roofline"]
        p = row["peak_bytes_per_device"]
        coll = row["collectives"]
        phase("dryrun", f"(c) {arch} {shape} at 16x16 (rank 0 of 256): "
              f"peak {p['total'] / 1e9:.2f} GB a rank (parameters "
              f"{p['params'] / 1e9:.2f}, gradients {p['grads'] / 1e9:.2f}, "
              f"optimizer {p['opt_state'] / 1e9:.2f}, cache "
              f"{p['cache'] / 1e9:.2f}, gathered {p['gathered'] / 1e9:.2f}, "
              f"rest {p['rest'] / 1e9:.2f}), fit "
              f"{row['hbm_fit']}; {coll['n_ops']} calls, "
              f"{coll['total_bytes'] / 1e9:.2f} GB; "
              f"{row['traced_flops_per_device'] / 1e12:.1f} TFLOP; layout "
              f"{json.dumps(row['layout'])}; roofline compute "
              f"{roof['compute_s']:.4f} s, memory {roof['memory_s']:.4f} s, "
              f"collective {roof['collective_s']:.4f} s, bound "
              f"{roof['bottleneck']}, MFU {roof['mfu'] * 100:.1f}% "
              f"(dry-run predictions for the H100 80GB HBM3); traced in "
              f"{cell['seconds']:.1f}s")
    phase("dryrun", dryrun_hbm_check(torch))
    launches = read_launches()
    if any(launches.values()):
        fail(f"dryrun: a kernel of the port was launched: {launches}")
    phase("dryrun", f"kernel launches 0 (the traces run on meta tensors); "
          f"phase {time.perf_counter() - t0:.1f}s")
    return launches


def load_data():
    """The synthetic MAG store, the §8 spec, the training setup and the
    first training batch on the card."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.synthetic import synthetic_mag
    from repro_torch.serve.cache import VersionedGraphStore
    t0 = time.perf_counter()
    raw, _ = synthetic_mag(n_papers=20000, n_authors=10000,
                           n_institutions=40, n_fields=80,
                           n_classes=N_CLASSES, feat_dim=FEAT_DIM)
    store = VersionedGraphStore.wrap(raw)
    spec = section8_spec(store.schema)
    setup = train_setup(raw, spec)
    phase("data", f"synthetic MAG, 20000 papers; {len(setup[0])} train and "
          f"{len(setup[1])} eval roots profiled in "
          f"{time.perf_counter() - t0:.1f}s")
    first = to_device(next(iter(provider(raw, spec, setup[0],
                                         setup[2]).epoch(0))), DEVICE)
    return raw, store, spec, setup, first


def main() -> int:
    import torch
    card, smi = device_phase(torch)
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"the port's package is missing: no {src}/repro_torch")
    sys.path.insert(0, src)

    build_report = build_phase()
    records = kernels_phase(torch, build_report)
    raw, store, spec, setup, first = load_data()
    runs_kernels_phase(torch, first, records, build_report)
    flash_kernels_phase(torch, first, records, build_report)
    tuned = autotune_phase(torch, store, spec, first, records, smi)
    for name, n in tuned["served"].items():
        records[name]["autotune_served_launches"] = n
    for name, n in tuned["trained"].items():
        records[name]["autotune_trained_launches"] = n

    (records["edge_mpnn"]["launches"],
     records["edge_mpnn"]["graph_launches"]) = serve_phase(torch, store, spec,
                                                           card)
    records["segment_pool"]["launches"] = mean_phase(torch, store, spec)
    (records["edge_mpnn"]["serveloop_launches"],
     records["edge_mpnn"]["twin_launches"]) = serveloop_phase(
        torch, store, spec, smi)
    trained = train_phase(torch, raw, spec, card, setup)
    records["edge_mpnn_runs"]["launches"] = trained["launches"]
    records["segment_pool_runs"]["launches"] = train_mean_phase(
        torch, raw, spec, setup)
    from repro_torch.nn.layers import init_params
    with torch.no_grad():
        states = init_params(init_states(torch), SEED).to(DEVICE)(first)
    records["flash_attention"]["launches"] = attention_phase(torch, states,
                                                             card)
    records["segment_pool_runs"]["zoo_launches"] = zoo_phase(torch, raw,
                                                             spec, setup)
    quick = quickstart_phase(torch)
    for name in ("edge_mpnn", "segment_pool", "segment_pool_runs"):
        records[name]["quickstart_launches"] = quick[name]
    records["edge_mpnn_runs"]["linkpred_launches"] = linkpred_phase(torch)
    (records["edge_mpnn_runs"]["graphcls_launches"],
     records["segment_pool_runs"]["graphcls_launches"]) = graphcls_phase(
        torch)
    records["edge_mpnn_runs"]["service_launches"] = service_phase(
        torch, raw, spec, setup, trained, smi)
    records["edge_mpnn_runs"]["outofcore_launches"] = outofcore_phase(
        torch, smi)
    mesh = mesh_phase(torch, raw, spec, setup, smi)
    for name, n in mesh.items():
        records[name]["mesh_launches"] = n
    records["edge_mpnn_runs"]["multihost_launches"] = multihost_phase(
        torch, smi)
    lm = lm_phase(torch, smi)
    records["flash_attention"]["lm_launches"] = lm
    records["flash_attention"]["launches"] += lm
    for name, n in lm_families_phase(torch, smi).items():
        records[name]["lm_families_launches"] = n
    figures: dict = {}
    for name, n in lm_train_phase(torch, smi, figures).items():
        records[name]["lm_train_launches"] = n
    traces = dryrun_start()   # on the CPU beside [lm-mesh]
    for name, n in lm_mesh_phase(torch, smi, figures).items():
        records[name]["lm_mesh_launches"] = n
    for name, n in dryrun_phase(torch, smi, figures, traces).items():
        records[name]["dryrun_launches"] = n

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": [
        {**{k: rec[k] for k in keys},
         **{k: v for k, v in rec.items() if k not in keys}}
        for rec in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
