#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. print the card's name and power limit; build every CUDA kernel from
     ray_tpu_torch/csrc with nvcc, all sources at once, and print each
     kernel's registers and spills (ptxas) and the dynamic shared memory
     the wgmma kernels ask for;
  2. hold the flash-attention forward kernel against its plain PyTorch
     version on the card, on o and lse, at the shapes listed in CHECKS
     (D = 128 at full depth among them), on strided (B, S, 3H, D) views,
     and with q and k scaled by SCALED_QK at the main-path shape; check
     that two runs give the same bits;
  3. hold the backward kernels (dq; dk and dv) against their plain versions
     at the same shapes, on strided (B, S, 3H, D) views with a
     non-contiguous do, and with q and k scaled by SCALED_QK_BWD, and check
     that two runs give the same bits; then measure, without a check, how
     far the plain backward is from itself with f64 products at SCALED_QK;
  4. time each kernel, its plain version and PyTorch's fused attention
     (scaled_dot_product_attention: its forward, and its backward as
     forward-and-backward less forward, timed as yardsticks only) at the
     GPT-2 main-path shape, by device time under torch.profiler; each
     wrapper's time per call under CUDA events, host cost included, is
     printed beside it;
  5. the forward path: GPT-2-124M (random weights from a seeded generator,
     bf16 compute, flash attention) scores a few (8, 1024) token batches
     through the model's forward and loss_fn, and entry() runs once at
     (4, 512).  The forward kernel's launch count is reset just before and
     read just after; every forward must launch it once per layer.  The
     same weights with dense attention must give the same logits within a
     bf16 tolerance.  Then the forward is timed at (8, 1024) and profiled;
  6. the training path: GPT-2-124M at B=8, S=1024,
     bf16, flash, remat off, AdamW(3e-4, weight decay 0.1), the same tokens
     every step, 3 warm-up and 10 timed steps through compile_train_step.
     Every kernel's launch count is reset just before and read just after;
     each step must launch each kernel once per layer, and the loss must be
     finite and fall.  One step's gradients with flash and with dense
     attention, from the same weights, must agree within a bf16 tolerance.
     The lm-head's backward is timed, and one step is profiled by kernel
     group;
  7. [runtime]: the port's runtime starts with
     init(num_cpus=4) and must detect the card (cluster GPU == device
     count); the seed-0 GPT-2-124M state dict (CPU copies, f32) is put
     into its object store, and a num_gpus=1 task gets it, builds the model
     on its leased card and runs the (8, 1024) flash forward and loss with
     the forward kernel's count reset just before and read just after (two
     forwards: one launch a layer each); it must see exactly one card and
     equal the driver's own forward.  A num_gpus=0 task must see no card; a
     second one-GPU task must wait while a one-GPU actor holds the card and
     run after kill(); every process must name ray_tpu_torch and load no
     JAX; after shutdown() no process of the driver may remain.  Then C2:
     the tiny flash config widened to D = 64 at S = 128 on the card, one
     forward launch a layer, against its CPU result; at D = 16 (the kernels
     take 64 or 128) it must raise, not fall back;
  8. [llama-parity]: Mistral-7B at its published widths and depth (bf16
     weights from a seeded generator) prefills prompts of 512 and 97 tokens
     into rows 0 and 3 of an 8-row rolling cache (prefill_into_slot) and
     decodes 32 steps (decode_step_rowwise) with the rows at different
     positions; every logit vector is held against the full forward over
     the same tokens, and a cache rounded through float8 must fail the same
     tolerances; then the same at the same widths and cache shape cut to
     the model's first two layers, against a floor small enough to see one
     misplaced slot of the mask;
  9. [llama-rolling]: a tiny windowed f32 model through LLMEngine with a
     9-slot rolling cache decodes 30 tokens, which must equal generate()'s;
  10. [serve]: 24 seeded streaming requests in two waves through
     LLMEngine(max_slots=8, max_len=8192, max_prompt_len=512) at Mistral-7B
     width: time to first token, gaps between tokens, tokens/s, a decode
     step's host and device time and idle share, a 512-token prefill, peak
     memory, beside the card's bounds.  The flash kernels' counts are reset
     before phases 8-10 and must read 0 after: Llama attention is plain;
  11. [deploy]: [serve]'s model is freed, the port's runtime starts with
     init(num_cpus=4) and an object store sized for Mistral-7B's state dict
     (the size of /dev/shm is printed first), and serve.run deploys
     LlamaDeployment with ray_actor_options={"num_gpus": 1}, its weights
     drawn on the replica's card from [serve]'s seed: the replica's weights
     must have [serve]'s checksum, it must see one card and load no JAX,
     and the controller no torch.  [serve]'s 24 requests are replayed
     through handle.options(method_name="generate", stream=True) and every
     request must get [serve]'s tokens, request by request.  Prints the
     time to serve.run ready and its parts, time to first token, token
     gaps, tokens/s and the replica's peak memory beside [serve]'s;
  12. [push]: weights from another seed, their greedy tokens for 3 prompts
     computed in process, then a CPU bf16 state dict put into the store and
     pushed with push_deployment_weights while 128-token streams run back
     to back through the handle: every stream must end whole, one must span
     the swap, the 3 prompts must give the driver's tokens and the
     replica's checksum the state dict's.  Prints the push's bytes and its
     put, get and apply with GB/s, and the replica's peak memory.  If
     /dev/shm cannot hold the state dict, [push] runs on a second
     deployment cut to the largest depth that fits, and says so.  The
     flash kernels' counts read 0 over both phases, in the driver and in
     the replica; after shutdown() no process of the driver remains.
Phases 13-16 run after phase 7 and before phase 8, in the order 13, 16,
14, 15, so that each phase's peak memory is its own; a line "[probe]"
after phase 1 says whether pyarrow can be imported (for the Data
library's port, whose blocks are Arrow tables):
  13. [fit]: the port's runtime starts and
     TorchTrainer.fit() runs phase 6's training through the Train library,
     from a num_gpus=1 worker over an NCCL process group of one
     (ScalingConfig(num_workers=1, use_gpu=True),
     TorchConfig(init_distributed=True), FailureConfig(max_failures=1)).
     The worker's loop builds GPT-2-124M from phase 6's seed on its card,
     runs phase 6's 13 steps on phase 6's batch with the flash kernels'
     counts reset before each step and read after it, reports each step's
     loss, grad norm, step ms and launches, reports a checkpoint (model and
     AdamW state) after step 6, and on its first attempt kills its own
     process once step 9's report returns (the driver asks for it only
     after it has received step 8's).  The gang restarts from the
     checkpoint and finishes.  fit() must end without an error; the worker must see one
     card and load no JAX; the group must be NCCL at world size 1; every
     reported loss must equal phase 6's of the same step bit for bit (the
     resumed steps 7-12 included); each kernel must launch once a layer a
     step; after shutdown() no process of the driver may remain.  Prints
     the time to the first reported step and its parts, the time from the
     kill to the first resumed step and its parts, the worker's step ms
     beside phase 6's, and the checkpoint's bytes, write, persist and
     restore with GB/s and the storage path's filesystem;
  14. [moe]: GPT-2-124M with 8 experts (capacity factor 1.25, aux
     coefficient 0.01) at B=8, S=1024, bf16, flash: the _moe_mlp of the
     layer that drops the most tokens at init, on the features that reached
     it in the forward over phase 6's batch, on the card in f32 against the
     CPU's (experts and capacity slots equal for every token clear of a
     near-tie by MOE_MARGIN, outputs within MOE_TOL, tokens past capacity
     among those compared), then 3 + 10 training steps: the first loss about ln(vocab)
     plus 0.01 times the aux loss, the loss falling, each kernel launched
     once a layer a step.  Prints the aux loss at init, the share of tokens
     past capacity, step ms, tokens/s, the share of the bf16 peak, peak
     memory and one step's device time by kernel group;
  15. [vit]: ViT-B/16 (224x224x3 images, 196 patch tokens, 1024 classes;
     bf16 compute, f32 params, remat): logits at B=2 in f32 on the card
     against the CPU's from the same weights (VIT_TOL); one step's
     gradients at B=64 equal with remat on and off; 3 + 10 steps at B=64
     with AdamW on one repeated batch: the first loss about ln(1024), the
     loss falling.  Prints images/s, step ms, FLOPs an image, the share of
     the bf16 peak, peak memory and one step's device time by kernel
     group; the flash kernels' counts must read 0;
  16. [tune]: the port's runtime starts and
     (a) a Tuner runs [fit]'s loop without its self-kill as a function
     trainable with tune.with_resources(loop, {"GPU": 1}) over
     lr in grid_search([3e-4, 1e-3, 3e-3, 1e-2]) under
     ASHAScheduler(max_t=8, grace_period=2, reduction_factor=2), metric
     "loss", mode "min", no concurrency limit: the four trials queue on the
     one card through the lease.  Each trial builds GPT-2-124M from phase
     6's seed, runs phase 6's steps on phase 6's batch at its lr and
     reports each step's loss, step ms and launches.  Every trial must see
     the card in CUDA_VISIBLE_DEVICES; a trial's process must start after
     the trial before it last reported, and no earlier trial's process may
     live at its first step; every first loss must equal phase 6's bit for
     bit, and the 3e-4 trial's losses phase 6's first ones; each trial
     must run as many iterations as a fresh ASHAScheduler decides when
     replayed on the recorded results in arrival order; each step must
     launch each kernel once a layer.  (b) A Tuner over
     TorchTrainer(ScalingConfig(num_workers=1, use_gpu=True)) of the same
     loop at 4 steps with a state-dict checkpoint at the end, lr in
     grid_search([3e-4, 1e-3]): each trial reports once, its actor sees
     CUDA_VISIBLE_DEVICES="" and the trainer's worker "0"; the 3e-4 loss
     must equal phase 6's fourth bit for bit; get_best_result picks the
     lower loss and its checkpoint restores the weights the trial
     checksummed.  Prints each trial's lr, iterations, start and first
     report with its parts, step ms beside phase 6's and the gap between
     trials; after shutdown() no process of the driver may remain.
Phases 17, 19 and 20 run after phase 6 and before phase 7, in that order,
phase 18 last (its spawned ranks leave multiprocessing's resource tracker
running until the script exits, and phases 7, 11-13, 16 and 20 require
that no process this script started outlive their shutdown()):
  17. [spmd] (this slice's main path): phase 6's training through the
     mesh path: an NCCL process group of one (tcp://localhost, a free
     port), make_mesh(MeshConfig(dp=1), device_type="cuda") (one torch mesh
     dim, "dp", of one rank), sharded_init of GPT-2-124M from phase 6's
     seed with param_logical_axes (every parameter a DTensor laid out as
     the rule table says, AdamW's moments too), shard_batch of phase 6's
     batch and the mesh's compile_train_step, 3 + 10 steps, with the flash
     kernels reached through local_map (sharded_flash_attention_bhsd).
     Each step must launch each kernel once a layer; every loss must equal
     phase 6's of the same step bit for bit (SPMD_LOSS_TOL; the largest
     difference is printed).  Prints step ms, tokens/s and peak memory
     beside phase 6's; the process group is destroyed after it;
  18. [dryrun]: dryrun_multigpu(4, device_type="cpu"), four gloo ranks on
     the host's CPU (the card's machine has one GPU, and NCCL puts one
     rank on a card):
     ring attention over sp = 2 with tp = 2, GPT-2 with experts over
     ep = 2 x tp = 2, GPipe over a pp mesh of 4 stages, tp-sharded Llama
     prefill and decode, ViT over fsdp = 2 x tp = 2, a PPO learner's
     update dp-sharded over the 4 ranks (pass 8) and the gang's
     cross-process sum, each pass's OK line printed; its losses are CPU
     numbers;
  19. [pipeline] (this slice's main path): phase 6's training through the
     MPMD pipeline's stage programs, in LocalPipelineRunner on the card:
     GPT-2-124M from phase 6's seed, cut by models.pp into 4 stages of 3
     layers (first, middle and last roles all run), phase 6's (8, 1025)
     batch as 4 microbatches of 2 rows, AdamW(3e-4, weight decay 0.1), 3 +
     10 steps.  Each step must launch the forward kernel 84 times (per
     microbatch, the 9 layers of the three non-last stages twice, forward
     and recompute, the last stage's 3 once) and dq and dk/dv 48 times
     each; every loss finite, the loss falling by more than 0.1, the first
     within PIPE_FIRST_TOL of phase 6's and all within PIPE_LOSS_TOL.
     Prints step ms, tokens/s and peak memory beside phase 6's, the
     largest loss difference and one profiled step's device time by
     kernel group;
  20. [pipeline-mpmd]: the port's runtime starts (init(num_cpus=4)) and
     PipelineTrainer runs the reference's bit-parity configuration (the
     tiny GPT-2 at 3 layers, 3 stages of CPU stage actors, 4 microbatches
     of 2 rows, sequence 32, Adam 1e-3) for 3 steps under the "p2p" and
     the "driver" handoff: losses and gathered parameters must equal
     LocalPipelineRunner's bit for bit, each micro-op run once.  A
     device="cuda" trainer of 2 stages must then be refused within 30 s,
     naming 2 cards wanted and the node's 1, with no process started;
     after shutdown() no process of the driver may remain.
Phase 21 runs after phase 12 and before phase 18; a line "[probe]" after
phase 1 says whether gymnasium can be imported (RLlib's env runners need
it; the card's machine has not had it, so no env steps there):
  21. [rllib]: the RLlib port's eight learners (PPO, DQN, IMPALA, APPO,
     SAC, BC, CQL, MARWIL), each at its config's defaults and own batch,
     at two shapes: the default MLP (64, 64) at CartPole's (obs 4, 2
     actions) and the catalog's CNN at Atari's (84, 84, 4) frames, 6
     actions.  Each learner is made three times from one seed, on the
     card and on the CPU in f32 and on the CPU in f64 (TF32 off for the
     card's products and convolutions), and fed the same 3 seeded
     batches: the first update's gradients and the parameters after 3
     updates of the card and of the CPU's f32 run are measured against the
     f64 run tensor by tensor, and each of the card's tensors must be
     within RL_GRAD_TOL / RL_PARAM_TOL of it or within RL_FLOOR_FACTOR of
     the CPU's own f32 distance for that tensor; each update's ms on the
     card and on the CPU are printed (median of 20 after 3).  Then PPO,
     DQN and SAC are made as algorithms (the MLP, the env runners replaced
     by seeded CartPole-shaped fragments) on the card, on the CPU and on
     the CPU in f64, and take 3 training_steps each: the card's parameters
     are held to the f64 run in the same way within RL_ALGO_TOL; the card
     algorithm is saved and restored into a fresh card algorithm, whose
     weights (and PPO's optimizer state) must come back bit for bit on the
     card, and one more iteration of both must follow (PPO's within
     RL_ALGO_TOL of the original's).  Then
     PPOConfig().learners(2, device="cuda") must be refused on this
     one-card node, naming 2 cards wanted and 1 there.
     The flash kernels' counts are reset before and must read 0 after.
Phase 22 runs after phase 16 and before phase 14, phase 23 after phase 21
and before phase 18:
  22. [ingest]: the Data library feeds a training gang on the card.  The
     driver writes 104 seeded rows (1025 int32 GPT-2 tokens and an int64
     row_id each) to 4 parquet files in the session's directory with
     pyarrow; data.read_parquet(dir).map_batches splits each row into
     int64 inputs and targets of 1024.  TorchTrainer(datasets={"train":
     ds}, ScalingConfig(num_workers=1, use_gpu=True)) runs phase 6's
     training (GPT-2-124M from phase 6's seed, B=8, S=1024, bf16, flash,
     AdamW) for the 13 batches of 8, which the worker reads with
     train.get_dataset_shard("train").iter_device_batches(batch_size=8)
     (its default device, the card: pinned host copies on a side stream,
     double-buffered).  Each step reports its loss, the batch's row_ids,
     the ms the loop waited for the batch, step ms and each kernel's
     launches (reset before the step, read after).  The row_ids must
     cover the 104 rows once; the driver replays phase 6's in-process step
     over the same batches, in the reported order, read from the files
     with pyarrow, and every loss must equal the replay's bit for bit;
     each kernel must launch 12 times a step; the worker must see one card
     and load no JAX; after shutdown() no process of the driver may
     remain.  Prints the wait for a batch (median, max) beside the step's
     ms and their ratio, the time to the first step and its parts, and the
     shard's Data execution stats;
  23. [podracer]: the Podracer plane's learner actor on the card.  (a) A
     PodracerLearnerActor leasing num_gpus=1 builds IMPALA's learner on
     the card, twice: at the default MLP (CartPole's shapes) and at the
     catalog's CNN at (84, 84, 4) with 6 actions.  The driver ingests a
     seeded sequence of 9 fragments (the config's rollout length, 4 envs;
     the metas and weight pushes of tests/test_torch_podracer.py: drops
     stale at ingest and while queued, suspect fragments, 3 updates) into
     it by shm ref, and into an in-process CPU learner and an f64 one
     (TF32 off): the card's stats() must equal the CPU's after every step,
     its parameters after the last update be held to the f64 run by
     [rllib]'s per-tensor floors (RL_PARAM_TOL), and its checkpoint hooks
     round-trip onto a fresh card actor bit for bit.  (b) PodracerRunner
     runs 2 CPU runner actors (the port's EnvRunnerActor with its env
     stepping replaced by seeded frames) and the card learner at the CNN,
     32-step fragments of 4 envs (14.45 MB each, by shm ref; the driver
     never holds a payload), 2 fragments a batch, K = 4, a fan-out every
     update, for 20 updates or more, once with the fp32 wire and once with
     bf16: the largest trained lag must be at most K, every fragment sent
     be trained, dropped stale, dropped for overflow, queued or lost, and
     after drain_in_flight and a last fan-out every runner's weights equal
     the learner's bit for bit; the learner must see one card, load no JAX
     and launch no flash kernel.  Prints fragments/s, env steps trained/s,
     updates/s, GB/s of fragments into the learner, fan-out ms and one
     profiled update's device-busy ms and idle share.
Phases 24-26 run after phase 22 and before phase 14, in that order; each
starts the port's runtime and ends with no process of the driver left,
and each drives GPT-2-124M from phase 6's seed-1 weights, B=8, S=1024:
  24. [dag]: a compiled DAG, InputNode -> a CPU actor's make_batch (the
     (8, 1025) token batch drawn on the CPU from the input's seed) -> a
     num_gpus=1 actor's forward (the model on its card: each row's mean
     loss and the last position's f32 logits).  The outputs of 4 seeds
     must equal, bit for bit, the same actor's .remote() results and the
     driver's own forward, arriving as CPU tensors; 4 executions in
     flight before the first get() come back in order; an error raised
     in the GPU stage reaches get() and the DAG runs on; the GPU stage
     must launch the forward kernel 12 times an iteration (read after
     teardown); the same graph compiled with a 256 KiB buffer must fail
     get() naming the writer's capacity ValueError; after teardown and a
     kill a fresh num_gpus=1 actor leases the card.  Prints the median
     ms an iteration of the forward and of a no-op, by DAG and by
     .remote() + get;
  25. [workflow]: a durable workflow of 4 tasks, init (CPU: the seed-1
     state dict, bound as a constant) -> train (num_gpus=1: phase 6's
     step 3 times on phase 6's batch, bound as a CUDA constant) -> eval
     (num_gpus=1: the trained weights' forward) -> report (CPU).  eval
     fails on its first run (a marker file): the run must fail, resume()
     rerun eval and report only (train's marker count stays 1) and give
     what an uninterrupted run gives, bit for bit; train's losses must
     equal phase 6's first 3 bit for bit; 12 launches of each kernel a
     train step, 12 forward launches in eval; every step file and
     get_output() must load in a process with CUDA_VISIBLE_DEVICES="",
     every tensor on the CPU.  Prints each checkpoint's bytes and write
     s;
  26. [cluster]: a Cluster of a head with 2 CPUs and no card and a node
     with 2 CPUs and num_gpus=1, the driver attached by
     util.client.connect: a second one-card node must be refused; a
     num_gpus=1 task must land on the card's node, see that card alone,
     launch the forward kernel 12 times and send per-row losses through a
     util.queue.Queue equal, bit for bit, to the driver's; list_nodes()
     and summarize() show GPU 1 on that node only and its lease while the
     task runs, worker_stacks() the task in its worker; a second GPU task
     must pend; the node is removed (a hard kill): its death must be an
     event, the first task's error reach get(), the second still pend,
     and a new add_node(num_gpus=1) get the same card and run it there.
  27. [job]: `python -m ray_tpu_torch start --head --num-cpus 4
     --num-gpus 1` in a temp dir of its own; JobSubmissionClient submits
     this script as a job's driver (--job-driver DIR), which attaches to
     the cluster, loads [cluster]'s seed-1 GPT-2-124M weights from a file
     the phase wrote and runs one flash forward on the card the head gave
     it: the job must be SUCCEEDED, its log name the card, its per-row
     losses and last logits equal the driver's bit for bit, with 12
     forward launches and no JAX loaded; `status` and `list nodes` through
     the CLI and the dashboard's /api/jobs and /api/nodes (urllib) must
     show the job SUCCEEDED and GPU 1 on the head; `stop` must leave no
     process of the session;
  28. [autoscale]: an Autoscaler (one node type {"CPU": 2, "GPU": 1}, min
     0, max 1) over a LocalSubprocessProvider, its passes run from a
     thread, on a Cluster head with 2 CPUs and no card: a num_gpus=1 task
     of the same forward must pend, make it launch a node with the card,
     and give the driver's losses bit for bit with 12 forward launches;
     the idle node must then be drained and removed and no lease pend.
     Prints the seconds from the demand to the launch, to the task's
     result and to the removal.
The line before the last is a JSON object {"kernels": [...]} with each
kernel's launches on the training path (the forward kernel's in the
runtime's GPU worker, "runtime_launches"; each kernel's in the trainer's
worker, "fit_launches", in the Tune trials' processes, "tune_launches",
in [moe], "moe_launches", through the mesh path, "spmd_launches",
through the pipeline's stage programs, "pipeline_launches", in
[rllib], "rllib_launches", in the [ingest] worker, "ingest_launches",
in [podracer], "podracer_launches", in the [dag]'s GPU stage over the DAG's
iterations, "dag_launches", in [workflow]'s train and eval workers,
"workflow_launches", in [cluster]'s GPU task, "cluster_launches", in
[job]'s submitted driver, "job_launches", and in [autoscale]'s task,
"autoscale_launches"),
error against its plain version,
time, the plain version's time, the library call's time and the card's
bound; the last line is {"ok": true, "device": {...}}.  With no CUDA device
it prints no result and exits 2.  `chip_smoke.py --job-driver DIR` is
[job]'s submitted driver, not a smoke run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import torch

# H100 SXM: HBM rate and dense bf16 tensor-core peak (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
MAIN_SHAPE = (8, 12, 1024, 64)  # GPT-2-124M attention at B=8, S=1024
# (shape, dtype) pairs the kernels are held against their plain versions at.
CHECKS = [
    (shape, dtype)
    for shape in ((1, 2, 128, 64), (1, 2, 384, 64), (2, 4, 512, 64), (1, 2, 256, 128))
    for dtype in (torch.float32, torch.bfloat16)
] + [(MAIN_SHAPE, torch.bfloat16), ((2, 4, 1024, 128), torch.bfloat16),
       # D = 128 with more tiles than the card has SMs, so every persistent
       # wgmma kernel's blocks take a second tile there too.
       ((8, 12, 1024, 128), torch.bfloat16)]
# q and k scaled by this at the main-path shape: scores of std ~16, so row
# maxima move from kv tile to kv tile and the online rescale is exercised.
SCALED_QK = 4.0
# The backward's scaled check.  At SCALED_QK the plain backward does not
# reproduce itself within BWD_TOL once its products are summed in f64: bf16
# roundings of p and ds flip with the last bits of s (phase_tolerance_floor
# measures it in every run).  At 2.0 (scores of std ~4) it does.
SCALED_QK_BWD = 2.0
# f32: the kernel and the plain version sum in another order (5e-5).
# bf16: the kernel rounds p to bf16 before the product with v (as the Pallas
# kernel does) and both round o to bf16 once, so o may differ by about one
# bf16 ulp (2^-8 relative); lse is f32 from the same bf16 inputs.
TOL = {
    torch.float32: {"o": dict(atol=5e-5, rtol=5e-5), "lse": dict(atol=5e-5, rtol=5e-5)},
    torch.bfloat16: {"o": dict(atol=1e-2, rtol=1e-2), "lse": dict(atol=1e-4, rtol=1e-4)},
}
# Backward, dq, dk, dv against the plain versions.  f32: summation order
# (5e-5).  bf16: both round p and ds to bf16 before their products, where
# summation order can flip a rounding, and both sum in f32 and round the
# output once, so an output may differ by about one bf16 ulp (2^-8 relative).
BWD_TOL = {torch.float32: dict(atol=5e-5, rtol=5e-5), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
# Init loss of a random-weight model: about ln(vocab).
LOSS_WINDOW = 0.5
# Flash vs dense logits in bf16: the kernel keeps p and the sum in f32, the
# dense path rounds p and the product to bf16; logits are O(0.5).
FLASH_VS_DENSE_MAX_ABS = 0.1
FLASH_VS_DENSE_LOSS = 1e-2
# Flash vs dense gradients of one bf16 training step, |g_flash - g_dense| over
# |g_dense| for each parameter: the dense path rounds p and its backward
# products to bf16 where the kernels keep f32, and those roundings (2^-8
# relative) are carried back through 12 layers.
FLASH_VS_DENSE_GRAD = 5e-2
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# The serving configuration: Mistral-7B with bf16 weights (the published
# checkpoint's dtype; f32 masters would be cast down at every use).
SERVE_ENGINE = dict(max_slots=8, max_len=8192, max_prompt_len=512)
PARITY_PROMPTS = {0: 512, 3: 97}  # cache row -> prompt length
PARITY_STEPS = 32
# Cached path (prefill_into_slot, decode_step_rowwise) against the full
# forward over the same tokens, on each row's (33, 32000) logit block, both
# in bf16.  The two round the same values to bf16 but sum them in other
# orders (other GEMM shapes; a masked softmax over 4607 slots against a
# causal one), and a random-weight Mistral amplifies such single roundings
# with depth: on an H100 80GB HBM3 this script measured the full forward
# 4.0% (|d|/|ref|, max |d| 0.28 on logits of std 1.28) from itself at a
# sequence one token shorter.  So at full depth the cached path is held to
# twice that floor, and to the accuracy of the full forward: each is about
# 5.8% from the same forward in f32, and the cached path may be at most
# f32_ratio times as far.  A cache rounded through float8 e4m3 (2^-4
# relative) must fail them.
PARITY_TOL = dict(rel=0.08, max_abs=0.6, f32_ratio=1.25)
# The same prefill and decode at the same widths and cache shape, cut to
# the model's first two layers (two, so that a layer's cache feeds the
# next), where the floor is small enough to see one misplaced slot of the
# mask.  On the same card the full forward measured 0.53% and 0.48% (max
# |d| 0.043, 0.038) from itself one token shorter there, the cached path
# 0.75% and 0.78% (max |d| 0.050, 0.051) from the full forward, and both
# equally far from f32 (cached/full 1.004 and 1.000).  So: twice the floor
# for |d|/|ref| and max |d|, and at most 10% farther from f32 than the
# full forward.
PARITY_SHALLOW_LAYERS = 2
PARITY_SHALLOW_TOL = dict(rel=0.01, max_abs=0.08, f32_ratio=1.1)
SERVE_REQUESTS, SERVE_WAVE_GAP_S = 24, 0.5


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _time_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _randn(shape, dtype, g):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _qkv(shape, dtype, seed, n=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [_randn(shape, dtype, g) for _ in range(n)]


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _attention_bound(shape, dtype):
    """Least time for the causal forward: q, k, v read once, o and lse
    written once, against the product count of the causal triangle."""
    B, H, S, D = shape
    elt = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * H * S * D * elt + B * H * S * 4
    flops = 4 * B * H * D * S * (S + 1) // 2
    return (*_bound(nbytes, flops), nbytes, flops)


def _bwd_bound(shape, dtype, n_products, n_outputs):
    """Least time for one backward pass: q, k, v, do, lse and delta read
    once, its outputs written once, against ``n_products`` causal
    products (dq: s, dp, ds k; dk/dv: s, dp, p do, ds q)."""
    B, H, S, D = shape
    elt = torch.finfo(dtype).bits // 8
    nbytes = (4 + n_outputs) * B * H * S * D * elt + 2 * B * H * S * 4
    flops = n_products * 2 * B * H * D * S * (S + 1) // 2
    return (*_bound(nbytes, flops), nbytes, flops)


def phase_device_and_build(_build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                   f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = _build.build(_build.all_sources())
    _log("build", f"{len(paths)} kernel source(s) built in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        kernel = ""
        for line in open(f"{path}.log").read().splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                m = re.search(r"\d(flash_[a-z0-9_]*_kernel)ILi(\d+)E", mangled)
                kernel = f"{m[1]}<{m[2]}>" if m else mangled[-60:]
            if any(w in line for w in ("registers", "spill", "error", "Performance Loss")):
                _log("build", f"{name}: {kernel}: {line.strip()}")
    for lib, sym in (("flash_attention_fwd", "flash_attention_fwd_smem_bytes"),
                     ("flash_attention_bwd", "flash_attention_bwd_dq_smem_bytes"),
                     ("flash_attention_bwd", "flash_attention_bwd_dkv_smem_bytes")):
        fn = getattr(_build.load(lib), sym)
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
        _log("build", f"{sym}: bf16 (wgmma) D=64 {fn(64, 1)} B, D=128 {fn(128, 1)} B; "
                      f"f32 D=64 {fn(64, 0)} B, D=128 {fn(128, 0)} B of dynamic shared memory")
    return smi


def phase_check(fa):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for i, (shape, dtype) in enumerate(CHECKS):
        q, k, v = _qkv(shape, dtype, seed=i)
        scale = 1.0 / math.sqrt(shape[-1])
        o, lse = fa.flash_attention_fwd(q, k, v)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale)
        torch.cuda.synchronize()
        _require(o.dtype == dtype and lse.dtype == torch.float32, f"{shape}: o {o.dtype}, lse {lse.dtype}")
        torch.testing.assert_close(o.float(), o_ref.float(), **TOL[dtype]["o"])
        torch.testing.assert_close(lse, lse_ref, **TOL[dtype]["lse"])
        errs[(shape, dtype)] = ((o.float() - o_ref.float()).abs().max().item(),
                                (lse - lse_ref).abs().max().item())
        _log("check", f"{shape} {str(dtype)[6:]}: max|o-ref| {errs[(shape, dtype)][0]:.3g} "
                      f"max|lse-ref| {errs[(shape, dtype)][1]:.3g}")
    # The model hands the kernel strided views of its (B, S, 3H, D)
    # projection output; hold that layout too, at the main-path shape.
    B, H, S, D = MAIN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(99)
    qkv = torch.randn((B, S, 3 * H, D), generator=g, device="cuda").bfloat16()
    q, k, v = (t.transpose(1, 2) for t in qkv.split(H, dim=2))
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, 1.0 / math.sqrt(D))
    torch.testing.assert_close(o.float(), o_ref.float(), **TOL[torch.bfloat16]["o"])
    torch.testing.assert_close(lse, lse_ref, **TOL[torch.bfloat16]["lse"])
    _log("check", f"strided (B,S,3H,D) views at {MAIN_SHAPE}: max|o-ref| "
                  f"{(o.float() - o_ref.float()).abs().max().item():.3g}")
    # No atomics: two runs give the same bits.
    o2, lse2 = fa.flash_attention_fwd(q, k, v)
    _require(torch.equal(o, o2) and torch.equal(lse, lse2), "two forward runs differ")
    _log("check", "forward: two runs at the main-path shape are bitwise equal")
    q, k, v = _qkv(MAIN_SHAPE, torch.bfloat16, seed=97)
    q, k = q * SCALED_QK, k * SCALED_QK
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, 1.0 / math.sqrt(D))
    torch.testing.assert_close(o.float(), o_ref.float(), **TOL[torch.bfloat16]["o"])
    torch.testing.assert_close(lse, lse_ref, **TOL[torch.bfloat16]["lse"])
    _log("check", f"q, k scaled by {SCALED_QK} at {MAIN_SHAPE}: max|o-ref| "
                  f"{(o.float() - o_ref.float()).abs().max().item():.3g} max|lse-ref| "
                  f"{(lse - lse_ref).abs().max().item():.3g}")
    return errs[(MAIN_SHAPE, torch.bfloat16)][0]


def _bwd_pair(fa, q, k, v, do):
    """(dq, dk, dv) from the kernels and from the plain versions, on the
    forward kernel's o and lse."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa._delta(o, do)
    got = (fa.flash_attention_dq(q, k, v, do, lse, delta, scale),
           *fa.flash_attention_dkv(q, k, v, do, lse, delta, scale))
    ref = (fa.flash_attention_dq_reference(q, k, v, do, lse, delta, scale),
           *fa.flash_attention_dkv_reference(q, k, v, do, lse, delta, scale))
    torch.cuda.synchronize()
    return got, ref


def _hold_bwd(label, got, ref, dtype):
    errs = []
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _require(a.dtype == dtype and a.shape == b.shape, f"{label} {name}: {a.dtype} {tuple(a.shape)}")
        torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dtype],
                                   msg=lambda m: f"{label} {name}: {m}")
        errs.append((a.float() - b.float()).abs().max().item())
    _log("check", f"{label}: max|d-ref| dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g}")
    return errs


def phase_check_bwd(fa):
    errs = {}
    for i, (shape, dtype) in enumerate(CHECKS):
        q, k, v, do = _qkv(shape, dtype, seed=100 + i, n=4)
        got, ref = _bwd_pair(fa, q, k, v, do)
        errs[(shape, dtype)] = _hold_bwd(f"bwd {shape} {str(dtype)[6:]}", got, ref, dtype)
    # The model's layout: q, k, v strided views of one (B, S, 3H, D) tensor.
    # do from autograd need not be contiguous: one in (B, S, H, D) memory
    # order is read through its strides, one without a unit stride along D
    # is copied by the wrapper first.
    B, H, S, D = MAIN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(98)
    qkv = _randn((B, S, 3 * H, D), torch.bfloat16, g)
    q, k, v = (t.transpose(1, 2) for t in qkv.split(H, dim=2))
    for label, do in (
        ("(B,S,H,D)-ordered do", _randn((B, S, H, D), torch.bfloat16, g).transpose(1, 2)),
        ("do with D stride != 1", _randn((B, H, D, S), torch.bfloat16, g).transpose(2, 3)),
    ):
        _require(not do.is_contiguous(), f"{label} is contiguous")
        got, ref = _bwd_pair(fa, q, k, v, do)
        _hold_bwd(f"strided views, {label}", got, ref, torch.bfloat16)
    # No atomics: two runs give the same bits.
    got2, _ = _bwd_pair(fa, q, k, v, do)
    _require(all(torch.equal(a, b) for a, b in zip(got, got2)), "two backward runs differ")
    _log("check", "backward: two runs at the main-path shape are bitwise equal")
    q, k, v, do = _qkv(MAIN_SHAPE, torch.bfloat16, seed=96, n=4)
    got, ref = _bwd_pair(fa, q * SCALED_QK_BWD, k * SCALED_QK_BWD, v, do)
    _hold_bwd(f"q, k scaled by {SCALED_QK_BWD} at {MAIN_SHAPE}", got, ref, torch.bfloat16)
    main = errs[(MAIN_SHAPE, torch.bfloat16)]
    return {"dq": main[0], "dkv": max(main[1], main[2])}


def _bwd_f64(q, k, v, do, lse, delta, scale):
    """The plain backward with every product summed in f64; p and ds are
    still rounded to the inputs' dtype before their products."""
    S = q.shape[2]
    w = lambda x: x.double()
    s = torch.einsum("bhqd,bhkd->bhqk", w(q), w(k)) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.where(causal, torch.exp(s - w(lse)[..., None]), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", w(do), w(v)) - w(delta)[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", w(ds.to(q.dtype)), w(k))
    dk = torch.einsum("bhqk,bhqd->bhkd", w(ds.to(q.dtype)), w(q))
    dv = torch.einsum("bhqk,bhqd->bhkd", w(p.to(do.dtype)), w(do))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def phase_tolerance_floor(fa):
    """A measurement, not a check: at the main-path shape with q and k
    scaled by SCALED_QK, how many elements of dq, dk and dv fall outside
    BWD_TOL between the kernels, the plain backward (f32 products) and the
    plain backward with f64 products.  Where the two plain versions
    disagree as much as the kernels do, the tolerance is below the
    function's own rounding noise at those inputs."""
    q, k, v, do = _qkv(MAIN_SHAPE, torch.bfloat16, seed=96, n=4)
    q, k = q * SCALED_QK, k * SCALED_QK
    got, ref = _bwd_pair(fa, q, k, v, do)
    o, lse = fa.flash_attention_fwd(q, k, v)
    alt = _bwd_f64(q, k, v, do, lse, fa._delta(o, do), 1.0 / math.sqrt(MAIN_SHAPE[-1]))

    def outside(a, b):
        d = (a.float() - b.float()).abs()
        tol = BWD_TOL[torch.bfloat16]
        return int((d > tol["atol"] + tol["rtol"] * b.float().abs()).sum()), d.max().item()

    for name, g, r, a in zip(("dq", "dk", "dv"), got, ref, alt):
        _log("floor", f"q, k scaled by {SCALED_QK}, {name}: elements outside BWD_TOL (max |diff|): "
                      "kernel vs plain %d (%.4g), f64-product plain vs plain %d (%.4g), "
                      "kernel vs f64-product plain %d (%.4g)" % (*outside(g, r), *outside(a, r), *outside(g, a)))


def _pct(samples, f):
    s = sorted(samples)
    return s[min(len(s) - 1, int(f * len(s)))]


def _spread(samples):
    """Median and quartiles."""
    return _pct(samples, 0.5), _pct(samples, 0.25), _pct(samples, 0.75)


def _device_events(run):
    """The device kernels of one ``run()`` under torch.profiler (after a
    warm-up run), leaving out user annotations, which span kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _sdpa_backward_ms(q, k, v, do, iters=20):
    """SDPA's backward at these inputs: the device time of its forward and
    backward less that of its forward (inputs that require grad in both),
    summed over the kernels of ``iters`` calls.  A loop of autograd calls is
    bound by the host, so CUDA events around it would time the host."""
    import torch.nn.functional as F

    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qr, kr, vr), do)

    def device_ms(fn):
        events = _device_events(lambda: [fn() for _ in range(iters)])
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters

    return device_ms(fwd_bwd) - device_ms(fwd)


def _device_ms(fn, iters, kernel=None):
    """Device time of one ``fn()`` from the kernels of ``iters`` calls under
    torch.profiler.  With ``kernel``, only the launches whose name holds it
    (one a call): their median and quartiles; without, the sum of every
    kernel over ``iters``."""
    events = _device_events(lambda: [fn() for _ in range(iters)])
    if kernel is None:
        _require(events, "no device events recorded")
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    events = [e for e in events if kernel in e.name]
    _require(len(events) == iters, f"{kernel}: {len(events)} launches profiled, expected {iters}")
    return _spread([e.time_range.elapsed_us() / 1e3 for e in events])


def _time_one(label, kernel, call, plain, bound, library_ms, iters=50):
    """A kernel's device time (median and quartiles of ``iters`` launches),
    its wrapper's time per call under CUDA events (host cost included), its
    plain version's device time, beside its bound and the library's time."""
    ms, q25, q75 = _device_ms(call, iters, kernel=kernel)
    wrapper_ms = _time_ms(call, iters=iters)
    plain_ms = _device_ms(plain, 3)
    bound_ms, bound_by, nbytes, flops = bound
    _log("time", f"{label} {MAIN_SHAPE} bf16: kernel {ms:.4f} ms device time (quartiles "
                 f"{q25:.4f}..{q75:.4f} over {iters} launches), wrapper {wrapper_ms:.4f} ms a call "
                 f"(CUDA events), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                 f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), kernel/bound {ms / bound_ms:.1f}x, "
                 f"kernel/library {ms / library_ms:.2f}x")
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_time_kernel(fa):
    import torch.nn.functional as F

    q, k, v = _qkv(MAIN_SHAPE, torch.bfloat16, seed=7)
    scale = 1.0 / math.sqrt(MAIN_SHAPE[-1])
    library_ms = _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 50)
    _log("time", f"sdpa forward (device time) {library_ms:.4f} ms")
    return _time_one("flash_attention_fwd", "flash_fwd_wgmma_kernel", lambda: fa.flash_attention_fwd(q, k, v),
                     lambda: fa.flash_attention_fwd_reference(q, k, v, scale),
                     _attention_bound(MAIN_SHAPE, torch.bfloat16), library_ms)


def phase_time_bwd(fa):
    """The dq and dk/dv kernels at the main-path shape, beside their plain
    versions, their bounds and SDPA's backward (which computes dq, dk and
    dv together, so it is the yardstick of the two kernels' sum)."""
    q, k, v, do = _qkv(MAIN_SHAPE, torch.bfloat16, seed=8, n=4)
    scale = 1.0 / math.sqrt(MAIN_SHAPE[-1])
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa._delta(o, do)
    args = (q, k, v, do, lse, delta, scale)
    library_ms = _sdpa_backward_ms(q, k, v, do)
    times = {}
    for key, kernel, plain, n_products, n_outputs in (
        ("dq", fa.flash_attention_dq, fa.flash_attention_dq_reference, 3, 1),
        ("dkv", fa.flash_attention_dkv, fa.flash_attention_dkv_reference, 4, 2),
    ):
        times[key] = _time_one(f"flash_attention_{key}", f"flash_{key}_wgmma_kernel", lambda: kernel(*args),
                               lambda: plain(*args),
                               _bwd_bound(MAIN_SHAPE, torch.bfloat16, n_products, n_outputs),
                               library_ms)
    total = times["dq"]["ms"] + times["dkv"]["ms"]
    _log("time", f"sdpa backward (device time of fwd+bwd less fwd) {library_ms:.4f} ms; dq + dk/dv kernels "
                 f"{total:.4f} ms ({total / library_ms:.2f}x sdpa)")
    return times


def phase_main_path(fa, gpt2, entry, model, tokens):
    """The forward path, whose forward-kernel launches are counted: each
    batch scored by the model's forward and by loss_fn, then entry() once."""
    cfg = model.config
    per_forward = cfg.num_layers
    results = []
    fa.flash_attention_fwd.launches = 0
    with torch.inference_mode():
        for i in range(tokens.shape[0]):
            before = fa.flash_attention_fwd.launches
            logits = model(tokens[i, :, :-1])
            mid = fa.flash_attention_fwd.launches
            loss = float(gpt2.loss_fn(model, {"tokens": tokens[i]}))
            after = fa.flash_attention_fwd.launches
            _require(mid - before == per_forward and after - mid == per_forward,
                     f"batch {i}: {mid - before} and {after - mid} launches, "
                     f"expected {per_forward} per forward")
            _require(logits.shape == (8, 1024, cfg.vocab_size) and logits.dtype == torch.float32,
                     f"batch {i}: logits {tuple(logits.shape)} {logits.dtype}")
            _require(bool(torch.isfinite(logits).all()), f"batch {i}: non-finite logits")
            _require(abs(loss - math.log(cfg.vocab_size)) < LOSS_WINDOW, f"batch {i}: loss {loss}")
            _log("model", f"batch {i}: loss {loss:.6f} (ln V = {math.log(cfg.vocab_size):.5f}), "
                          f"logits finite, std {logits.std().item():.4f}")
            results.append((logits, loss))
        fn, (emodel, etokens) = entry(device="cuda", attention_impl="flash")
        before = fa.flash_attention_fwd.launches
        elogits = fn(emodel, etokens)
        torch.cuda.synchronize()
    launches = fa.flash_attention_fwd.launches
    _require(launches - before == per_forward, f"entry(): {launches - before} launches")
    _require(elogits.shape == (4, 512, cfg.vocab_size) and bool(torch.isfinite(elogits).all()),
             f"entry(): logits {tuple(elogits.shape)} not finite or misshapen")
    _require(launches > 0, "the flash kernel was never launched on the forward path")
    _log("model", f"entry(): logits {tuple(elogits.shape)} finite; flash kernel launches on "
                  f"the forward path: {launches} ({per_forward} per forward, "
                  f"{2 * tokens.shape[0] + 1} forwards)")
    return launches, results[0]


def phase_flash_vs_dense(gpt2, model, tokens, flash_logits, flash_loss):
    dense = gpt2.GPT2(dataclasses.replace(model.config, attention_impl="dense"), "cuda")
    dense.load_state_dict(model.state_dict())
    with torch.inference_mode():
        d_logits = dense(tokens[0, :, :-1])
        d_loss = float(gpt2.loss_fn(dense, {"tokens": tokens[0]}))
    diff = (d_logits - flash_logits).abs()
    _log("model", f"flash vs dense logits: max abs {diff.max().item():.4g}, mean abs "
                  f"{diff.mean().item():.4g}; loss {flash_loss:.6f} vs {d_loss:.6f}")
    _require(diff.max().item() < FLASH_VS_DENSE_MAX_ABS, "flash and dense logits disagree")
    _require(abs(d_loss - flash_loss) < FLASH_VS_DENSE_LOSS, "flash and dense losses disagree")
    return dense


def phase_time_forward(gpt2, models, x, reps=10):
    """Host clock around each synchronised (8, 1024) forward."""
    fwd_flops = gpt2.flops_per_token(models["flash"].config, x.shape[1]) / 3 * x.numel()
    timing = {}
    with torch.inference_mode():
        for name, m in models.items():
            for _ in range(2):
                m(x)
            samples = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m(x)
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            ms, q25, q75 = _spread(samples)
            timing[name] = ms
            _log("forward", f"{name}: {ms:.3f} ms per {tuple(x.shape)} forward (median of {reps}, "
                            f"quartiles {q25:.3f}..{q75:.3f}), {x.numel() / ms * 1e3:.0f} tokens/s, "
                            f"{fwd_flops / 1e12:.3f} TFLOP -> {fwd_flops / (ms / 1e3) / BF16_FLOPS:.4f} "
                            f"of the bf16 peak")
    _log("forward", f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return timing


GEMM_MARKERS = ("nvjet", "gemm", "cutlass", "xmma", "cublas")
KERNEL_GROUPS = (("flash_fwd", "flash fwd"), ("flash_dq", "flash dq"), ("flash_dkv", "flash dkv"))


def _group(name):
    for marker, group in KERNEL_GROUPS:
        if marker in name:
            return group
    return "gemm" if any(m in name.lower() for m in GEMM_MARKERS) else "other"


def phase_profile(run, label, unprofiled_ms, top=6, expect=None):
    """Device time by kernel group over one ``run()`` (torch.profiler).  The
    profiler slows the host, so the device's idle share is taken against the
    unprofiled time as well as the profiled window.  ``expect`` maps a kernel
    name to the launches of it the run must show.  Returns the device-busy
    ms, or None when no device events were recorded."""
    kernels = _device_events(run)
    if not kernels:
        _log("profile", f"{label}: no device events recorded: not measured")
        return None
    for name, n in (expect or {}).items():
        got = sum(name in e.name for e in kernels)
        _require(got == n, f"{label}: {got} launches of {name} profiled, expected {n}")
    busy, window = _busy_window(kernels)
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    _log("profile", f"{label}: {len(kernels)} kernels, device busy {busy / 1e3:.3f} ms; "
                    f"idle share {1 - busy / window:.4f} of the profiled {window / 1e3:.3f} ms window, "
                    f"{1 - busy / 1e3 / unprofiled_ms:.4f} of the unprofiled {unprofiled_ms:.3f} ms")
    groups = {}
    for name, (t, n) in by_name.items():
        gt, gn = groups.get(_group(name), (0.0, 0))
        groups[_group(name)] = (gt + t, gn + n)
    for group, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        _log("profile", f"{label}: {group}: {t / 1e3:.3f} ms ({t / busy:.1%}) in {n} kernels")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        _log("profile", f"{label}: {t / 1e3:8.3f} ms {t / busy:6.1%} x{n:<3d} {name[:90]}")
    return busy / 1e3


def _flash_counts_zero(fa):
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_dq.launches = 0
    fa.flash_attention_dkv.launches = 0


def _counts(fa):
    return {"fwd": fa.flash_attention_fwd.launches, "dq": fa.flash_attention_dq.launches,
            "dkv": fa.flash_attention_dkv.launches}


def phase_train(fa, gpt2, spmd, model, tokens):
    """The training path: 3 warm-up and 10 timed steps on one repeated
    batch.  Every kernel's count is reset just before and read just after;
    each step must launch each kernel once per layer."""
    cfg = model.config
    batch = {"tokens": tokens}
    step = spmd.compile_train_step(
        gpt2.loss_fn, spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1))
    state = spmd.TrainState(0, model)
    losses, norms, samples = [], [], []
    torch.cuda.reset_peak_memory_stats()
    _flash_counts_zero(fa)
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        before = _counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())  # synchronises
        samples.append((time.perf_counter() - t0) * 1e3)
        norms.append(metrics["grad_norm"].item())
        after = _counts(fa)
        per_step = {key: after[key] - before[key] for key in after}
        _require(all(n == cfg.num_layers for n in per_step.values()),
                 f"step {i}: launches {per_step}, expected {cfg.num_layers} of each")
    launches = _counts(fa)
    _require(state.step == TRAIN_WARMUP + TRAIN_STEPS, f"state.step {state.step}")
    _require(all(math.isfinite(x) for x in losses + norms), f"non-finite loss or grad norm: {losses}")
    _require(abs(losses[0] - math.log(cfg.vocab_size)) < LOSS_WINDOW, f"first loss {losses[0]}")
    _require(losses[-1] < losses[0] - 0.1, f"loss did not fall: {losses}")
    _require(all(n > 0 for n in launches.values()), f"a kernel was never launched: {launches}")
    ms, q25, q75 = _spread(samples[TRAIN_WARMUP:])
    n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
    flops = gpt2.flops_per_token(cfg, tokens.shape[1] - 1) * n_tokens
    _log("train", "loss " + " ".join(f"{x:.4f}" for x in losses))
    _log("train", "grad_norm " + " ".join(f"{x:.4f}" for x in norms))
    _log("train", f"kernel launches on the training path: {launches} "
                  f"({cfg.num_layers} of each per step, {len(losses)} steps)")
    _log("train", f"step {ms:.3f} ms (median of {TRAIN_STEPS}, quartiles {q25:.3f}..{q75:.3f}), "
                  f"{n_tokens / ms * 1e3:.0f} tokens/s, {flops / 1e12:.3f} TFLOP per step -> "
                  f"{flops / (ms / 1e3) / BF16_FLOPS:.4f} of the bf16 peak; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, step, state, dict(step_ms=ms, tokens_per_s=n_tokens / ms * 1e3,
                                       losses=losses, peak_gib=torch.cuda.max_memory_allocated() / 2**30)


# [spmd]'s losses against [train]'s: the same weights, batch and
# arithmetic on one rank (the mesh's collectives are identities, its
# DTensors hold the same storage, the kernels run on the same blocks and
# AdamW runs the same foreach kernels), so they must be equal bit for bit.
SPMD_LOSS_TOL = 0.0
DRYRUN_RANKS = 4


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_spmd(fa, gpt2, cfg, tokens, train_out, smi):
    """[spmd]: [train]'s 3 + 10 steps through make_mesh, sharded_init,
    shard_batch and the mesh's compile_train_step over an NCCL group of one."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import mesh as mesh_mod
    from ray_tpu_torch.parallel import spmd

    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        mesh = mesh_mod.make_mesh(mesh_mod.MeshConfig(dp=1), device_type=DEVICE)
        _require(mesh.torch_axes == ("dp",) and mesh.torch_mesh.size() == 1,
                 f"the one-card mesh is {mesh}, expected one rank over 'dp'")
        logical = gpt2.param_logical_axes(cfg)
        state = spmd.sharded_init(
            mesh, lambda: gpt2.init(cfg, torch.Generator(device=DEVICE).manual_seed(1), DEVICE), logical)
        opt = spmd.adamw(state.params.parameters(), 3e-4, weight_decay=0.1)
        step = spmd.compile_train_step(gpt2.loss_fn, opt)
        batch = spmd.shard_batch(mesh, {"tokens": tokens})
        losses, samples = [], []
        torch.cuda.reset_peak_memory_stats()
        _flash_counts_zero(fa)
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            before = _counts(fa)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
            samples.append((time.perf_counter() - t0) * 1e3)
            per_step = {k: v - before[k] for k, v in _counts(fa).items()}
            _require(all(n == cfg.num_layers for n in per_step.values()),
                     f"[spmd] step {i}: launches {per_step}, expected {cfg.num_layers} of each")
        launches = _counts(fa)
        peak = torch.cuda.max_memory_allocated() / 2**30
        wrong = spmd.layout_errors(mesh, state.params, logical, opt)
        _require(not wrong, f"[spmd] parameters or moments not laid out by the rules: {wrong}")
    finally:
        mesh_mod.set_current_mesh(None)
        dist.destroy_process_group()
    diffs = [abs(a - b) for a, b in zip(losses, train_out["losses"])]
    ms, q25, q75 = _spread(samples[TRAIN_WARMUP:])
    n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
    _log("spmd", "loss " + " ".join(f"{x:.4f}" for x in losses))
    _log("spmd", f"largest |loss - [train]'s| over {len(diffs)} steps: {max(diffs):.3g} "
                 f"({'bit for bit' if max(diffs) == 0 else 'not bit for bit'}; bound "
                 f"{SPMD_LOSS_TOL}); kernel launches {launches} ({cfg.num_layers} of each per step)")
    _log("spmd", f"{smi}: mesh {mesh} step {ms:.3f} ms (median of {TRAIN_STEPS}, quartiles "
                 f"{q25:.3f}..{q75:.3f}) beside [train]'s {train_out['step_ms']:.3f} ms; "
                 f"{n_tokens / ms * 1e3:.0f} tokens/s beside {train_out['tokens_per_s']:.0f}; peak memory "
                 f"{peak:.2f} GiB beside [train]'s {train_out['peak_gib']:.2f} GiB")
    _require(max(diffs) <= SPMD_LOSS_TOL, f"[spmd] losses differ from [train]'s by up to {max(diffs)}")
    _require(losses[-1] < losses[0] - 0.1, f"[spmd] loss did not fall: {losses}")
    return {"launches": launches, "losses": losses, "max_loss_diff": max(diffs), "step_ms": ms,
            "tokens_per_s": n_tokens / ms * 1e3, "peak_gib": peak}


def phase_dryrun():
    """[dryrun]: dryrun_multigpu over gloo ranks on the host's CPU."""
    from ray_tpu_torch.dryrun import dryrun_multigpu

    t0 = time.perf_counter()
    lines = dryrun_multigpu(DRYRUN_RANKS, device_type="cpu")
    for line in lines:
        _log("dryrun", line)
    passes = [line.split(":")[0] for line in lines]
    _require(passes == ["dryrun_multigpu OK", "dryrun_multigpu MoE OK", "dryrun_multigpu pipeline OK",
                        "dryrun_multigpu decode OK", "dryrun_multigpu vit OK",
                        "dryrun_multigpu rllib OK", "dryrun_multigpu distributed OK"],
             f"[dryrun] passes {passes}")
    _log("dryrun", f"{len(lines)} passes over {DRYRUN_RANKS} gloo ranks on the CPU in "
                   f"{time.perf_counter() - t0:.1f} s (losses are CPU numbers)")
    return lines


# [pipeline]: [train]'s weights (seed 1) and batch through the MPMD
# pipeline's single-gang runner on the card: GPT-2-124M cut into 4 stages of 3
# layers (first, middle and last roles all run), 4 microbatches of 2 rows.
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS = 4, 4, 2
# Its losses against [train]'s: the same weights, tokens and AdamW, in bf16;
# what differs is the reduction order (4 microbatches of 2 rows, their
# gradients summed in f32, against one batch of 8), the GEMMs' row counts
# and the tied embedding's gradient (two halves summed, against one
# backward).  The first loss sees the same weights and differs only by the
# GEMMs' and the mean's summation order; over 13 steps AdamW carries the
# gradients' differences into the weights.
PIPE_FIRST_TOL = 2e-3
PIPE_LOSS_TOL = 2e-2
# [pipeline-mpmd]: the reference's bit-parity configuration
# (tests/test_zz_pipeline.py), CPU stage actors on the host.
MPMD_LAYERS, MPMD_STAGES, MPMD_STEPS = 3, 3, 3


def pipeline_launches(cfg, n_stages, n_micro):
    """Each flash kernel's launches in one step of the MPMD pipeline: per
    microbatch, every non-last stage's layers run the forward kernel twice
    (the forward, then its recompute in the backward), the last stage's
    once, and every layer launches dq and dk/dv once."""
    L = cfg.num_layers
    return {"fwd": n_micro * (2 * L - L // n_stages), "dq": n_micro * L, "dkv": n_micro * L}


def phase_pipeline(fa, gpt2, cfg, tokens, train_out, smi):
    """[pipeline]: [train]'s 3 + 10 steps through LocalPipelineRunner on
    the card, [train]'s seed-1 weights carried in through the cut."""
    from ray_tpu_torch.models import pp
    from ray_tpu_torch.train import pipeline as tp

    _require(PIPE_MICRO * PIPE_ROWS == tokens.shape[0], f"[pipeline] batch {tuple(tokens.shape)}")
    pc = tp.PipelineConfig(model_config=cfg, n_stages=PIPE_STAGES, n_micro=PIPE_MICRO,
                           micro_batch=PIPE_ROWS, seq_len=tokens.shape[1] - 1,
                           optimizer={"name": "adamw", "lr": 3e-4, "weight_decay": 0.1}, device=DEVICE)
    model = gpt2.init(cfg, torch.Generator(device=DEVICE).manual_seed(1), DEVICE)
    runner = tp.LocalPipelineRunner(pc, pp.get_partition("gpt2", cfg).to_pp(model, PIPE_STAGES))
    del model
    batch = tokens.reshape(PIPE_MICRO, PIPE_ROWS, -1)
    x, y = batch[..., :-1], batch[..., 1:]
    want = pipeline_launches(cfg, PIPE_STAGES, PIPE_MICRO)
    losses, samples = [], []
    torch.cuda.reset_peak_memory_stats()
    _flash_counts_zero(fa)
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        before = _counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(runner.run_step(x, y))
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: v - before[k] for k, v in _counts(fa).items()}
        _require(per_step == want, f"[pipeline] step {i}: launches {per_step}, expected {want}")
    launches = _counts(fa)
    peak = torch.cuda.max_memory_allocated() / 2**30
    diffs = [abs(a - b) for a, b in zip(losses, train_out["losses"])]
    ms, q25, q75 = _spread(samples[TRAIN_WARMUP:])
    n_tokens = PIPE_MICRO * PIPE_ROWS * pc.seq_len
    # two more steps (a warm-up and the profiled one), after the checks'
    # counts were read
    busy = (phase_profile(lambda: runner.run_step(x, y), "one [pipeline] step", ms, top=8)
            if DEVICE == "cuda" else None)
    _log("pipeline", "loss " + " ".join(f"{v:.4f}" for v in losses))
    _log("pipeline", f"{PIPE_STAGES} stages of {cfg.num_layers // PIPE_STAGES} layers, {PIPE_MICRO} "
                     f"microbatches of {PIPE_ROWS} rows; kernel launches {launches} ({want} per step); "
                     f"|loss - [train]'s|: first {diffs[0]:.3g} (bound {PIPE_FIRST_TOL}), largest "
                     f"{max(diffs):.3g} (bound {PIPE_LOSS_TOL})")
    _log("pipeline", f"{smi}: step {ms:.3f} ms (median of {TRAIN_STEPS}, quartiles {q25:.3f}..{q75:.3f}) "
                     f"beside [train]'s {train_out['step_ms']:.3f} ms; {n_tokens / ms * 1e3:.0f} tokens/s "
                     f"beside {train_out['tokens_per_s']:.0f}; peak memory {peak:.2f} GiB beside "
                     f"[train]'s {train_out['peak_gib']:.2f} GiB")
    _require(all(math.isfinite(v) for v in losses), f"[pipeline] non-finite loss: {losses}")
    _require(losses[-1] < losses[0] - 0.1, f"[pipeline] loss did not fall: {losses}")
    _require(diffs[0] <= PIPE_FIRST_TOL, f"[pipeline] first loss {losses[0]} against [train]'s "
                                         f"{train_out['losses'][0]}")
    _require(max(diffs) <= PIPE_LOSS_TOL, f"[pipeline] losses differ from [train]'s by up to {max(diffs)}")
    return {"launches": launches, "per_step": want, "losses": losses, "first_loss_diff": diffs[0],
            "max_loss_diff": max(diffs), "step_ms": ms, "tokens_per_s": n_tokens / ms * 1e3,
            "peak_gib": peak, "busy_ms": busy}


def phase_pipeline_mpmd(smi):
    """[pipeline-mpmd]: PipelineTrainer over CPU stage actors on the port's
    runtime, bit for bit against LocalPipelineRunner under both handoffs;
    then a "cuda" trainer wanting more cards than the node has is refused."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import pipeline as tp

    cfg = gpt2.GPTConfig.tiny(num_layers=MPMD_LAYERS, max_seq_len=32)
    out = {}
    t0 = time.perf_counter()
    rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    try:
        for handoff in ("p2p", "driver"):
            pc = tp.PipelineConfig(model_config=cfg, n_stages=MPMD_STAGES, n_micro=4, micro_batch=2,
                                   seq_len=32, optimizer={"name": "adam", "lr": 1e-3},
                                   name=f"chip-smoke-{handoff}", handoff=handoff, device="cpu")
            batches = tp.synthetic_batches(pc, MPMD_STEPS)
            trainer = tp.PipelineTrainer(pc)
            t1 = time.perf_counter()
            try:
                trainer.start()
                t2 = time.perf_counter()
                losses = trainer.train(batches)
                t3 = time.perf_counter()
                got = trainer.gather_params().state_dict()
                executed = sum(c["executed"] for lanes in trainer.counters() for c in lanes)
            finally:
                trainer.shutdown()
            ref = tp.LocalPipelineRunner(pc)
            want = ref.train(batches)
            want_params = ref.gather_params().state_dict()
            same = [k for k in want_params if torch.equal(got[k], want_params[k])]
            _log("pipeline-mpmd", f"{handoff}: losses {losses} against the local runner's {want}; "
                                  f"{len(same)} of {len(want_params)} parameters bit-equal; "
                                  f"{executed} micro-ops (ideal {trainer.ideal_micro_ops(MPMD_STEPS)}); "
                                  f"start {t2 - t1:.2f} s, {MPMD_STEPS} steps {t3 - t2:.2f} s")
            _require(losses == want, f"[pipeline-mpmd] {handoff}: losses {losses} != {want}")
            _require(len(same) == len(want_params), f"[pipeline-mpmd] {handoff}: parameters differ")
            _require(executed == trainer.ideal_micro_ops(MPMD_STEPS),
                     f"[pipeline-mpmd] {handoff}: {executed} micro-ops executed")
            out[handoff] = {"losses": losses, "start_s": t2 - t1, "steps_s": t3 - t2}
        # A "cuda" pipeline of 2 stages on this node, which has one card:
        # refused at start(), before any stage is placed.
        cards = rt.cluster_resources().get("GPU", 0)
        _require(cards == 1, f"[pipeline-mpmd] the cluster has {cards} GPU(s), expected this node's 1")
        before, avail = set(_descendants(os.getpid())), rt.available_resources()
        t1 = time.perf_counter()
        try:
            tp.PipelineTrainer(tp.PipelineConfig(model_config=gpt2.GPTConfig.tiny(), n_stages=2,
                                                 name="chip-smoke-refused")).start()
            refused = None
        except RuntimeError as e:
            refused = str(e)
        refuse_s = time.perf_counter() - t1
        started = set(_descendants(os.getpid())) - before
        _log("pipeline-mpmd", f"a cuda trainer of 2 stages on {cards:g} card(s): {refused!r} after "
                              f"{refuse_s:.3f} s; processes started {sorted(started)}")
        _require(refused is not None and "wants 2 GPU(s)" in refused and "the cluster has 1" in refused,
                 f"[pipeline-mpmd] the cuda trainer was not refused naming 2 and 1: {refused!r}")
        _require(refuse_s < 30, f"[pipeline-mpmd] the refusal took {refuse_s:.1f} s")
        _require(not started and rt.available_resources() == avail,
                 f"[pipeline-mpmd] the refused trainer started {sorted(started)}")
        out["refused"] = refused
    finally:
        _shutdown_checked(rt, rt_api, "pipeline-mpmd")
    _log("pipeline-mpmd", f"shutdown(): no process of the driver remains; {time.perf_counter() - t0:.1f} s "
                          f"in all ({smi})")
    return out


# [rllib]: the eight learners' updates on the card against the same updates
# on the CPU (same seed-drawn weights, same seeded batches, f32 with TF32 off
# for convolutions and products), at two shapes: the reference's default MLP
# (64, 64) at CartPole's (obs 4, 2 actions), and the catalog's CNN at Atari's
# (84, 84, 4) frames with 6 actions (filters (16, 8, 4), (32, 4, 2), hidden
# 256: Mnih et al., 2013; 9x9x32 features, 677,943 parameters), each at its
# config's own batch.  The CPU runs the same updates twice, in f32 and in f64
# (exact arithmetic's stand-in), and each f32 result is measured by its
# distance from the f64 one, relative to the norm, tensor by tensor (the
# largest is read): the first update's gradients and the parameters after
# RL_UPDATES updates.  The card's distance must be within
# RL_GRAD_TOL (gradients) and RL_PARAM_TOL (parameters), or within
# RL_FLOOR_FACTOR times the CPU's own f32 distance, whichever is larger:
# f32 itself is farther than that in places.  A sum that cancels loses
# digits (the CPU's convolution gradients of BC's CNN stand 5e-4 from f64),
# and Adam divides a gradient by its own size, so an element whose gradient
# is near zero steps by up to lr on the sign of its rounding (the CPU's BC
# CNN parameters stand 1.8e-4 from f64 after 3 updates at lr 1e-3).  The
# factor leaves room for which elements' signs flip; each tensor has its
# own floor, from the CPU's distance for that tensor.  The card's distance
# from the CPU's f32 result is printed beside them.  On the H100 the card's
# largest tensor distances read 1.1e-6 (gradients) and 4.3e-5 (parameters:
# the CNN PPO's one-element value bias, whose gradient is a mean that
# cancels as the value fits, over 12 Adam steps; 2.5e-5 for IMPALA's first
# conv bias), so RL_PARAM_TOL stays 1e-4, now for every tensor.  The same
# holds for RL_ALGO_ITERS training_steps of PPO, DQN and SAC through the
# algorithms (LearnerGroup, GAE and advantage normalisation, replay
# sampling, DQN's target sync, SAC's polyak averages) at the MLP, fed the
# same seeded fragments by _SeededFragments in place of the env runners,
# within RL_ALGO_TOL (the card reads 9e-7 there); then a save/restore onto
# a fresh card algorithm must give back its weights (and PPO's optimizer
# state) bit for bit on the card, and PPO's next iteration there must stay
# within RL_ALGO_TOL of the original's.
RL_SEED = 0
RL_UPDATES = 3
RL_ALGO_ITERS = 3
RL_GRAD_TOL = 1e-5
RL_PARAM_TOL = 1e-4
RL_ALGO_TOL = 1e-5
RL_FLOOR_FACTOR = 3.0
RL_TIME_WARMUP, RL_TIME_ITERS = 3, 20
RL_CNN_OBS, RL_CNN_ACTIONS = (84, 84, 4), 6
RL_PROFILED = ("PPO", "DQN")  # one update of each profiled by kernel


def _rl_batch(kind, mc, rows, rng):
    """A seeded numpy batch of ``kind`` for module config ``mc``: Atari
    frames in [0, 1), CartPole-like observations from a unit normal."""
    import numpy as np

    shape = getattr(mc, "obs_shape", None)
    dim = int(np.prod(shape)) if shape else mc.obs_dim
    A = mc.num_actions

    def obs(*lead):
        x = rng.random((*lead, dim)) if shape else rng.normal(size=(*lead, dim))
        return x.astype(np.float32)

    def logp(*lead):
        return (np.log(1.0 / A) + 0.2 * rng.normal(size=lead)).astype(np.float32)

    if kind == "fragment":  # IMPALA/APPO: one (T, B) fragment
        T, B = rows
        return {"obs": obs(T, B), "actions": rng.integers(0, A, (T, B)).astype(np.int32), "logp": logp(T, B),
                "rewards": rng.normal(size=(T, B)).astype(np.float32),
                "dones": (rng.random((T, B)) < 0.05).astype(np.float32), "last_obs": obs(B)}
    out = {"obs": obs(rows), "actions": rng.integers(0, A, rows).astype(np.int32)}
    if kind == "ppo":
        out.update(logp=logp(rows), advantages=rng.normal(size=rows).astype(np.float32),
                   returns=rng.normal(size=rows).astype(np.float32))
    elif kind == "transitions":
        out.update(rewards=rng.normal(size=rows).astype(np.float32), next_obs=obs(rows),
                   dones=(rng.random(rows) < 0.05).astype(np.float32))
    elif kind == "returns":
        out.update(returns=(5 * rng.normal(size=rows)).astype(np.float32))
    return out


def _rl_learners():
    """name -> (make(device, module_config), batch kind, rows, Adam steps
    an update), each learner at its config's defaults and own batch."""
    from ray_tpu_torch.rllib import appo, cql, dqn, impala, marwil, offline, ppo, sac

    def make(learner_cls, config_cls):
        return lambda dev, mc: learner_cls(config_cls(seed=RL_SEED).learners(0, device=dev), mc)

    T, B = impala.IMPALAConfig.rollout_fragment_length, impala.IMPALAConfig.num_envs_per_runner
    p = ppo.PPOConfig
    return {
        "PPO": (make(ppo.PPOLearner, ppo.PPOConfig), "ppo", p.minibatch_size, p.num_epochs),
        "DQN": (make(dqn.DQNLearner, dqn.DQNConfig), "transitions", dqn.DQNConfig.train_batch_size, 1),
        "IMPALA": (make(impala.IMPALALearner, impala.IMPALAConfig), "fragment", (T, B), 1),
        "APPO": (make(appo.APPOLearner, appo.APPOConfig), "fragment", (T, B), 1),
        "SAC": (make(sac.SACLearner, sac.SACConfig), "transitions", sac.SACConfig.train_batch_size, 1),
        "BC": (make(offline.BCLearner, offline.BCConfig), "bc", offline.BCConfig.train_batch_size, 1),
        "CQL": (make(cql.CQLLearner, cql.CQLConfig), "transitions", cql.CQLConfig.train_batch_size, 1),
        "MARWIL": (make(marwil.MARWILLearner, marwil.MARWILConfig), "returns",
                   marwil.MARWILConfig.train_batch_size, 1),
    }



def _update_ms(learner, batch, dev):
    """Median ms of one update (its metrics read back: one host sync)."""
    samples = []
    for i in range(RL_TIME_WARMUP + RL_TIME_ITERS):
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        learner.update(batch)
        if dev == "cuda":
            torch.cuda.synchronize()
        if i >= RL_TIME_WARMUP:
            samples.append((time.perf_counter() - t0) * 1e3)
    return _spread(samples)[0]


def _rl_rel(got, want):
    """‖got − want‖ / ‖want‖ over the tensors of two state dicts together."""
    d = sum((got[k].double() - w.double()).square().sum().item() for k, w in want.items())
    n = sum(w.double().square().sum().item() for w in want.values())
    return math.sqrt(d / max(n, 1e-300))


def _rl_tensor_rel(got, want):
    """The largest tensor's ‖got − want‖ / ‖want‖."""
    return max(_rl_rels(got, want).values())


def _rl_rels(got, want):
    """Each tensor's ‖got − want‖ / ‖want‖."""
    return {n: _rl_rel({n: got[n]}, {n: want[n]}) for n in want}


def _rl_held(card, cpu, f64, tol):
    """The card's distance from the f64 run against each tensor's bound:
    ``tol``, or RL_FLOOR_FACTOR times the CPU's own f32 distance for that
    tensor, whichever is larger.  Returns (the largest card distance, the
    largest CPU distance, the largest share of its bound and its tensor)."""
    d_card, d_cpu = _rl_rels(card, f64), _rl_rels(cpu, f64)
    share = {n: d_card[n] / max(tol, RL_FLOOR_FACTOR * d_cpu[n]) for n in f64}
    worst = max(share, key=share.get)
    return max(d_card.values()), max(d_cpu.values()), share[worst], worst


def _rl_f64(learner):
    """``learner`` computing in f64: its modules, its optimizer's state (made
    at the first step) and its batches."""
    learner.module.double()
    if hasattr(learner, "target"):
        learner.target.double()
    to_tensors = learner._batch
    learner._batch = lambda b: {k: v.double() if v.is_floating_point() else v for k, v in to_tensors(b).items()}
    return learner


def phase_rllib_learners(smi, device=None):
    """(a): each learner's first gradients and its parameters after
    RL_UPDATES updates on the card and on the CPU, each against the CPU's
    f64 run of the same updates, then each update's ms on both (median of
    RL_TIME_ITERS after RL_TIME_WARMUP), at the MLP and the Atari CNN."""
    import numpy as np

    from ray_tpu_torch.models import catalog
    from ray_tpu_torch.rllib import core

    device = device or DEVICE
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    _log("rllib", f"TF32 for the learners' check: matmul {torch.backends.cuda.matmul.allow_tf32}, "
                  f"cudnn {torch.backends.cudnn.allow_tf32} (were {flags[0]}, {flags[1]})")
    shapes = {"MLP (64, 64) at CartPole's obs 4 / 2 actions": core.MLPModuleConfig(4, 2),
              f"CNN at Atari's {RL_CNN_OBS} / {RL_CNN_ACTIONS} actions": catalog.get_module_config(
                  RL_CNN_OBS, RL_CNN_ACTIONS)}
    out = {}
    try:
        for label, mc in shapes.items():
            n_params = sum(p.numel() for p in core.module_init(mc, None, "cpu").parameters())
            _log("rllib", f"{label}: {n_params} parameters a module")
            for name, (make, kind, rows, steps) in _rl_learners().items():
                key = f"{'cnn' if hasattr(mc, 'obs_shape') else 'mlp'}/{name}"
                rng = np.random.default_rng(RL_SEED)
                batches = [_rl_batch(kind, mc, rows, rng) for _ in range(RL_UPDATES)]
                learners = {"card": make(device, mc), "cpu": make("cpu", mc), "f64": _rl_f64(make("cpu", mc))}
                w0 = {k: v.get_weights() for k, v in learners.items()}
                _require(all(torch.equal(w0["card"][n], w0[k][n].float()) for k in w0 for n in w0["cpu"]),
                         f"[rllib] {key}: the learners start apart")
                g = {k: v.compute_grads(batches[0])[0] for k, v in learners.items()}
                for b in batches:
                    for learner in learners.values():
                        learner.update(b)
                w = {k: v.get_weights() for k, v in learners.items()}

                gc, gcpu, gshare, gworst = _rl_held(g["card"], g["cpu"], g["f64"], RL_GRAD_TOL)
                pc, pcpu, pshare, pworst = _rl_held(w["card"], w["cpu"], w["f64"], RL_PARAM_TOL)
                r = {"grad_card_f64": gc, "grad_cpu_f64": gcpu, "grad_card_cpu": _rl_tensor_rel(g["card"], g["cpu"]),
                     "grad_share": gshare, "param_card_f64": pc, "param_cpu_f64": pcpu,
                     "param_card_cpu": _rl_tensor_rel(w["card"], w["cpu"]), "param_share": pshare}
                ms = {"card": _update_ms(learners["card"], batches[0], device),
                      "cpu": _update_ms(learners["cpu"], batches[0], "cpu")}
                out[key] = {"card_ms": ms["card"], "cpu_ms": ms["cpu"], **r, "rows": rows, "steps": steps}
                if device == "cuda" and name in RL_PROFILED:  # two more updates, after the checks
                    out[key]["busy_ms"] = phase_profile(lambda: learners["card"].update(batches[0]),
                                                        f"one [rllib] {key} update", ms["card"], top=4)
                _log("rllib", f"{key}: {rows} rows, {steps} Adam step(s) an update: card {ms['card']:.3f} ms, "
                              f"CPU {ms['cpu']:.3f} ms (card {ms['cpu'] / ms['card']:.2f}x as fast); largest "
                              f"tensor distance from f64, first gradients: card {gc:.3g}, CPU {gcpu:.3g}, "
                              f"card-CPU {r['grad_card_cpu']:.3g}, card/bound {gshare:.3g} at {gworst}; "
                              f"parameters after {RL_UPDATES} updates: card {pc:.3g}, CPU {pcpu:.3g}, card-CPU "
                              f"{r['param_card_cpu']:.3g}, card/bound {pshare:.3g} at {pworst}")
                _require(gshare <= 1.0, f"[rllib] {key}: the card's first gradients from f64 at {gworst}: "
                                        f"{gshare} of the bound")
                _require(pshare <= 1.0, f"[rllib] {key}: the card's parameters from f64 after {RL_UPDATES} "
                                        f"updates at {pworst}: {pshare} of the bound")
                del learners
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    _log("rllib", f"{len(out)} learner updates held on the card against the CPU ({smi})")
    return out


class _CartPoleSpaces:
    """What ``probe_env_spaces`` reads of CartPole-v1: obs (4,), 2 actions."""

    observation_space = type("Box", (), {"shape": (4,)})
    action_space = type("Discrete", (), {"n": 2})

    def close(self):
        pass


class _SeededFragments:
    """Stands in for an EnvRunnerGroup (no env steps: the card's machine
    has no gymnasium): every ``sample`` returns the next CartPole-shaped
    fragments drawn from one seed, the same for every algorithm made with
    that seed."""

    def __init__(self, env, module_config, num_runners=2, num_envs_per_runner=4, seed=0, **_):
        import numpy as np

        self.rng = np.random.default_rng(100 + seed)
        self.n, self.B = num_runners, num_envs_per_runner
        self.dim, self.A = module_config.obs_dim, module_config.num_actions

    def sample(self, T, epsilon=None):
        import numpy as np

        r, B, A, D = self.rng, self.B, self.A, self.dim
        return [{"obs": r.normal(size=(T, B, D)).astype(np.float32),
                 "actions": r.integers(0, A, (T, B)).astype(np.int32),
                 "rewards": r.normal(size=(T, B)).astype(np.float32),
                 "dones": (r.random((T, B)) < 0.05).astype(np.float32),
                 "logp": (np.log(1.0 / A) + 0.2 * r.normal(size=(T, B))).astype(np.float32),
                 "values": r.normal(size=(T, B)).astype(np.float32),
                 "last_values": r.normal(size=B).astype(np.float32),
                 "final_obs": r.normal(size=(B, D)).astype(np.float32),
                 "episode_returns": r.uniform(5, 50, size=2)} for _ in range(self.n)]

    def sync_weights(self, _params):
        pass

    def stop(self):
        pass


def _rl_algorithms():
    """name -> (module, config, learner of an algorithm), each at its
    config's defaults but: PPO's minibatch is a whole iteration's rows (its
    permutation is wall-clock seeded, so one minibatch an epoch keeps the
    update the same on every device); DQN and SAC learn from their first
    iteration, 8 updates an iteration, and DQN syncs its target every 8."""
    from ray_tpu_torch.rllib import algorithm, dqn, ppo, sac

    a = algorithm.AlgorithmConfig
    per_frag = a.num_env_runners * a.num_envs_per_runner
    replay_rows = per_frag * dqn.DQNConfig.rollout_fragment_length
    replay = dict(learning_starts=replay_rows, updates_per_env_step=8 / replay_rows, seed=RL_SEED)
    return {
        "PPO": (ppo, ppo.PPOConfig(minibatch_size=per_frag * ppo.PPOConfig.rollout_fragment_length, seed=RL_SEED),
                lambda algo: algo.learner_group.local),
        "DQN": (dqn, dqn.DQNConfig(target_update_freq=8, **replay), lambda algo: algo.learner_group.local),
        "SAC": (sac, sac.SACConfig(**replay), lambda algo: algo.learner),
    }


def _rl_learner_state(learner):
    """The learner's weights, and DQN's target, as CPU state dicts."""
    out = {f"module.{k}": v for k, v in learner.get_weights().items()}
    if hasattr(learner, "target"):
        out.update({f"target.{k}": v.detach().cpu() for k, v in learner.target.state_dict().items()})
    return out


def phase_rllib_algorithms(smi, device=None):
    """(a'): RL_ALGO_ITERS training_steps of PPO, DQN and SAC on the card,
    on the CPU and on the CPU in f64, from the same seeded fragments; the
    card's parameters from f64 within RL_ALGO_TOL or RL_FLOOR_FACTOR of
    the CPU's, tensor by tensor; then save/restore onto a fresh card
    algorithm and one more iteration of both."""
    import copy
    import tempfile

    device = device or DEVICE
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, (mod, config, learner_of) in _rl_algorithms().items():
            runners, mod.EnvRunnerGroup = mod.EnvRunnerGroup, _SeededFragments
            algos = {}
            try:
                for k, dev in (("card", device), ("cpu", "cpu"), ("f64", "cpu"), ("fresh", device)):
                    algos[k] = config.environment(_CartPoleSpaces).learners(0, device=dev).build()
                _rl_f64(learner_of(algos["f64"]))
                w0 = {k: _rl_learner_state(learner_of(a)) for k, a in algos.items()}
                _require(all(torch.equal(w0["card"][n], w0[k][n].float()) for k in w0 for n in w0["card"]),
                         f"[rllib] {name}: the algorithms start apart")
                ms = {}
                for k in ("card", "cpu", "f64"):
                    samples = []
                    for _ in range(RL_ALGO_ITERS):
                        t0 = time.perf_counter()
                        res = algos[k].train()
                        if k == "card" and device == "cuda":
                            torch.cuda.synchronize()
                        samples.append((time.perf_counter() - t0) * 1e3)
                    ms[k] = samples
                    _require(res["training_iteration"] == RL_ALGO_ITERS
                             and all(math.isfinite(v) for v in res.values() if isinstance(v, float)),
                             f"[rllib] {name} on {k}: {res}")
                w = {k: _rl_learner_state(learner_of(algos[k])) for k in ("card", "cpu", "f64")}
                pc, pcpu, pshare, pworst = _rl_held(w["card"], w["cpu"], w["f64"], RL_ALGO_TOL)
                r = {"param_card_f64": pc, "param_cpu_f64": pcpu, "param_share": pshare,
                     "param_card_cpu": _rl_tensor_rel(w["card"], w["cpu"]),
                     # the least any tensor moved, of those that moved past f32's rounding (an
                     # unused head's polyak average of equal values moves by rounding alone)
                     "moved": min(m for m in _rl_rels(w0["f64"], w["f64"]).values()
                                  if m > torch.finfo(torch.float32).eps)}
                card = learner_of(algos["card"])
                steps = getattr(card, "grad_steps", None)
                # save/restore onto a fresh card algorithm, then one more iteration of both
                path = tempfile.mkdtemp(prefix="rllib-ckpt-")
                algos["card"].save(path)
                algos["fresh"].restore(path)
                fresh = learner_of(algos["fresh"])
                got, want = fresh.get_weights(), card.get_weights()  # DQN's target is not in the checkpoint
                same = all(torch.equal(got[n], want[n]) for n in want)
                on_card = all(p.device.type == torch.device(device).type for p in fresh.module.parameters())
                opt_same = True
                if name == "PPO":  # the optimizer's state comes back, on the card
                    a_st, b_st = card.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
                    opt_same = a_st.keys() == b_st.keys() and all(
                        torch.equal(a_st[i][k].cpu(), b_st[i][k].cpu())
                        and (k == "step" or b_st[i][k].device.type == torch.device(device).type)
                        for i in a_st for k in a_st[i])
                # the checkpoint holds no replay buffer (as the reference's): only
                # PPO's next iteration can be held against the original's
                algos["fresh"].env_runner_group.rng = copy.deepcopy(algos["card"].env_runner_group.rng)
                after = {k: algos[k].train() for k in ("card", "fresh")}
                if name == "PPO":
                    r["restored_next"] = _rl_tensor_rel(_rl_learner_state(fresh), _rl_learner_state(card))
                out[name] = {**r, "card_ms": ms["card"], "cpu_ms": ms["cpu"], "grad_steps": steps}
                _log("rllib", f"{name}: {RL_ALGO_ITERS} training_steps from seeded fragments, per iteration card "
                              f"{', '.join(f'{x:.1f}' for x in ms['card'])} ms, CPU "
                              f"{', '.join(f'{x:.1f}' for x in ms['cpu'])} ms; largest tensor distance from "
                              f"f64: card {pc:.3g}, CPU {pcpu:.3g}, card-CPU {r['param_card_cpu']:.3g}, "
                              f"card/bound {pshare:.3g} at {pworst}; smallest tensor move {r['moved']:.3g}" + (f"; {steps} gradient steps" if steps is not None else "")
                              + f"; save/restore onto a fresh card algorithm: weights bit for bit {same}, on the "
                              f"card {on_card}" + (f", optimizer state bit for bit on the card {opt_same}"
                                                   if name == "PPO" else "")
                              + f"; iteration {after['fresh']['training_iteration']} after it"
                              + (f", from the original's {r['restored_next']:.3g}" if name == "PPO" else ""))
                _require(pshare <= 1.0, f"[rllib] {name}: the card's parameters from f64 after {RL_ALGO_ITERS} "
                                        f"training_steps at {pworst}: {pshare} of the bound")
                _require(r["moved"] > 10 * RL_FLOOR_FACTOR * max(RL_ALGO_TOL, pcpu),
                         f"[rllib] {name}: a tensor moved {r['moved']}, near the bound")
                _require(steps is None or steps == 8 * RL_ALGO_ITERS, f"[rllib] {name}: {steps} gradient steps")
                _require(same and on_card and opt_same, f"[rllib] {name}: save/restore onto the card lost state")
                _require(after["fresh"]["training_iteration"] == after["card"]["training_iteration"]
                         == RL_ALGO_ITERS + 1, f"[rllib] {name}: iterations {after}")
                _require(r.get("restored_next", 0.0) <= RL_ALGO_TOL,
                         f"[rllib] {name}: the restored algorithm's next iteration {r.get('restored_next')} apart")
            finally:
                mod.EnvRunnerGroup = runners
                for a in algos.values():
                    a.stop()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return out


def _rllib_refusal():
    """(c): a LearnerGroup of 2 learners on "cuda", on a node of one card:
    refused when the algorithm is made, before any env is probed or any
    process started (no runtime runs: the node's cards are detected as the
    raylet would)."""
    from ray_tpu_torch.rllib import PPOConfig

    try:
        PPOConfig().environment("CartPole-v1").learners(2, device="cuda").build()
        refused = None
    except RuntimeError as e:
        refused = str(e)
    _log("rllib", f"PPOConfig().learners(2, device='cuda') on this node: {refused!r}")
    _require(refused is not None and "wants 2 GPU(s)" in refused and "the node has 1" in refused,
             f"[rllib] 2 card learners were not refused naming 2 and 1: {refused!r}")
    return refused


def phase_rllib(fa, smi):
    """[rllib]: (a) the learners on the card against the CPU, then PPO,
    DQN and SAC as algorithms with a save/restore onto the card, (c) the
    refusal, (d) no flash launch.  (b), PPO on CartPole from a card
    learner, needs gymnasium for its env runners, which the card's machine
    lacks (the [probe] line)."""
    t0 = time.perf_counter()
    _flash_counts_zero(fa)
    learners = phase_rllib_learners(smi)
    algorithms = phase_rllib_algorithms(smi)
    refused = _rllib_refusal()
    counts = _counts(fa)
    _require(not any(counts.values()), f"[rllib] launched flash kernels: {counts}")
    _log("done", f"[rllib] {time.perf_counter() - t0:.1f} s; flash kernel launches on it: {counts}")
    return {"learners": learners, "algorithms": algorithms, "refused": refused, "launches": counts}

# [podracer]: the Podracer plane's learner actor on the card.  (a) holds it
# against an in-process CPU learner and an f64 one on a seeded fragment
# sequence shaped like tests/test_torch_podracer.py's (K = 1, 2 fragments a
# batch: drops stale at ingest and while queued, suspect fragments); (b)
# runs it under PodracerRunner, fed by two CPU runner actors at the CNN.
POD_K, POD_BATCH_FRAGMENTS = 1, 2
POD_SEQUENCE = [(0, 0, False), (1, 0, True), (2, 1, False), "bump", "bump", (3, 1, False),
                (4, 3, False), (5, 2, True), (6, 0, False), (7, 4, False), (8, 3, False)]
POD_SEQUENCE_UPDATES = 3
POD_FLEET_UPDATES, POD_FLEET_K, POD_FLEET_T, POD_FLEET_ENVS, POD_FLEET_RUNNERS = 20, 4, 32, 4, 2
POD_FANOUT_REPS = 5


def _pod_factory(mc, device):
    from ray_tpu_torch.rllib import impala

    return functools.partial(impala.IMPALALearner, impala.IMPALAConfig(seed=RL_SEED).learners(0, device=device), mc)


def _pod_fragment(mc, T, B, rng):
    """A seeded IMPALA fragment for ``mc`` as an env runner returns it
    (observations in the module's shape)."""
    b = _rl_batch("fragment", mc, (T, B), rng)
    shape = tuple(getattr(mc, "obs_shape", None) or (mc.obs_dim,))
    return {"obs": b["obs"].reshape(T, B, *shape), "actions": b["actions"], "logp": b["logp"],
            "rewards": b["rewards"], "dones": b["dones"], "final_obs": b["last_obs"].reshape(B, *shape),
            "episode_returns": rng.uniform(5, 50, size=1)}


def _pod_meta(seq, version, suspect, env_steps):
    return {"runner_index": seq % 2, "seq": seq, "policy_version": version, "env_steps": env_steps,
            "suspect": suspect, "incarnation": 0}


def _tf32_off(_inst):
    # imported here: a function that names torch.backends.cudnn through
    # the global torch cannot be pickled (its module object is not a module)
    import torch.backends.cuda as backends_cuda
    import torch.backends.cudnn as backends_cudnn

    backends_cuda.matmul.allow_tf32 = backends_cudnn.allow_tf32 = False
    return True


def _learner_facts(inst):
    """The learner actor's process: argv, foreign modules, its cards, its
    parameters' device and the flash kernels' counts there."""
    fa = sys.modules.get("ray_tpu_torch.ops.flash_attention")
    return {**_worker_facts(), "device_count": torch.cuda.device_count(),
            "param_device": str(next(inst.learner.module.parameters()).device),
            "flash_launches": _counts(fa) if fa is not None else {"fwd": 0, "dq": 0, "dkv": 0}}


def _busy_window(kernels):
    """(device-busy us, window us) of profiled kernels: their merged spans
    and the span from the first start to the last end."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    return busy + cur_e - cur_s, spans[-1][1] - spans[0][0]


def _profiled_update(inst, batch):
    """In the learner actor: one update's ms (median of 3, synchronised),
    then one update under torch.profiler: device-busy ms and idle share."""
    samples = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inst.learner.update(batch)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    kernels = _device_events(lambda: inst.learner.update(batch))
    if not kernels:
        return {"update_ms": sorted(samples)[1], "busy_ms": None}
    busy, window = _busy_window(kernels)
    return {"update_ms": sorted(samples)[1], "busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "kernels": len(kernels)}


def _pod_actor(rt, mc, device):
    from ray_tpu_torch.rllib.impala import impala_batch_from_fragments
    from ray_tpu_torch.rllib.podracer import PodracerLearnerActor

    lease = {"num_cpus": 1, "num_gpus": 1} if device == "cuda" else {"num_cpus": 1}
    return PodracerLearnerActor.options(**lease).remote(
        _pod_factory(mc, device), impala_batch_from_fragments, POD_BATCH_FRAGMENTS, POD_K, True)


def _pod_state_equal(a, b):
    """Two checkpoints of the learner actor equal bit for bit."""
    pa, pb = a["params"], b["params"]
    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    return (pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
            and sa.keys() == sb.keys() and all(sa[i].keys() == sb[i].keys() for i in sa)
            and all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
            and {k: v for k, v in a.items() if k not in ("params", "opt_state")}
            == {k: v for k, v in b.items() if k not in ("params", "opt_state")})


def phase_podracer_parity(rt, smi, device):
    """(a): the card learner actor's stats after every step of the
    sequence equal to the in-process CPU learner's, its parameters after
    the last update held to the f64 run by [rllib]'s per-tensor floors,
    and its checkpoint hooks round-tripped onto a fresh card actor."""
    import numpy as np

    from ray_tpu_torch.models import catalog
    from ray_tpu_torch.rllib import core, impala
    from ray_tpu_torch.rllib.podracer import PodracerLearnerActor

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    shapes = {"mlp": core.MLPModuleConfig(4, 2), "cnn": catalog.get_module_config(RL_CNN_OBS, RL_CNN_ACTIONS)}
    T, B = impala.IMPALAConfig.rollout_fragment_length, impala.IMPALAConfig.num_envs_per_runner
    out = {}
    try:
        for key, mc in shapes.items():
            card = _pod_actor(rt, mc, device)
            rt.get(card._apply(_tf32_off), timeout=300)
            threads = torch.get_num_threads()
            try:  # in process: the learner actor's class sets one intra-op thread
                cpu = PodracerLearnerActor._cls(_pod_factory(mc, "cpu"), impala.impala_batch_from_fragments,
                                                POD_BATCH_FRAGMENTS, POD_K, True)
                f64 = PodracerLearnerActor._cls(_pod_factory(mc, "cpu"), impala.impala_batch_from_fragments,
                                                POD_BATCH_FRAGMENTS, POD_K, True)
            finally:
                torch.set_num_threads(threads)
            _rl_f64(f64.learner)
            w0 = {"card": rt.get(card.get_weights.remote(), timeout=60), "cpu": cpu.get_weights(),
                  "f64": f64.get_weights()}
            _require(all(torch.equal(w0["card"][n], w0[k][n].float()) for k in w0 for n in w0["cpu"]),
                     f"[podracer] {key}: the learners start apart")
            rng = np.random.default_rng(RL_SEED)
            card_ms, updates = [], 0
            for step in POD_SEQUENCE:
                if step == "bump":
                    for learner in (cpu, f64):
                        learner.set_weights(learner.get_weights(), True)
                    rt.get(card.set_weights.remote(rt.get(card.get_weights.remote(), timeout=60), True), timeout=60)
                else:
                    frag, m = _pod_fragment(mc, T, B, rng), _pod_meta(*step, T * B)
                    ref = rt.put(frag)
                    t0 = time.perf_counter()
                    got = rt.get(card.ingest.remote(ref, dict(m)), timeout=300)
                    card_ms.append((time.perf_counter() - t0) * 1e3)
                    want = cpu.ingest(frag, dict(m))
                    f64.ingest(frag, dict(m))
                    _require((got["train"] is None) == (want["train"] is None),
                             f"[podracer] {key}: step {step} trained on one device only")
                    updates += got["train"] is not None
                stats = rt.get(card.stats.remote(), timeout=60)
                _require(stats == cpu.stats() == f64.stats(),
                         f"[podracer] {key}: stats after {step}: card {stats}, CPU {cpu.stats()}")
            _require(updates == POD_SEQUENCE_UPDATES and stats["dropped_stale"] == 3
                     and stats["max_trained_lag"] <= POD_K, f"[podracer] {key}: {updates} updates, {stats}")
            w = {"card": rt.get(card.get_weights.remote(), timeout=60), "cpu": cpu.get_weights(),
                 "f64": f64.get_weights()}
            pc, pcpu, pshare, pworst = _rl_held(w["card"], w["cpu"], w["f64"], RL_PARAM_TOL)
            moved = min(_rl_rels(w0["f64"], w["f64"]).values())
            # the checkpoint hooks onto a fresh card actor (the card holds one lease at a time)
            snap = rt.get(card._apply(lambda inst: inst.__rt_checkpoint__()), timeout=60)
            rt.kill(card)
            fresh = _pod_actor(rt, mc, device)
            rt.get(fresh._apply(lambda inst, s: inst.__rt_restore__(s), snap), timeout=300)
            back = rt.get(fresh._apply(lambda inst: inst.__rt_checkpoint__()), timeout=60)
            facts = rt.get(fresh._apply(_learner_facts), timeout=60)
            rt.kill(fresh)
            same = _pod_state_equal(snap, back)
            out[key] = {"param_card_f64": pc, "param_cpu_f64": pcpu, "param_share": pshare,
                        "param_card_cpu": _rl_tensor_rel(w["card"], w["cpu"]), "moved": moved,
                        "ingest_ms": card_ms, "restored_bitwise": same, "stats": stats}
            _log("podracer", f"{key}: {len(card_ms)} fragments of ({T}, {B}) through the card learner actor "
                             f"({updates} updates; ingest round trips {', '.join(f'{x:.1f}' for x in card_ms)} ms); "
                             f"stats equal to the CPU's after every step: {stats}; largest tensor distance from "
                             f"f64: card {pc:.3g}, CPU {pcpu:.3g}, card-CPU {out[key]['param_card_cpu']:.3g}, "
                             f"card/bound {pshare:.3g} at {pworst}; smallest tensor move {moved:.3g}; checkpoint "
                             f"hooks onto a fresh actor on {facts['param_device']}: bit for bit {same}")
            _require(pshare <= 1.0, f"[podracer] {key}: the card's parameters from f64 at {pworst}: "
                                    f"{pshare} of the bound")
            _require(moved > RL_PARAM_TOL, f"[podracer] {key}: a tensor moved only {moved}")
            _require(same and facts["param_device"].startswith(device),
                     f"[podracer] {key}: the checkpoint did not round-trip onto the card")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return out


class _SeededFrames:
    """Stands in for the gymnasium vector env of an env runner (the card's
    machine has no gymnasium, and CartPole has no frames): each reset and
    step returns seeded (num_envs, H, W, C) frames in [0, 1), rewards from
    a unit normal and dones at 5%."""

    def __init__(self, num_envs, seed, obs_shape):
        import numpy as np

        self.rng, self.n, self.shape = np.random.default_rng(seed), num_envs, tuple(obs_shape)

    def reset(self, seed=None):
        return self.rng.random((self.n, *self.shape), dtype="float32"), {}

    def step(self, action):
        import numpy as np

        obs = self.rng.random((self.n, *self.shape), dtype="float32")
        rewards = self.rng.normal(size=self.n).astype(np.float32)
        return obs, rewards, self.rng.random(self.n) < 0.05, np.zeros(self.n, bool), {}


def _seeded_frame_runner(rt):
    """The port's EnvRunnerActor with only its env stepping replaced by
    _SeededFrames: sampling, the CPU module's inference, the fragment put
    and the podracer methods are the runner's own."""
    import numpy as np

    from ray_tpu_torch.rllib import core, env_runner

    class SeededFrameRunner(env_runner.EnvRunnerActor._cls):
        def __init__(self, env_fn, module_config, num_envs, seed, env_to_module_fn=None):
            # EnvRunnerActor.__init__ with _SeededFrames for the gym envs
            torch.set_num_threads(1)
            self._envs = _SeededFrames(num_envs, seed, module_config.obs_shape)
            self._num_envs = num_envs
            self._config = module_config
            self._module = core.module_init(module_config, torch.Generator().manual_seed(seed), "cpu")
            self._gen = torch.Generator().manual_seed(seed + 10_000)
            self._env_to_module = None
            self._obs, _ = self._envs.reset(seed=seed)
            self._prev_done = np.zeros(num_envs, bool)
            self._proc = self._process(self._obs)
            self._ep_return = np.zeros(num_envs, np.float64)
            self._completed = []
            self._policy_version = 0
            self._frag_seq = 0

    return rt.remote(SeededFrameRunner)


def phase_podracer_fleet(rt, smi, device):
    """(b): PodracerRunner with POD_FLEET_RUNNERS CPU runner actors and the
    card learner at the CNN, POD_FLEET_UPDATES updates or more, under the
    fp32 and the bf16 wire."""
    import numpy as np

    from ray_tpu_torch.models import catalog
    from ray_tpu_torch.rllib import env_runner
    from ray_tpu_torch.rllib.impala import impala_batch_from_fragments

    mc = catalog.get_module_config(RL_CNN_OBS, RL_CNN_ACTIONS)
    gym = importlib.util.find_spec("gymnasium") is not None
    rng = np.random.default_rng(RL_SEED + 1)
    sample = [_pod_fragment(mc, POD_FLEET_T, POD_FLEET_ENVS, rng) for _ in range(2)]
    frag_bytes = sum(v.nbytes for v in sample[0].values())
    profile_batch = impala_batch_from_fragments(sample)
    runner_cls, env_runner.EnvRunnerActor = env_runner.EnvRunnerActor, _seeded_frame_runner(rt)
    out = {}
    try:
        t0 = time.perf_counter()
        group = env_runner.EnvRunnerGroup(None, mc, num_runners=POD_FLEET_RUNNERS,
                                          num_envs_per_runner=POD_FLEET_ENVS, seed=RL_SEED)
        try:
            rt.get([r.ping.remote() for r in group.runners], timeout=300)
            _log("podracer", f"{POD_FLEET_RUNNERS} CPU runner actors up in {time.perf_counter() - t0:.3f} s "
                             f"(seeded frames in place of env steps; gymnasium importable: {gym}); a fragment "
                             f"({POD_FLEET_T}, {POD_FLEET_ENVS}) at {RL_CNN_OBS}: {frag_bytes / 1e6:.3f} MB")
            for wire in (None, "bf16"):
                out[wire or "fp32"] = _pod_fleet_run(rt, group, mc, wire, device, frag_bytes, profile_batch, smi)
        finally:
            group.stop()
    finally:
        env_runner.EnvRunnerActor = runner_cls
    return out


def _pod_fleet_run(rt, group, mc, wire, device, frag_bytes, profile_batch, smi):
    from ray_tpu_torch.rllib.impala import impala_batch_from_fragments
    from ray_tpu_torch.rllib.podracer import PodracerConfig, PodracerRunner

    label = wire or "fp32"
    t0 = time.perf_counter()
    pr = PodracerRunner(group, _pod_factory(mc, device), impala_batch_from_fragments, PodracerConfig(
        rollout_fragment_length=POD_FLEET_T, batch_fragments=2, max_policy_lag=POD_FLEET_K, weight_sync_period=1,
        weight_wire_dtype=wire, learner_device=device))
    try:
        start_s = time.perf_counter() - t0
        facts = rt.get(pr.learner._apply(_learner_facts), timeout=60)
        updates = forwarded = sampled_steps = 0
        gen_ms = []
        t0 = time.perf_counter()
        while updates < POD_FLEET_UPDATES:
            res = pr.run(min_updates=1)
            updates += res["updates"]
            forwarded += res["fragments"]
            sampled_steps += res["env_steps_sampled"]
            if "weight_broadcast_ms" in res:
                gen_ms.append(res["weight_broadcast_ms"])
        run_s = time.perf_counter() - t0
        in_flight = len(pr._sample_refs)
        pr.drain_in_flight()
        stats = pr.learner_stats()
        lost = pr._fragments_lost
        fan_ms = [pr.broadcast_weights(wire) for _ in range(POD_FANOUT_REPS)]
        w = pr.get_weights()
        runner_w = [rt.get(r.get_weights.remote(), timeout=60) for r in group.runners]
        equal = all(torch.equal(rw[k], w[k]) for rw in runner_w for k in w) and all(rw.keys() == w.keys()
                                                                                    for rw in runner_w)
        after = rt.get(pr.learner._apply(_learner_facts), timeout=60)
        prof = rt.get(pr.learner._apply(_profiled_update, profile_batch), timeout=300) if device == "cuda" else None
    finally:
        pr.stop()
    settled = (stats["trained_fragments"] + stats["dropped_stale"] + stats["dropped_overflow"]
               + stats["queue_depth"] + lost)
    r = {"updates": updates, "run_s": run_s, "learner_start_s": start_s, "fragments": forwarded,
         "sampled": forwarded + in_flight, "discarded_at_drain": in_flight, "lost": lost, "stats": stats,
         "fragments_per_s": forwarded / run_s, "env_steps_trained_per_s": stats["env_steps_trained"] / run_s,
         "updates_per_s": updates / run_s, "fragment_gb_per_s": forwarded * frag_bytes / run_s / 1e9,
         "generation_ms_median": _spread(gen_ms)[0] if gen_ms else None,
         "fanout_ms_median": _spread(fan_ms)[0], "runners_bitwise": equal, "profile": prof}
    _log("podracer", f"[{label} wire] {smi}: learner actor up in {start_s:.3f} s on {facts['param_device']} "
                     f"(CUDA_VISIBLE_DEVICES={facts['visible']!r}, {facts['device_count']} card(s), no JAX); "
                     f"{updates} updates in {run_s:.3f} s: {r['fragments_per_s']:.2f} fragments/s, "
                     f"{r['env_steps_trained_per_s']:.1f} env steps trained/s, {r['updates_per_s']:.2f} updates/s, "
                     f"{r['fragment_gb_per_s']:.4f} GB/s of fragments into the learner (by shm ref)")
    _log("podracer", f"[{label} wire] fragments: sampled {r['sampled']} = trained {stats['trained_fragments']} + "
                     f"dropped stale {stats['dropped_stale']} + dropped overflow {stats['dropped_overflow']} + "
                     f"queued {stats['queue_depth']} + lost {lost} + sampled but not sent by the drain "
                     f"{in_flight}; staleness {stats['staleness_hist']}, largest trained lag "
                     f"{stats['max_trained_lag']} (K = {POD_FLEET_K})")
    _log("podracer", f"[{label} wire] fan-out: a generation while sampling, median {r['generation_ms_median']} ms "
                     f"over {len(gen_ms)} run() calls; to an idle fleet {', '.join(f'{x:.2f}' for x in fan_ms)} "
                     f"ms (median {r['fanout_ms_median']:.3f}); after the drain and a last fan-out every "
                     f"runner's weights equal the learner's bit for bit: {equal}; flash launches in the learner "
                     f"{after['flash_launches']}")
    if prof is not None:
        idle = None if prof["busy_ms"] is None else 1 - prof["busy_ms"] / prof["update_ms"]
        _log("podracer", f"[{label} wire] one update of 2 fragments on the card: {prof['update_ms']:.3f} ms; "
                         f"profiled: device busy {prof['busy_ms']} ms in {prof.get('kernels')} kernels, idle share "
                         f"{idle} of the unprofiled update")
        r["idle_share"] = idle
    _require(updates >= POD_FLEET_UPDATES, f"[podracer] {label}: {updates} updates")
    _require(stats["max_trained_lag"] <= POD_FLEET_K, f"[podracer] {label}: trained lag {stats['max_trained_lag']}")
    _require(forwarded == settled, f"[podracer] {label}: {forwarded} fragments sent, {settled} accounted for")
    _require(equal, f"[podracer] {label}: a runner's weights differ from the learner's")
    for f in (facts, after):
        _check_worker(f, f"[podracer] {label} learner")
        _require(f["param_device"].startswith(device), f"[podracer] {label}: learner on {f['param_device']}")
        if device == "cuda":
            _require(f["visible"] == "0" and f["device_count"] == 1,
                     f"[podracer] the learner sees CUDA_VISIBLE_DEVICES={f['visible']!r}, {f['device_count']} card(s)")
    _require(not any(after["flash_launches"].values()), f"[podracer] flash launches in the learner: "
                                                         f"{after['flash_launches']}")
    return r


def phase_podracer(fa, smi, device=None):
    """[podracer]: (a) parity of the card learner actor, (b) the fleet; the
    driver's flash counts read 0 over both."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api

    device = device or DEVICE
    t0 = time.perf_counter()
    _flash_counts_zero(fa)
    rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    try:
        parity = phase_podracer_parity(rt, smi, device)
        fleet = phase_podracer_fleet(rt, smi, device)
    finally:
        _shutdown_checked(rt, rt_api, "podracer")
    counts = _counts(fa)
    _require(not any(counts.values()), f"[podracer] launched flash kernels: {counts}")
    _log("done", f"[podracer] {time.perf_counter() - t0:.1f} s; flash kernel launches on it: {counts}")
    return {"parity": parity, "fleet": fleet, "launches": counts}


def phase_grad_flash_vs_dense(gpt2, model, tokens):
    """One step's gradients with flash and with dense attention from the
    same weights, relative to each gradient's norm."""
    def grads(m):
        m.zero_grad(set_to_none=True)
        gpt2.loss_fn(m, {"tokens": tokens}).backward()
        return {n: p.grad.clone() for n, p in m.named_parameters()}

    dense = gpt2.GPT2(dataclasses.replace(model.config, attention_impl="dense"), model.wte.device)
    dense.load_state_dict(model.state_dict())
    g_flash, g_dense = grads(model), grads(dense)
    model.zero_grad(set_to_none=True)
    del dense
    rel = {n: ((g_flash[n] - g_dense[n]).norm() / g_dense[n].norm()).item() for n in g_dense}
    worst = sorted(rel, key=rel.get)[-4:]
    _log("train", f"flash vs dense gradients, |g_flash - g_dense| / |g_dense|: worst "
                  + ", ".join(f"{n} {rel[n]:.4g}" for n in reversed(worst))
                  + f"; median {sorted(rel.values())[len(rel) // 2]:.4g} over {len(rel)} parameters")
    _require(max(rel.values()) < FLASH_VS_DENSE_GRAD, "flash and dense gradients disagree")


def phase_time_head_backward(model, x_rows):
    """The lm-head's backward at the training shape, (B·S, E) features and
    the (V, E) table: the port's formula (f32 cotangent split into two bf16
    terms, four bf16 products) beside the two it was chosen between, as
    yardsticks: the exact f32 products, and one bf16 product each from the
    cotangent rounded to bf16."""
    from ray_tpu_torch.models.common import matmul_f32

    dev = model.wte.device
    a = torch.randn((x_rows, model.config.embed_dim), device=dev).bfloat16().requires_grad_()
    b = model.wte.detach().bfloat16().t().requires_grad_()
    g = torch.randn((x_rows, b.shape[1]), device=dev) * 1e-5
    out = matmul_f32(a, b)

    def port():
        torch.autograd.grad(out, (a, b), g, retain_graph=True)

    def exact_f32():
        (g.mm(b.detach().float().t()).bfloat16(), a.detach().float().t().mm(g).bfloat16())

    def rounded_bf16():
        gb = g.bfloat16()
        (gb.mm(b.detach().t()), a.detach().t().mm(gb))

    times = {name: _time_ms(fn, iters=5, warmup=1)
             for name, fn in (("port (hi+lo bf16)", port), ("exact f32", exact_f32),
                              ("cotangent rounded to bf16", rounded_bf16))}
    _log("head", f"lm-head backward at ({x_rows}, {model.config.embed_dim}) x "
                 f"({model.config.embed_dim}, {b.shape[1]}): "
                 + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items()))
    return times


def _parity_errors(cached, full):
    """|d| / |full| (Frobenius) and max |d| of two logit blocks."""
    d = (cached - full).float()
    return (d.norm() / full.float().norm()).item(), d.abs().max().item()


def _teacher_forced_decode(llama, model, cache, prompts, first, steps, feed=None):
    """Decode ``steps`` tokens for the rows in ``prompts`` with
    decode_step_rowwise, the other rows at position 0.  Each row is fed its
    greedy token, or ``feed[row][i]`` when given.  Returns per row the
    stacked logits (steps, V) and the tokens fed."""
    B = cache["k"].shape[1]
    logits = {row: [] for row in prompts}
    fed = {row: [] for row in prompts}
    last = {row: int(first[row].argmax()) for row in prompts}
    for i in range(steps):
        tokens, pos = [0] * B, [0] * B
        for row, n in prompts.items():
            tokens[row] = feed[row][i] if feed else last[row]
            pos[row] = n + i
            fed[row].append(tokens[row])
        out, _ = llama.decode_step_rowwise(model, torch.tensor(tokens, device=cache["k"].device), cache, pos)
        for row in prompts:
            logits[row].append(out[row])
            last[row] = int(out[row].argmax())
    return {row: torch.stack(v) for row, v in logits.items()}, fed


def _parity(cached, full, f32, tol):
    """(|d|/|ref| and max |d| against the full forward, and the ratio of
    the cached path's and the full forward's |d|/|ref| against f32), and
    whether all three are within ``tol``."""
    rel, mx = _parity_errors(cached, full)
    ratio = _parity_errors(cached, f32)[0] / _parity_errors(full, f32)[0]
    ok = rel < tol["rel"] and mx < tol["max_abs"] and ratio <= tol["f32_ratio"]
    return dict(rel=rel, max_abs=mx, f32_ratio=ratio), ok


def _first_layers(llama, model, n):
    """A model of ``model``'s first ``n`` layers, sharing its tensors."""
    cfg = dataclasses.replace(model.config, num_layers=n)
    cut = llama.Llama(cfg, "meta")
    cut.tok_embed, cut.final_norm = model.tok_embed, model.final_norm
    cut.blocks = torch.nn.ModuleList(model.blocks[:n])
    if not cfg.tie_embeddings:
        cut.lm_head = model.lm_head
    return cut


def phase_llama_parity(llama, model, tol):
    """Prefill two prompts into rows of the serving cache, decode
    PARITY_STEPS steps, and hold every logit vector against the full
    forward over the same tokens (and both against the full forward in
    f32) within ``tol``; then the same with the cache rounded through
    float8 after the prefill, which must fail."""
    cfg, dev = model.config, model.tok_embed.device
    depth = f"{cfg.num_layers} layers"
    T = llama.rolling_cache_len(cfg, SERVE_ENGINE["max_prompt_len"])
    cache = llama.init_cache(cfg, SERVE_ENGINE["max_slots"], T, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    prompts = {row: torch.randint(0, cfg.vocab_size, (1, n), generator=g, device=dev)
               for row, n in PARITY_PROMPTS.items()}
    lens = {row: t.shape[1] for row, t in prompts.items()}

    def prefill():
        return {row: llama.prefill_into_slot(model, t, cache, row)[0][0] for row, t in prompts.items()}

    first = prefill()
    steps, fed = _teacher_forced_decode(llama, model, cache, lens, first, PARITY_STEPS)
    results, refs = {}, {}
    with torch.inference_mode():
        m32 = llama.Llama(dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32), dev)
        for p32, p in zip(m32.parameters(), model.parameters()):
            p32.copy_(p)
        for row, t in prompts.items():
            n = lens[row]
            seq = torch.cat([t[0], torch.tensor(fed[row], device=dev)])[None]
            full, f32 = model(seq)[0, n - 1:], m32(seq)[0, n - 1:]
            floor = _parity_errors(model(seq[:, :-1])[0, n - 1:], full[:-1])
            cached = torch.cat([first[row][None], steps[row]])
            _require(cached.shape == full.shape == (PARITY_STEPS + 1, cfg.vocab_size),
                     f"row {row}: cached {tuple(cached.shape)}, full {tuple(full.shape)}")
            _require(bool(torch.isfinite(cached).all()), f"row {row}: non-finite cached logits")
            res, ok = _parity(cached, full, f32, tol)
            res["greedy_agreement"] = (cached.argmax(-1) == full.argmax(-1)).float().mean().item()
            res["floor_rel"], res["floor_max_abs"] = floor
            _log("llama-parity", f"{depth}, row {row} (prompt {n}, positions {n - 1}..{n + PARITY_STEPS - 1}): "
                                 f"cached vs full |d|/|ref| {res['rel']:.4g} (tol {tol['rel']}), max|d| "
                                 f"{res['max_abs']:.4g} (tol {tol['max_abs']}); vs f32, cached/full "
                                 f"{res['f32_ratio']:.4f} (tol {tol['f32_ratio']}); logit std "
                                 f"{full.std().item():.4g}; greedy agreement {res['greedy_agreement']:.4f} "
                                 f"(not gated); floor, full vs full one token shorter: |d|/|ref| "
                                 f"{floor[0]:.4g}, max|d| {floor[1]:.4g}")
            _require(ok, f"{depth}, row {row}: cached path disagrees with the full forward: {res}")
            results[row], refs[row] = res, (full, f32)
        del m32
    # Negative control: the same run with the prompts' cache rounded to
    # float8 e4m3 and back must fail, or the tolerances are too loose to see
    # a cached path computed below bf16.
    first = prefill()
    for t in cache.values():
        t.copy_(t.to(torch.float8_e4m3fn).to(t.dtype))
    steps, _ = _teacher_forced_decode(llama, model, cache, lens, first, PARITY_STEPS, feed=fed)
    for row in prompts:
        res, ok = _parity(torch.cat([first[row][None], steps[row]]), *refs[row], tol)
        _log("llama-parity", f"{depth}, control, cache through float8 e4m3: row {row}: |d|/|ref| "
                             f"{res['rel']:.4g}, max|d| {res['max_abs']:.4g}, vs f32 cached/full "
                             f"{res['f32_ratio']:.4f}")
        _require(not ok, f"{depth}, row {row}: a float8 cache passes the parity tolerances")
        results[row]["float8_control"] = res
    return results


async def _collect(engine, prompt, max_new):
    return [tok async for tok in engine.stream(prompt, max_new)]


def phase_llama_rolling(llama, LLMEngine, device):
    """The rolling cache wrapping, bit for bit: a tiny windowed model in f32
    on the card, 30 tokens through a 9-slot cache against full recompute."""
    import asyncio

    cfg = llama.LlamaConfig.tiny(sliding_window=6)
    model = llama.init(cfg, torch.Generator(device=device).manual_seed(3), device)
    engine = LLMEngine(model, max_slots=2, max_len=64, max_prompt_len=4, device=device)
    _require(engine.cache_len == 9 and engine.cache["k"].shape[2] == 9, f"cache_len {engine.cache_len}")
    prompt = [3, 7, 11, 2]
    got = asyncio.run(_collect(engine, prompt, 30))
    ref = llama.generate(model, [prompt], max_new_tokens=30)[0, len(prompt):].tolist()
    _log("llama-rolling", f"window 6, cache_len 9, 30 tokens (positions 4..33 wrap the cache 3 times): "
                          f"engine {got[:8]}... generate {ref[:8]}...")
    _require(got == ref, f"rolling-cache engine tokens {got} differ from generate's {ref}")
    _log("llama-rolling", "engine tokens equal generate()'s, all 30")


def _weight_bytes(llama, cfg, rows):
    """Bytes of the weights a pass over ``rows`` tokens reads: every one,
    but of an untied embedding table only the rows it gathers."""
    elt = torch.finfo(cfg.param_dtype).bits // 8
    n = llama.num_params(cfg)
    if not cfg.tie_embeddings:
        n -= (cfg.vocab_size - rows) * cfg.embed_dim
    return n * elt


def _kv_bytes(cfg, rows, slots):
    """Bytes of k and v over ``slots`` cache slots of ``rows`` rows."""
    elt = torch.finfo(cfg.dtype).bits // 8
    return 2 * cfg.num_layers * rows * slots * cfg.num_kv_heads * cfg.head_dim * elt


def _decode_bound(llama, cfg, T, B):
    """Least time for one decode step over B rows: the weights read once
    (B rows of the embedding table), the whole cache read (the step attends
    over all T slots of each row, as the reference), the new k and v and
    the f32 logits written, against 2 operations per weight per row and
    the attention products."""
    n = llama.num_params(cfg)
    nbytes = _weight_bytes(llama, cfg, B) + _kv_bytes(cfg, B, T + 1) + B * cfg.vocab_size * 4
    flops = 2 * (n - cfg.vocab_size * cfg.embed_dim) * B + 4 * cfg.num_layers * B * cfg.embed_dim * T
    return (*_bound(nbytes, flops), nbytes, flops)


def _prefill_bound(llama, cfg, S):
    """Least time for an S-token prefill into one row: the weights read
    once (S rows of the embedding table), the S tokens' k and v and one f32
    logit vector written, against the causal products (each query over the
    keys up to itself), the head for the last token only."""
    n = llama.num_params(cfg)
    nbytes = _weight_bytes(llama, cfg, S) + _kv_bytes(cfg, 1, S) + cfg.vocab_size * 4
    body = n - 2 * cfg.vocab_size * cfg.embed_dim
    flops = 2 * body * S + 2 * cfg.vocab_size * cfg.embed_dim + 4 * cfg.num_layers * cfg.embed_dim * S * (S + 1) // 2
    return (*_bound(nbytes, flops), nbytes, flops)


def _serve_traffic(vocab_size):
    """[serve]'s requests, also replayed by [deploy]: the generator (which
    [serve] goes on drawing from), prompt lengths, new-token counts, prompts
    and each request's delay from the start."""
    import numpy as np

    rng = np.random.default_rng(5)
    lens = np.clip(rng.lognormal(np.log(200), 0.6, SERVE_REQUESTS), 64, 512).astype(int)
    new = rng.integers(32, 129, SERVE_REQUESTS)
    prompts = [rng.integers(0, vocab_size, n).tolist() for n in lens]
    delays = [0.0 if i < SERVE_REQUESTS // 2 else SERVE_WAVE_GAP_S for i in range(SERVE_REQUESTS)]
    return rng, lens, new, prompts, delays


def _stream_stats(records, wall, vocab_size):
    """What users of a streaming request see, from ``(index, submit time,
    token times, tokens, max_new)`` records; every request must have its
    full count of tokens in the vocabulary.  Returns the figures and the
    tokens by request index."""
    for _, _, times, toks, max_new in records:
        _require(len(toks) == max_new and all(0 <= t < vocab_size for t in toks),
                 f"a request got {len(toks)} tokens of {max_new}")
    ttft = [(times[0] - submit) * 1e3 for _, submit, times, _, _ in records]
    gaps = [(b - a) * 1e3 for _, _, times, _, _ in records for a, b in zip(times, times[1:])]
    n_out = sum(len(toks) for _, _, _, toks, _ in records)
    n_decode = n_out - len(records)
    by_req = sorted(records)
    st = dict(wall_s=wall, output_tokens=n_out, decode_tokens=n_decode,
              ttft_ms_by_request=[round((times[0] - submit) * 1e3, 1) for _, submit, times, _, _ in by_req],
              end_ms_by_request=[round((times[-1] - submit) * 1e3, 1) for _, submit, times, _, _ in by_req],
              output_tokens_per_s=n_out / wall, decode_tokens_per_s=n_decode / wall,
              ttft_ms_median=_pct(ttft, 0.5), ttft_ms_p90=_pct(ttft, 0.9), ttft_ms_max=max(ttft),
              gap_ms_median=_pct(gaps, 0.5), gap_ms_p90=_pct(gaps, 0.9), gap_ms_max=max(gaps))
    return st, {i: toks for i, _, _, toks, _ in records}


def _stream_line(st):
    return (f"time to first token ms: median {st['ttft_ms_median']:.1f}, p90 {st['ttft_ms_p90']:.1f}, "
            f"max {st['ttft_ms_max']:.1f}; gap between output tokens ms: median "
            f"{st['gap_ms_median']:.2f}, p90 {st['gap_ms_p90']:.2f}, max {st['gap_ms_max']:.2f}")


def phase_serve(llama, LLMEngine, model, smi):
    """SERVE_REQUESTS streaming requests in two waves through the engine at
    full width, timed per token on the host; then one decode step and one
    512-token prefill are profiled."""
    import asyncio

    import numpy as np

    cfg, dev = model.config, model.tok_embed.device
    engine = LLMEngine(model, device=dev, **SERVE_ENGINE)
    rng, lens, new, prompts, delays = _serve_traffic(cfg.vocab_size)
    _log("serve", f"{SERVE_REQUESTS} requests, waves of {SERVE_REQUESTS // 2} at 0 and {SERVE_WAVE_GAP_S} s; "
                  f"prompt tokens (log-normal, median 200, sigma 0.6, clipped to [64, 512]): min {lens.min()} "
                  f"median {int(np.median(lens))} mean {lens.mean():.1f} max {lens.max()}; new tokens "
                  f"(uniform [32, 128]): min {new.min()} median {int(np.median(new))} mean {new.mean():.1f} "
                  f"max {new.max()}; engine {SERVE_ENGINE}, cache_len {engine.cache_len}")
    host = {"prefill": [], "decode": []}

    def timed(fn, store):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)  # returns host ints: the device has finished
            store.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    # Instance attributes over the methods, deleted after the run so that
    # the direct calls below are not counted as the engine's.
    engine._prefill = timed(engine._prefill, host["prefill"])
    engine._decode = timed(engine._decode, host["decode"])

    async def one(i, prompt, max_new, delay, records):
        await asyncio.sleep(delay)
        submit, times, toks = time.perf_counter(), [], []
        async for tok in engine.stream(prompt, max_new):
            times.append(time.perf_counter())
            toks.append(tok)
        records.append((i, submit, times, toks, max_new))

    async def run():
        records = []
        t0 = time.perf_counter()
        await asyncio.gather(*(one(i, p, int(n), d, records)
                               for i, (p, n, d) in enumerate(zip(prompts, new, delays))))
        return time.perf_counter() - t0, records

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, records = asyncio.run(run())
    peak = torch.cuda.max_memory_allocated() / 2**30
    del engine._prefill, engine._decode
    st, req_tokens = _stream_stats(records, wall, cfg.vocab_size)
    n_out, n_decode = st["output_tokens"], st["decode_tokens"]
    dec = host["decode"]
    dec_ms = _pct(dec, 0.5)
    _require(engine.admitted_total == SERVE_REQUESTS and engine.shed_total == 0,
             f"admitted {engine.admitted_total}, shed {engine.shed_total}")
    _log("serve", f"{smi}: {n_out} tokens in {wall:.3f} s: {n_out / wall:.1f} output tokens/s, "
                  f"{n_decode / wall:.1f} decode tokens/s; {len(dec)} decode steps, "
                  f"{n_decode / len(dec):.2f} rows active a step on average")
    _log("serve", _stream_line(st))
    _log("serve", f"host ms per engine call: decode step median {dec_ms:.3f} (p10 "
                  f"{_pct(dec, 0.1):.3f}, p90 {_pct(dec, 0.9):.3f}); prefill median "
                  f"{_pct(host['prefill'], 0.5):.3f}, max {max(host['prefill']):.3f} over "
                  f"{len(host['prefill'])} prompts; peak memory {peak:.2f} GiB")
    # One decode step with every row active at serving-like positions, and
    # one 512-token prefill: host time (synchronised) and device time.
    tokens = rng.integers(0, cfg.vocab_size, SERVE_ENGINE["max_slots"]).tolist()
    pos = [int(x) for x in rng.integers(64, 640, SERVE_ENGINE["max_slots"])]
    step_ms = _spread([_time_host(lambda: engine._decode(tokens, pos)) for _ in range(10)])[0]
    step_bound = _decode_bound(llama, cfg, engine.cache_len, SERVE_ENGINE["max_slots"])
    busy = phase_profile(lambda: engine._decode(tokens, pos), "one decode step (8 rows)", step_ms, top=10,
                         expect={"flash_": 0})
    # The attention's share: one layer's _cached_attention at this step's
    # shapes (grouped products, mask, softmax), by device time, times L.
    q = torch.randn((SERVE_ENGINE["max_slots"], 1, cfg.num_heads, cfg.head_dim), device=dev).to(cfg.dtype)
    t_idx = torch.arange(engine.cache_len, device=dev)
    mask = (t_idx[None, :] <= torch.tensor(pos, device=dev)[:, None])[:, None]
    attn_ms = cfg.num_layers * _device_ms(
        lambda: llama._cached_attention(q, engine.cache["k"][0], engine.cache["v"][0], mask, cfg), 10)
    # Yardstick, used nowhere in the port: the same over a cache one slot
    # longer, 4608 slots, a multiple of 8, so that every row of the scores
    # and probabilities starts 16-byte aligned for cuBLAS.
    B, T = SERVE_ENGINE["max_slots"], engine.cache_len
    kv = [torch.randn((B, T + 1, cfg.num_kv_heads, cfg.head_dim), device=dev).to(cfg.dtype) for _ in range(2)]
    mask8 = torch.cat([mask, torch.zeros_like(mask[..., :1])], dim=-1)
    aligned_ms = cfg.num_layers * _device_ms(lambda: llama._cached_attention(q, *kv, mask8, cfg), 10)
    del kv
    _log("serve", f"decode step (8 rows): attention (_cached_attention x {cfg.num_layers} layers) "
                  f"{attn_ms:.3f} ms of device time at {T} slots; {aligned_ms:.3f} ms at {T + 1} slots "
                  f"(yardstick)")
    _log("serve", f"decode step (8 rows): host {step_ms:.3f} ms (median of 10), device busy "
                  f"{_ms(busy)}, bound {step_bound[0]:.3f} ms ({step_bound[1]}: "
                  f"{step_bound[2] / 1e9:.2f} GB, {step_bound[3] / 1e9:.1f} GFLOP); "
                  f"host/bound {step_ms / step_bound[0]:.2f}x")
    prompt = torch.tensor([rng.integers(0, cfg.vocab_size, 512).tolist()], device=dev)

    def prefill():
        llama.prefill_into_slot(model, prompt, engine.cache, 0)[0].argmax().item()

    pre_ms = _spread([_time_host(prefill) for _ in range(5)])[0]
    pre_bound = _prefill_bound(llama, cfg, 512)
    pre_busy = phase_profile(prefill, "one 512-token prefill", pre_ms, top=8, expect={"flash_": 0})
    _log("serve", f"prefill of 512 tokens: host {pre_ms:.3f} ms (median of 5), device busy {_ms(pre_busy)}, "
                  f"bound {pre_bound[0]:.3f} ms ({pre_bound[1]}: {pre_bound[2] / 1e9:.2f} GB, "
                  f"{pre_bound[3] / 1e12:.2f} TFLOP)")
    return dict(st, decode_step_host_ms=step_ms, decode_step_busy_ms=busy,
                decode_step_bound_ms=step_bound[0], decode_step_attention_ms=attn_ms,
                decode_step_attention_4608_slots_ms=aligned_ms, engine_decode_step_ms_median=dec_ms,
                prefill_512_host_ms=pre_ms, prefill_512_busy_ms=pre_busy,
                prefill_512_bound_ms=pre_bound[0], peak_gib=peak), req_tokens


# The runtime phase: GPT-2-124M through the port's own runtime.
RUNTIME_CPUS = 4
RUNTIME_REPS = 5
NOOP_ROUND_TRIPS = 50
# C2: the tiny flash config at the head dim the kernels take (D = 64), on
# the card against its CPU result (the kernels' plain versions): both bf16,
# held to the parity tests' bf16 logits tolerance (tests/test_torch_gpt2.py
# BF16_TOL, which holds the CPU to JAX at the same widths).
TINY_FLASH_WIDTHS = dict(embed_dim=256, num_heads=4)
TINY_FLASH_TOL = dict(atol=2e-2, rtol=2e-2)


def _sync():
    # a no-op only in a CPU rehearsal of the phase (no CUDA device)
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _fwd_ms(model, x, reps):
    """Median host ms of ``reps`` synchronised forwards after one warm-up."""
    samples = []
    with torch.inference_mode():
        model(x)
        for _ in range(reps):
            _sync()
            t0 = time.perf_counter()
            model(x)
            _sync()
            samples.append((time.perf_counter() - t0) * 1e3)
    return sorted(samples)[len(samples) // 2]


def _worker_facts():
    """This process's argv, the modules of JAX or the JAX package it has
    loaded (there must be none), and the cards it was given."""
    import os

    with open("/proc/self/cmdline", "rb") as f:
        argv = [a.decode() for a in f.read().split(b"\0") if a]
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib"))
    return {"argv": argv, "foreign": foreign, "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _build_gpt2(state, cfg, device):
    from ray_tpu_torch.models import gpt2

    model = gpt2.GPT2(cfg, device)
    model.load_state_dict(state)
    return gpt2, model


def _remote_forward(refs, cfg, tokens, t_submit, reps, device):
    """In a GPU-leased worker: get the state dict from the store, build
    GPT-2-124M on the leased card and run the (8, 1024) flash forward and
    loss once with the forward kernel's count reset just before and read
    just after; then time the forward."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    t_entry = time.time()
    t0 = time.perf_counter()
    if device == "cuda":  # the library the driver built, from ray_tpu_torch/_build/
        _build.load("flash_attention_fwd")
    t_load = time.perf_counter()
    state = ray_tpu_torch.get(refs[0])
    t_get = time.perf_counter()
    gpt2, model = _build_gpt2(state, cfg, device)
    x = tokens.to(device)
    _sync()
    t_built = time.perf_counter()
    fa.flash_attention_fwd.launches = 0
    with torch.inference_mode():
        logits = model(x[:, :-1])
        loss = float(gpt2.loss_fn(model, {"tokens": x}))
    _sync()
    launches = fa.flash_attention_fwd.launches
    t_fwd = time.perf_counter()
    return {
        **_worker_facts(),
        "loss": loss, "last_logits": logits[:, -1].cpu(), "launches": launches,
        "device_count": torch.cuda.device_count(),
        "device_name": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
        "s": {"lease_to_entry": t_entry - t_submit, "kernel_load": t_load - t0,
              "get": t_get - t_load, "build": t_built - t_get, "first_forward": t_fwd - t_built},
        "forward_ms": _fwd_ms(model, x[:, :-1], reps),
    }


def _no_lease_facts():
    return {**_worker_facts(), "cuda_available": torch.cuda.is_available()}


class _GPT2Actor:
    """Holds GPT-2-124M on its leased card and answers forward calls."""

    def __init__(self, refs, cfg, device):
        import ray_tpu_torch

        self.device = device
        self.gpt2, self.model = _build_gpt2(ray_tpu_torch.get(refs[0]), cfg, device)

    def loss(self, tokens):
        with torch.inference_mode():
            return float(self.gpt2.loss_fn(self.model, {"tokens": tokens.to(self.device)}))


def _descendants(pid):
    """Live processes below ``pid``, from /proc (zombies excluded)."""
    parent = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        if fields[0] != "Z":
            parent[int(d)] = int(fields[1])
    out, frontier = [], [pid]
    while frontier:
        p = frontier.pop()
        kids = [c for c, pp in parent.items() if pp == p]
        out += kids
        frontier += kids
    return out


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return [a.decode() for a in f.read().split(b"\0") if a]
    except OSError:
        return []


def _check_worker(facts, what):
    _require("ray_tpu_torch.core.worker_main" in facts["argv"],
             f"{what}: worker argv {facts['argv']} does not name ray_tpu_torch")
    _require(not facts["foreign"], f"{what}: worker loaded {facts['foreign']}")


def phase_runtime(fa, gpt2, cfg, tokens, smi, device="cuda"):
    """[runtime]: GPT-2-124M's weights through the port's object store into a
    GPU-leased worker, which runs the flash forward on its card; card
    exclusivity, no card without a lease, the process boundary and a clean
    shutdown.  Then C2: the tiny flash config at D = 64 runs through the
    forward kernel on the card, and at D = 16 raises."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api

    t0 = time.perf_counter()
    rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    start_s = time.perf_counter() - t0
    try:
        out = _runtime_checks(rt, rt_api, fa, gpt2, cfg, tokens, smi, device)
    finally:
        _shutdown_checked(rt, rt_api, "runtime")
    _log("runtime", f"shutdown(): no process of the driver remains; cluster start {start_s:.3f} s")
    out["start_s"] = start_s
    out["tiny_flash"] = phase_tiny_flash(fa, gpt2, device)
    return out


def _runtime_checks(rt, rt_api, fa, gpt2, cfg, tokens, smi, device):
    res = rt.cluster_resources()
    _require(res.get("GPU") == torch.cuda.device_count(),
             f"cluster_resources() GPU {res.get('GPU')} != torch.cuda.device_count() "
             f"{torch.cuda.device_count()}")
    group = rt_api._node_group
    for proc, module in ((group.gcs_proc, "ray_tpu_torch.core.gcs"),
                         (group.raylet_proc, "ray_tpu_torch.core.raylet")):
        _require(module in _cmdline(proc.pid), f"{module} not in {_cmdline(proc.pid)}")
    _log("runtime", f"{smi}: init(num_cpus={RUNTIME_CPUS}) -> {res}; GCS and raylet run "
                    f"ray_tpu_torch.core.gcs and .raylet")

    # The weights through the store, as CPU copies (f32, as the model keeps them).
    g = torch.Generator(device=device).manual_seed(0)
    model = gpt2.init(cfg, g, device)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    nbytes = sum(v.numel() * v.element_size() for v in state.values())
    t0 = time.perf_counter()
    ref = rt.put(state)
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = rt.get(ref)
    get_s = time.perf_counter() - t0
    _require(all(torch.equal(back[k], v) for k, v in state.items()), "get() of the state dict differs")
    del back
    _log("runtime", f"state dict {nbytes / 1e9:.3f} GB: put {put_s:.3f} s ({nbytes / put_s / 1e9:.2f} GB/s), "
                    f"get {get_s:.3f} s ({nbytes / get_s / 1e9:.2f} GB/s) in the driver")

    # The driver's own forward of the same weights and tokens on the same card.
    x = tokens.to(device)
    with torch.inference_mode():
        want_logits = model(x[:, :-1])[:, -1].float().cpu()
        want_loss = float(gpt2.loss_fn(model, {"tokens": x}))
    driver_ms = _fwd_ms(model, x[:, :-1], RUNTIME_REPS)

    forward = rt.remote(num_gpus=1)(_remote_forward)
    t_submit = time.time()
    t0 = time.perf_counter()
    got = rt.get(forward.remote([ref], cfg, tokens.cpu(), t_submit, RUNTIME_REPS, device), timeout=600)
    first_task_s = time.perf_counter() - t0
    _check_worker(got, "GPU task")
    _require(got["visible"] == "0" and got["device_count"] == 1,
             f"the GPU task sees CUDA_VISIBLE_DEVICES={got['visible']!r}, {got['device_count']} card(s)")
    per_pass = 2 * cfg.num_layers  # the forward and loss_fn's forward
    _require(got["launches"] == per_pass,
             f"the GPU task launched the forward kernel {got['launches']} times, expected {per_pass}")
    d_logits = (got["last_logits"] - want_logits).abs().max().item()
    d_loss = abs(got["loss"] - want_loss)
    bitwise = torch.equal(got["last_logits"], want_logits) and got["loss"] == want_loss
    _log("runtime", f"GPU task on {got['device_name']} (CUDA_VISIBLE_DEVICES={got['visible']!r}, pid "
                    f"{got['pid']}): loss {got['loss']:.6f} vs driver {want_loss:.6f}, last-position "
                    f"logits max |d| {d_logits:.3g}, bit-equal {bitwise}; flash forward launches "
                    f"{got['launches']}")
    _require(d_logits <= TOL[torch.bfloat16]["o"]["atol"] and d_loss <= FLASH_VS_DENSE_LOSS,
             f"the worker's forward differs from the driver's: logits {d_logits}, loss {d_loss}")
    s = got["s"]
    _log("runtime", f"first GPU task {first_task_s:.3f} s end to end: lease, worker start, torch import "
                    f"and CUDA init {s['lease_to_entry']:.3f} s, kernel load {s['kernel_load']:.3f} s, "
                    f"get of the state dict {s['get']:.3f} s ({nbytes / s['get'] / 1e9:.2f} GB/s), model "
                    f"build {s['build']:.3f} s, first forward and loss {s['first_forward']:.3f} s")
    _log("runtime", f"{tuple(x[:, :-1].shape)} forward, median of {RUNTIME_REPS}: {got['forward_ms']:.3f} ms in the "
                    f"worker, {driver_ms:.3f} ms in the driver")

    # No card without a lease.
    facts = rt.get(rt.remote(num_gpus=0)(_no_lease_facts).remote(), timeout=300)
    _check_worker(facts, "CPU task")
    _require(facts["visible"] == "" and not facts["cuda_available"],
             f"a task without GPUs sees CUDA_VISIBLE_DEVICES={facts['visible']!r}, "
             f"cuda available {facts['cuda_available']}")

    # The card is exclusive: a second one-GPU lease waits while the actor lives.
    actor = rt.remote(num_gpus=1)(_GPT2Actor).remote([ref], cfg, device)
    losses = [rt.get(actor.loss.remote(tokens.cpu()), timeout=300) for _ in range(3)]
    _require(all(abs(v - want_loss) <= FLASH_VS_DENSE_LOSS for v in losses), f"actor losses {losses}")
    waiting = rt.remote(num_gpus=1)(_worker_facts).remote()
    ready, _ = rt.wait([waiting], timeout=2.0)
    _require(not ready, "a second one-GPU task ran while the GPU actor held the card")
    rt.kill(actor)
    after = rt.get(waiting, timeout=300)
    _require(after["visible"] == "0", f"the task after the actor sees {after['visible']!r}")
    _log("runtime", f"GPU actor: 3 losses {losses}; a second one-GPU task waited 2 s unready while "
                    f"it lived and ran on CUDA_VISIBLE_DEVICES={after['visible']!r} after kill(); a "
                    f"task without GPUs sees CUDA_VISIBLE_DEVICES='' and no CUDA device")

    noop = rt.remote(lambda: None)
    rt.get(noop.remote())
    trips = []
    for _ in range(NOOP_ROUND_TRIPS):
        t0 = time.perf_counter()
        rt.get(noop.remote())
        trips.append((time.perf_counter() - t0) * 1e3)
    noop_ms = sorted(trips)[len(trips) // 2]
    _log("runtime", f"no-op task round trip: median {noop_ms:.3f} ms of {NOOP_ROUND_TRIPS}")
    return {"put_gb_s": nbytes / put_s / 1e9, "get_gb_s": nbytes / get_s / 1e9,
            "worker_get_gb_s": nbytes / s["get"] / 1e9, "first_task_s": first_task_s,
            "first_task_breakdown_s": s, "noop_ms": noop_ms, "worker_forward_ms": got["forward_ms"],
            "driver_forward_ms": driver_ms, "launches": got["launches"], "logits_max_abs": d_logits,
            "bitwise": bitwise}


def phase_tiny_flash(fa, gpt2, device):
    """C2: the CPU parity tests certify the flash branch at the tiny config
    widened to D = 64 (embed_dim=256, num_heads=4).  On the card that config
    runs through the forward kernel, one launch a layer, and matches its CPU
    result (the kernels' plain versions).  The tiny config itself (D = 16)
    raises on the card: the kernels refuse it and nothing falls back."""
    cfg = gpt2.GPTConfig.tiny(attention_impl="flash", **TINY_FLASH_WIDTHS)
    model = gpt2.init(cfg, torch.Generator(device=device).manual_seed(3), device)
    cpu = gpt2.GPT2(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(4))
    _flash_counts_zero(fa)
    with torch.inference_mode():
        got = model(tokens.to(device)).cpu()
    counts = _counts(fa)
    with torch.inference_mode():
        want = cpu(tokens)
    _require(got.shape == (2, 128, cfg.vocab_size) and bool(torch.isfinite(got).all()),
             f"tiny flash logits {tuple(got.shape)} not finite")
    _require(counts == {"fwd": cfg.num_layers, "dq": 0, "dkv": 0},
             f"the D = {cfg.head_dim} tiny flash config launched {counts}, expected "
             f"{cfg.num_layers} forward launches")
    d = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **TINY_FLASH_TOL)

    small = gpt2.GPTConfig.tiny(attention_impl="flash")
    m16 = gpt2.init(small, torch.Generator(device=device).manual_seed(3), device)
    try:
        with torch.inference_mode():
            m16(tokens.to(device))
        refused = None
    except ValueError as e:
        refused = str(e)
    _require(refused is not None and "head dim" in refused,
             f"the tiny flash config (D = {small.head_dim}) ran on the card instead of raising")
    _log("runtime", f"C2: tiny flash config widened to D = {cfg.head_dim} (S = 128) on the card: flash "
                    f"launches {counts}, logits max |d| against the CPU {d:.3g}; at D = "
                    f"{small.head_dim} it raises: {refused}")
    return {"max_abs": d, "fwd_launches": counts["fwd"], "d16_refused": refused}


# [fit], [moe] and [vit]: the Train library's TorchTrainer fitting GPT-2-124M
# from a GPU-leased worker through a gang restart, then GPT-2 with experts
# and ViT-B/16 training on the card.
# The device of [fit], [moe], [vit], [deploy] and [push]; a CPU rehearsal
# of these phases sets "cpu".
DEVICE = "cuda"
FIT_CKPT_AFTER = 6  # the step after which the loop reports its checkpoint
# The last step the driver is sure to have from the first attempt, which
# kills its own process once the report of the next step returns: the
# driver asks for that report only after it has received this one.
FIT_DIE_AFTER = 8
# [moe]: GPT-2-124M with 8 experts, the Switch layout (Fedus et al., 2021):
# capacity factor 1.25 (C = 160 of 1024 tokens a row), aux coefficient 0.01.
MOE_EXPERTS = 8
# One block's _moe_mlp on the card in f32 against the same function on the
# CPU: a token whose two top router probabilities lie within MOE_MARGIN of
# each other may choose another expert on the other device (their f32
# logits differ by summation order, ~1e-6); every other token must choose
# the same expert and slot (rows where a near-tie token did flip are left
# out of the slot and output comparison, since it moves the slots of the
# row's later tokens), and its output agree within MOE_TOL: f32 products
# summed in another order (outputs of size ~0.02).
MOE_MARGIN = 1e-4
MOE_TOL = dict(atol=1e-5, rtol=1e-4)
# ViT-B/16 logits at B=2 in f32 on the card against the port's CPU forward
# from the same weights: f32 products summed in another order over 12
# layers, logits of size ~0.5.
VIT_BATCH, VIT_PARITY_BATCH = 64, 2
VIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _proc_start_epoch(pid="self"):
    """A process's start time as a Unix time, from /proc (10 ms ticks)."""
    with open(f"/proc/{pid}/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def _fs_type(path):
    """The filesystem type and mount point of ``path``, from /proc/mounts."""
    path = os.path.realpath(path)
    best = ("?", "")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fstype = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) >= len(best[1]):
                best = (fstype, mnt)
    return best


def _fit_loop(config):
    """The [fit] worker's loop: GPT-2-124M from seed 1 on its leased card,
    [train]'s steps on [train]'s batch, one report a step (loss, grad norm,
    step ms, the kernels' launches), a checkpoint (model, AdamW state, step)
    after FIT_CKPT_AFTER; on its first attempt it kills its own process
    once the report of the step after FIT_DIE_AFTER returns.  Resumes from
    the session's checkpoint."""
    t_loop = time.time()
    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.train.backend import process_group_facts

    dev = config["device"]
    t0 = time.time()
    torch.zeros(1, device=dev)
    _sync()
    facts = {**_worker_facts(), "group": process_group_facts(), "proc_start": _proc_start_epoch(),
             "loop_entry": t_loop, "cuda_init_s": time.time() - t0,
             "device_count": torch.cuda.device_count(),
             "device_name": torch.cuda.get_device_name(0) if dev == "cuda" else None}
    cfg = config["cfg"]
    t0 = time.time()
    model = gpt2.init(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    opt = spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1)
    _sync()
    facts["build_s"] = time.time() - t0
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        t0 = time.perf_counter()
        saved = ckpt.to_state_dict()
        t_read = time.perf_counter()
        model.load_state_dict(saved["model"])
        opt.load_state_dict(saved["optim"])
        _sync()
        start = saved["step"] + 1
        facts["restore"] = {"read_s": t_read - t0, "load_s": time.perf_counter() - t_read,
                            "path": ckpt.path}
        del saved
    step = spmd.compile_train_step(gpt2.loss_fn, opt)
    state = spmd.TrainState(start, model)
    batch = {"tokens": config["tokens"].to(dev)}
    trial_dir = train.get_context().get_trial_dir()
    marker = os.path.join(trial_dir, "killed")
    prev_report_s = None
    for i in range(start, config["steps"]):
        _flash_counts_zero(fa)
        _sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = metrics["loss"].item()
        step_ms = (time.perf_counter() - t0) * 1e3
        out = {"step": i, "loss": loss, "grad_norm": metrics["grad_norm"].item(), "step_ms": step_ms,
               "launches": _counts(fa), "attempt": 1 if ckpt is None else 2,
               "prev_report_s": prev_report_s}
        if i == start:
            out["facts"] = facts
        checkpoint = None
        if i == FIT_CKPT_AFTER:
            t0 = time.perf_counter()
            checkpoint = train.Checkpoint.from_state_dict(
                {"model": model.state_dict(), "optim": opt.state_dict(), "step": i})
            out["ckpt"] = {"write_s": time.perf_counter() - t0, "tmp": checkpoint.path,
                           "bytes": sum(os.path.getsize(os.path.join(checkpoint.path, f))
                                        for f in os.listdir(checkpoint.path))}
        t0 = time.perf_counter()
        train.report(out, checkpoint=checkpoint)
        prev_report_s = time.perf_counter() - t0
        if i == FIT_DIE_AFTER + 1 and not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write(repr(time.time()))
            os._exit(1)
    return state.step


def _shutdown_checked(rt, rt_api, phase):
    """shutdown(), then no process of the driver may remain."""
    group = rt_api._node_group
    rt.shutdown()
    deadline = time.monotonic() + 15
    while _descendants(os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = {p: _cmdline(p) for p in _descendants(os.getpid())}
    _require(not left, f"[{phase}] processes left after shutdown(): {left}")
    _require(group.gcs_proc.poll() is not None and group.raylet_proc.poll() is not None,
             f"[{phase}] the GCS or the raylet outlived shutdown()")


def phase_fit(fa, gpt2, cfg, tokens, train_out, smi):
    """[fit]: TorchTrainer.fit() of GPT-2-124M from a num_gpus=1 worker over
    an NCCL group of one, through the worker's death and the gang's restart
    from the step-FIT_CKPT_AFTER checkpoint; every reported loss must be
    [train]'s of the same step."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.core import api as rt_api

    steps = TRAIN_WARMUP + TRAIN_STEPS
    run = train.RunConfig(name=f"chip_smoke_fit_{os.getpid()}",
                          failure_config=train.FailureConfig(max_failures=1))
    trial_dir = os.path.join(run.resolved_storage_path(), run.name)
    t0 = time.perf_counter()
    rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    start_s = time.perf_counter() - t0
    try:
        t_fit = time.time()
        result = train.TorchTrainer(
            _fit_loop,
            train_loop_config={"cfg": cfg, "tokens": tokens.cpu(), "steps": steps, "device": DEVICE},
            # a CPU rehearsal leases no card: its worker forms gloo
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=DEVICE == "cuda"),
            backend_config=train.TorchConfig(init_distributed=True),
            run_config=run,
        ).fit()
        fit_s = time.time() - t_fit
    finally:
        _shutdown_checked(rt, rt_api, "fit")
    try:
        out = _fit_checks(result, t_fit, fit_s, start_s, cfg, train_out, trial_dir,
                          _fs_type(trial_dir), smi)
    finally:
        shutil.rmtree(trial_dir, ignore_errors=True)
    _log("fit", "shutdown(): no process of the driver remains; the trial dir is removed")
    return out


def _fit_checks(result, t_fit, fit_s, start_s, cfg, train_out, trial_dir, fs, smi):
    steps = TRAIN_WARMUP + TRAIN_STEPS
    _require(result.error is None, f"fit() ended with {result.error!r}")
    hist = result.metrics_dataframe
    got = [m["step"] for m in hist]
    # The report of the step after FIT_DIE_AFTER may have died with the
    # first attempt's process or reached the driver.
    first_attempt, resumed = list(range(FIT_DIE_AFTER + 1)), list(range(FIT_CKPT_AFTER + 1, steps))
    want_steps = (first_attempt + resumed, first_attempt + [FIT_DIE_AFTER + 1] + resumed)
    _require(got in want_steps, f"reported steps {got}, expected one of {want_steps}")
    first, second = hist[0], next(m for m in hist if m["attempt"] == 2)
    _require(first["attempt"] == 1 and second["attempt"] == 2, "the restart did not resume from the checkpoint")
    for m in (first, second):
        f = m["facts"]
        _check_worker(f, f"[fit] worker (attempt {m['attempt']})")
        _require(f["visible"] == "0" and f["device_count"] == 1,
                 f"the train worker sees CUDA_VISIBLE_DEVICES={f['visible']!r}, {f['device_count']} card(s)")
        g = f["group"]
        _require(g is not None and g["backend"] == "nccl" and g["world_size"] == 1 and g["all_reduce"] == 1,
                 f"the process group did not form as NCCL at world size 1: {g}")
    _require(first["facts"]["pid"] != second["facts"]["pid"], "the restarted gang reused the killed process")
    mismatched = [(m["step"], m["loss"], train_out["losses"][m["step"]]) for m in hist
                  if m["loss"] != train_out["losses"][m["step"]]]
    bad_launches = [(m["step"], m["launches"]) for m in hist
                    if m["launches"] != {"fwd": cfg.num_layers, "dq": cfg.num_layers, "dkv": cfg.num_layers}]
    _log("fit", "loss " + " ".join(f"{m['step']}:{m['loss']:.6f}" for m in hist))
    _log("fit", f"losses against [train]'s of the same step: {len(hist) - len(mismatched)} of {len(hist)} "
                f"bit-equal; differing {mismatched}")
    _require(not bad_launches, f"steps whose kernel launches were not {cfg.num_layers} of each: {bad_launches}")
    _require(not mismatched, f"[fit] losses differ from [train]'s: {mismatched}")
    launches = {k: sum(m["launches"][k] for m in hist) for k in ("fwd", "dq", "dkv")}

    f, g = first["facts"], first["facts"]["group"]
    t_import = g["at"] - g["init_s"] - g["import_s"]
    # The raylet may hand the lease to a worker process it started earlier:
    # the process's start is printed beside, not counted in, the parts.
    parts = {"reserve_lease_actor": t_import - t_fit, "torch_import": g["import_s"], "nccl_init": g["init_s"],
             "to_loop": f["loop_entry"] - g["at"], "cuda_init": f["cuda_init_s"], "model_build": f["build_s"]}
    first_s = first["_timestamp"] - t_fit
    _log("fit", f"{smi}: runtime start {start_s:.3f} s; TorchTrainer.fit() {fit_s:.3f} s in all; first "
                f"reported step at {first_s:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
                + f", first step {first['step_ms'] / 1e3:.3f} s (the worker process started "
                f"{f['proc_start'] - t_fit:+.3f} s from fit())")
    _log("fit", f"worker on {f['device_name']} (CUDA_VISIBLE_DEVICES={f['visible']!r}, pid {f['pid']}), "
                f"no JAX loaded; process group {g['backend']} world size {g['world_size']}, all_reduce of "
                f"ones {g['all_reduce']}")
    ckpt_round = next(m for m in hist if "ckpt" in m)
    after = next(m for m in hist if m["step"] == FIT_CKPT_AFTER + 1 and m["attempt"] == 1)
    nbytes = ckpt_round["ckpt"]["bytes"]
    write_s, report_s = ckpt_round["ckpt"]["write_s"], after["prev_report_s"]
    plain_report_s = sorted(m["prev_report_s"] for m in hist if m["prev_report_s"] is not None
                            and m["step"] != FIT_CKPT_AFTER + 1)[0]
    restore = second["facts"]["restore"]
    restore_s = restore["read_s"] + restore["load_s"]
    _log("fit", f"checkpoint {nbytes / 1e9:.3f} GB (model and AdamW state, f32) to {fs[0]} (mount {fs[1]}): "
                f"write {write_s:.3f} s ({nbytes / write_s / 1e9:.3f} GB/s), report with persist "
                f"{report_s:.3f} s (a report without a checkpoint {plain_report_s:.4f} s); "
                f"{nbytes / (write_s + report_s) / 1e9:.3f} GB/s written and persisted; restore "
                f"{restore_s:.3f} s ({nbytes / restore_s / 1e9:.3f} GB/s: read to the CPU {restore['read_s']:.3f} "
                f"s, load onto the card {restore['load_s']:.3f} s)")
    with open(os.path.join(trial_dir, "killed")) as fh:
        killed_at = float(fh.read())
    f2, g2 = second["facts"], second["facts"]["group"]
    t_import2 = g2["at"] - g2["init_s"] - g2["import_s"]
    restart = {"teardown_reserve_lease_actor": t_import2 - killed_at, "torch_import": g2["import_s"],
               "nccl_init": g2["init_s"], "to_loop": f2["loop_entry"] - g2["at"], "cuda_init": f2["cuda_init_s"],
               "model_build": f2["build_s"], "restore": restore_s}
    resumed_s = second["_timestamp"] - killed_at
    last = max(m["step"] for m in hist if m["attempt"] == 1)
    _log("fit", f"killed once step {FIT_DIE_AFTER + 1}'s report returned (the driver had the first attempt's "
                f"steps up to {last}); first resumed step (step {second['step']}) reported "
                f"{resumed_s:.3f} s later: " + ", ".join(f"{k} {v:.3f} s" for k, v in restart.items())
                + f", first step {second['step_ms'] / 1e3:.3f} s (the new worker process started "
                f"{f2['proc_start'] - killed_at:+.3f} s from the kill)")
    worker_ms = _spread([m["step_ms"] for m in hist if m["step"] >= TRAIN_WARMUP and m["step"] != second["step"]])
    _log("fit", f"step {worker_ms[0]:.3f} ms in the worker (median, quartiles {worker_ms[1]:.3f}..{worker_ms[2]:.3f}) "
                f"against [train]'s {train_out['step_ms']:.3f} ms; kernel launches in the worker {launches} "
                f"({cfg.num_layers} of each per step, {len(hist)} steps)")
    return {"launches": launches, "first_step_s": first_s, "first_step_parts_s": parts,
            "resumed_step_s": resumed_s, "restart_parts_s": restart, "ckpt_bytes": nbytes,
            "ckpt_write_s": write_s, "ckpt_report_s": report_s, "restore_s": restore_s,
            "storage_fs": fs[0], "worker_step_ms": worker_ms[0], "train_step_ms": train_out["step_ms"],
            "fit_s": fit_s, "losses_bitwise": True}


# [tune]: the Tune library on the runtime.  (a) ASHA over function trials
# of [fit]'s loop, each leasing the card, queued on it in turn; (b) a Tuner
# over a TorchTrainer, whose worker leases the card while the trial actor
# leases none.  Users sweeping a fine-tune's learning rate on one card run
# this.
TUNE_LRS = (3e-4, 1e-3, 3e-3, 1e-2)
TUNE_ASHA = dict(max_t=8, grace_period=2, reduction_factor=2)
TUNE_TRAINER_LRS = (3e-4, 1e-3)
TUNE_TRAINER_STEPS = 4


def _alive(pid):
    """Whether process ``pid`` runs (a zombie has let go of its card)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _tune_loop(config):
    """A [tune] trial's loop: [fit]'s loop without its self-kill, at
    ``config["lr"]``.  GPT-2-124M from seed 1 on the leased card, [train]'s
    steps on [train]'s batch, one report a step (loss, step ms, the
    kernels' launches in the step and so far, the visible cards); the
    first also carries the process's facts and, with
    ``config["pid_dir"]``, the earlier trials' processes still alive then
    (each trial leaves its pid there).  With ``config["ckpt"]`` the last
    step reports a state-dict checkpoint of the model and its checksum."""
    t_loop = time.time()
    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import spmd

    pid_dir = config.get("pid_dir")
    if pid_dir:
        open(os.path.join(pid_dir, str(os.getpid())), "w").close()
    dev = config["device"]
    t0 = time.time()
    torch.zeros(1, device=dev)
    _sync()
    facts = {**_worker_facts(), "loop_entry": t_loop,
             "cuda_init_s": time.time() - t0, "device_count": torch.cuda.device_count(),
             "device_name": torch.cuda.get_device_name(0) if dev == "cuda" else None}
    t0 = time.time()
    model = gpt2.init(config["cfg"], torch.Generator(device=dev).manual_seed(1), dev)
    step = spmd.compile_train_step(
        gpt2.loss_fn, spmd.adamw(model.parameters(), config["lr"], weight_decay=0.1))
    _sync()
    facts["build_s"] = time.time() - t0
    state = spmd.TrainState(0, model)
    batch = {"tokens": config["tokens"].to(dev)}
    total = {"fwd": 0, "dq": 0, "dkv": 0}
    for i in range(config["steps"]):
        _flash_counts_zero(fa)
        _sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = metrics["loss"].item()
        launches = _counts(fa)
        total = {k: total[k] + launches[k] for k in total}
        out = {"step": i, "lr": config["lr"], "loss": loss, "step_ms": (time.perf_counter() - t0) * 1e3,
               "launches": launches, "launches_total": total,
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
        if i == 0:
            others = [int(p) for p in os.listdir(pid_dir)] if pid_dir else []
            out["facts"] = {**facts, "alive_before": [p for p in others if p != os.getpid() and _alive(p)]}
        checkpoint = None
        if config.get("ckpt") and i == config["steps"] - 1:
            weights = model.state_dict()
            out["checksum"] = _checksum(weights)
            checkpoint = train.Checkpoint.from_state_dict({"model": weights})
        train.report(out, checkpoint=checkpoint)
    return state.step


def _replayed_iterations(sched, results):
    """Per trial: the results a controller driven by ``sched`` takes before
    its first STOP, the results fed in arrival order."""
    ran, stopped = {}, set()
    for trial, m in sorted(results, key=lambda r: r[1]["_timestamp"]):
        if trial in stopped:
            continue
        ran[trial] = ran.get(trial, 0) + 1
        if sched.on_trial_result(trial, dict(m)) == "STOP":
            stopped.add(trial)
    return ran


def phase_tune(fa, gpt2, cfg, tokens, train_out, smi):
    """[tune]: (a) ASHA over four GPU-leased function trials of GPT-2-124M
    queued on the one card, (b) a Tuner over a TorchTrainer of the same
    loop; every loss against [train]'s."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.core import api as rt_api

    storage = train.RunConfig().resolved_storage_path()
    names = (f"chip_smoke_tune_asha_{os.getpid()}", f"chip_smoke_tune_trainer_{os.getpid()}")
    pid_dir = os.path.join(storage, names[0], "pids")
    os.makedirs(pid_dir)
    rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    try:
        t_a = time.time()
        asha = tune.Tuner(
            tune.with_resources(_tune_loop, {"GPU": 1}),
            param_space={"lr": tune.grid_search(list(TUNE_LRS)), "cfg": cfg, "tokens": tokens.cpu(),
                         "steps": TUNE_ASHA["max_t"], "device": DEVICE, "pid_dir": pid_dir},
            tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=tune.ASHAScheduler(**TUNE_ASHA)),
            run_config=train.RunConfig(name=names[0]),
        ).fit()
        asha_s = time.time() - t_a
        t_b = time.time()
        over_trainer = tune.Tuner(
            train.TorchTrainer(
                _tune_loop,
                train_loop_config={"cfg": cfg, "tokens": tokens.cpu(), "steps": TUNE_TRAINER_STEPS,
                                   "device": DEVICE, "ckpt": True, "lr": TUNE_TRAINER_LRS[0]},
                scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True)),
            param_space={"train_loop_config": {"lr": tune.grid_search(list(TUNE_TRAINER_LRS))}},
            tune_config=tune.TuneConfig(metric="loss", mode="min"),
            run_config=train.RunConfig(name=names[1]),
        ).fit()
        trainer_s = time.time() - t_b
        best = over_trainer.get_best_result(metric="loss", mode="min")
        restored = best.checkpoint.to_state_dict()["model"] if best.checkpoint is not None else None
    finally:
        _shutdown_checked(rt, rt_api, "tune")
    try:
        a = _tune_asha_checks(tune, asha, t_a, asha_s, cfg, train_out, smi)
        b = _tune_trainer_checks(over_trainer, best, restored, trainer_s, cfg, train_out, smi)
    finally:
        for name in names:
            shutil.rmtree(os.path.join(storage, name), ignore_errors=True)
    _log("tune", "shutdown(): no process of the driver remains; the trial dirs are removed")
    launches = {k: a["launches"][k] + b["launches"][k] for k in ("fwd", "dq", "dkv")}
    return {"asha": a, "trainer": b, "launches": launches}


def _tune_asha_checks(tune, grid, t_fit, fit_s, cfg, train_out, smi):
    per_step = {"fwd": cfg.num_layers, "dq": cfg.num_layers, "dkv": cfg.num_layers}
    _require(not grid.errors, f"[tune] ASHA trials failed: {grid.errors}")
    trials = []
    for r in grid:
        hist = r.metrics_dataframe
        _require(hist and hist[0]["step"] == 0 and "facts" in hist[0], f"[tune] {r.path} reported {hist}")
        trials.append({"path": r.path, "hist": hist, "facts": hist[0]["facts"], "lr": hist[0]["lr"]})
        _check_worker(hist[0]["facts"], f"[tune] trial lr={hist[0]['lr']}")
    _require(sorted(t["lr"] for t in trials) == sorted(TUNE_LRS), f"[tune] trials {[t['lr'] for t in trials]}")
    # Every trial's lease: the card, one of it; the first loss is [train]'s.
    for t in trials:
        f = t["facts"]
        _require(f["visible"] == "0" and f["device_count"] == 1,
                 f"[tune] trial lr={t['lr']} sees CUDA_VISIBLE_DEVICES={f['visible']!r}, "
                 f"{f['device_count']} card(s)")
        _require(t["hist"][0]["loss"] == train_out["losses"][0],
                 f"[tune] trial lr={t['lr']}: first loss {t['hist'][0]['loss']!r}, "
                 f"[train]'s {train_out['losses'][0]!r}")
        bad = [(m["step"], m["launches"]) for m in t["hist"] if m["launches"] != per_step]
        _require(not bad, f"[tune] trial lr={t['lr']}: steps whose launches were not {per_step}: {bad}")
    order = sorted(trials, key=lambda t: t["facts"]["loop_entry"])
    # [train]'s lr: its losses are [train]'s; the first trial to reach each
    # rung survives it, so run first it runs to max_t.
    base = next(t for t in trials if t["lr"] == 3e-4)
    got = [m["loss"] for m in base["hist"]]
    _require(got == train_out["losses"][:len(got)] and (len(got) == TUNE_ASHA["max_t"] or base is not order[0]),
             f"[tune] the 3e-4 trial's losses {got} are not [train]'s first {TUNE_ASHA['max_t']} "
             f"{train_out['losses'][:TUNE_ASHA['max_t']]}")
    # The leases in turn: a trial's loop starts after the trial before it
    # last reported, and no earlier trial's process lives at its first
    # step.  (Loop entry, not the process's start: /proc gives that to the
    # second only.)
    for prev, nxt in zip(order, order[1:]):
        _require(nxt["facts"]["loop_entry"] > prev["hist"][-1]["_timestamp"],
                 f"[tune] trial lr={nxt['lr']} entered its loop at {nxt['facts']['loop_entry']:.3f}, before "
                 f"trial lr={prev['lr']} last reported at {prev['hist'][-1]['_timestamp']:.3f}")
    for t in trials:
        _require(not t["facts"]["alive_before"],
                 f"[tune] trial lr={t['lr']}: earlier trials' processes alive at its first step: "
                 f"{t['facts']['alive_before']}")
    ran = {t["path"]: len(t["hist"]) for t in trials}
    replay = _replayed_iterations(tune.ASHAScheduler(metric="loss", mode="min", **TUNE_ASHA),
                                  [(t["path"], m) for t in trials for m in t["hist"]])
    _require(ran == replay, f"[tune] iterations {ran}, the ASHA replay decides {replay}")
    launches = {k: sum(m["launches"][k] for t in trials for m in t["hist"]) for k in per_step}

    _log("tune", f"{smi}: (a) ASHA(max_t={TUNE_ASHA['max_t']}, grace {TUNE_ASHA['grace_period']}, "
                 f"rf {TUNE_ASHA['reduction_factor']}) over {len(trials)} trials with {{'GPU': 1}} in "
                 f"{fit_s:.3f} s, run in the order lr=" + ", ".join(f"{t['lr']:g}" for t in order)
                 + f"; iterations equal a fresh ASHA's replay; leases in turn, every first loss [train]'s, "
                 f"the 3e-4 trial's {len(got)} losses [train]'s bit for bit")
    prev = None
    out = []
    for t in order:
        f, h = t["facts"], t["hist"]
        # The trial's start: fit() for the first, the last report of the
        # trial before it for the others (its lease waited for that one's).
        start = prev["hist"][-1]["_timestamp"] if prev else t_fit
        steady = [m["step_ms"] for m in h[1:]] or [h[0]["step_ms"]]
        ms = _spread(steady)
        _log("tune", f"trial lr={t['lr']:g}: {len(h)} iterations (loss {h[-1]['loss']:.6f}); first report "
                     f"{h[0]['_timestamp'] - start:.3f} s after {'the trial before it last reported' if prev else 'fit()'}: "
                     f"to the loop {f['loop_entry'] - start:.3f} s (lease, worker start, imports), CUDA init "
                     f"{f['cuda_init_s']:.3f}, build {f['build_s']:.3f}, first step {h[0]['step_ms'] / 1e3:.3f} s; "
                     f"step {ms[0]:.3f} ms (median of {len(steady)}, quartiles {ms[1]:.3f}..{ms[2]:.3f}) against "
                     f"[train]'s {train_out['step_ms']:.3f} ms")
        out.append({"lr": t["lr"], "iterations": len(h), "to_loop_s": f["loop_entry"] - start,
                    "first_report_s": h[0]["_timestamp"] - start, "step_ms": ms[0]})
        prev = t
    _log("tune", f"(a) kernel launches over the trials {launches} ({cfg.num_layers} of each per step, "
                 f"{sum(len(t['hist']) for t in trials)} steps)")
    return {"trials": out, "launches": launches, "fit_s": fit_s, "train_step_ms": train_out["step_ms"]}


def _tune_trainer_checks(grid, best, restored, fit_s, cfg, train_out, smi):
    per_step = {"fwd": cfg.num_layers, "dq": cfg.num_layers, "dkv": cfg.num_layers}
    _require(not grid.errors and len(grid) == len(TUNE_TRAINER_LRS),
             f"[tune] trainer trials: {len(grid)}, errors {grid.errors}")
    out = []
    for r, lr in zip(grid, TUNE_TRAINER_LRS):
        m = r.metrics
        _require(len(r.metrics_dataframe) == 1, f"[tune] trainer trial lr={lr} reported "
                                                f"{len(r.metrics_dataframe)} times, not once")
        _require(m["trial_cuda_visible_devices"] == "" and m["step"] == TUNE_TRAINER_STEPS - 1,
                 f"[tune] trainer trial lr={lr}: the trial actor sees CUDA_VISIBLE_DEVICES="
                 f"{m['trial_cuda_visible_devices']!r}; last step {m['step']}")
        _require(m["visible"] == "0", f"[tune] trainer trial lr={lr}: the trainer's worker sees "
                                      f"CUDA_VISIBLE_DEVICES={m['visible']!r}")
        want = {k: TUNE_TRAINER_STEPS * n for k, n in per_step.items()}
        _require(m["launches"] == per_step and m["launches_total"] == want,
                 f"[tune] trainer trial lr={lr}: launches {m['launches']} in the last step, "
                 f"{m['launches_total']} in all; expected {per_step} a step")
        out.append({"lr": lr, "loss": m["loss"], "launches": m["launches_total"]})
    base = out[TUNE_TRAINER_LRS.index(3e-4)]
    _require(base["loss"] == train_out["losses"][TUNE_TRAINER_STEPS - 1],
             f"[tune] the 3e-4 trainer trial's loss {base['loss']!r} is not [train]'s step-"
             f"{TUNE_TRAINER_STEPS} loss {train_out['losses'][TUNE_TRAINER_STEPS - 1]!r}")
    _require(best.metrics["loss"] == min(o["loss"] for o in out) and best.metrics["loss"] != max(
        o["loss"] for o in out), f"[tune] get_best_result picked {best.metrics['loss']!r} of {out}")
    _require(restored is not None and _checksum(restored) == best.metrics["checksum"],
             "[tune] the best result's checkpoint does not restore the trial's weights")
    _log("tune", f"{smi}: (b) Tuner over TorchTrainer(ScalingConfig(num_workers=1, use_gpu=True)), "
                 f"{TUNE_TRAINER_STEPS} steps a trial, in {fit_s:.3f} s: " + ", ".join(
                     f"lr={o['lr']:g} loss {o['loss']:.6f}" for o in out)
                 + f"; each reported once; trial actors leased no card, the trainer's worker card 0; "
                 f"the 3e-4 loss is [train]'s step "
                 f"{TUNE_TRAINER_STEPS} bit for bit; best lr={TUNE_TRAINER_LRS[[o['loss'] for o in out].index(best.metrics['loss'])]:g}, "
                 f"its checkpoint restores the checksummed weights")
    launches = {k: sum(o["launches"][k] for o in out) for k in per_step}
    return {"trials": out, "launches": launches, "fit_s": fit_s}


# [ingest]: the Data library feeds [fit]'s training on the card.  104
# seeded rows of 1025 GPT-2 tokens in 4 parquet files: 13 batches of 8.
INGEST_ROWS, INGEST_FILES, INGEST_BATCH, INGEST_SEED = 104, 4, 8, 4


def _ingest_files(path):
    """INGEST_ROWS seeded rows (1025 int32 tokens and an int64 row_id) in
    INGEST_FILES parquet files under ``path``, written with pyarrow."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    tokens = np.random.default_rng(INGEST_SEED).integers(0, 50257, (INGEST_ROWS, 1025), dtype=np.int32)
    per = INGEST_ROWS // INGEST_FILES
    os.makedirs(path)
    for i in range(INGEST_FILES):
        rows = slice(i * per, (i + 1) * per)
        pq.write_table(pa.table({
            "tokens": pa.FixedSizeListArray.from_arrays(pa.array(tokens[rows].reshape(-1)), 1025),
            "row_id": pa.array(np.arange(INGEST_ROWS, dtype=np.int64)[rows]),
        }), os.path.join(path, f"part-{i}.parquet"))
    return tokens.nbytes


def _ingest_rows(path):
    """row_id -> tokens, read from the files with pyarrow (not through
    Data)."""
    import glob

    import pyarrow.parquet as pq

    out = {}
    for f in sorted(glob.glob(os.path.join(path, "*.parquet"))):
        t = pq.read_table(f)
        flat = t.column("tokens").combine_chunks().flatten().to_numpy()
        for rid, row in zip(t.column("row_id").to_pylist(), flat.reshape(t.num_rows, -1)):
            out[rid] = row
    return out


def _split_tokens(batch):
    """A Data map_batches stage: each row's 1025 tokens as int64 inputs and
    targets of 1024."""
    import numpy as np

    tok = batch["tokens"].astype(np.int64)
    return {"inputs": tok[:, :-1], "targets": tok[:, 1:], "row_id": batch["row_id"]}


def _ingest_loop(config):
    """The [ingest] worker's loop: GPT-2-124M from seed 1 on its leased card
    (phase 6's model and optimizer), one step a batch of its dataset shard,
    read by iter_device_batches at its default device; one report a step
    (loss, the batch's row_ids, the ms it waited for the batch, step ms,
    the kernels' launches), then the shard's Data execution stats."""
    t_loop = time.time()
    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import spmd

    dev = config["device"]
    t0 = time.time()
    torch.zeros(1, device=dev)
    _sync()
    facts = {**_worker_facts(), "proc_start": _proc_start_epoch(), "loop_entry": t_loop,
             "cuda_init_s": time.time() - t0, "device_count": torch.cuda.device_count(),
             "device_name": torch.cuda.get_device_name(0) if dev == "cuda" else None}
    t0 = time.time()
    model = gpt2.init(config["cfg"], torch.Generator(device=dev).manual_seed(1), dev)
    step = spmd.compile_train_step(gpt2.loss_fn, spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1))
    _sync()
    facts["build_s"] = time.time() - t0
    state = spmd.TrainState(0, model)
    shard = train.get_dataset_shard("train")
    # the default device is the card; a CPU rehearsal names its own
    where = {} if dev == "cuda" else {"device": dev}
    batches = shard.iter_device_batches(batch_size=INGEST_BATCH, **where)
    i = 0
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        wait_ms = (time.perf_counter() - t0) * 1e3
        if batch is None:
            break
        _flash_counts_zero(fa)
        _sync()
        t0 = time.perf_counter()
        state, metrics = step(state, {"inputs": batch["inputs"], "targets": batch["targets"]})
        loss = metrics["loss"].item()
        step_ms = (time.perf_counter() - t0) * 1e3
        out = {"step": i, "loss": loss, "row_ids": batch["row_id"].tolist(), "wait_ms": wait_ms,
               "step_ms": step_ms, "launches": _counts(fa), "device": str(batch["inputs"].device),
               "dtype": str(batch["inputs"].dtype)}
        if i == 0:
            out["facts"] = facts
        train.report(out)
        i += 1
    train.report({"end": True, "steps": i, "end_wait_ms": wait_ms, "data_stats": shard._ds.stats()})


def phase_ingest(fa, gpt2, spmd, cfg, smi):
    """[ingest]: TorchTrainer(datasets={"train": ds}) of GPT-2-124M from a
    num_gpus=1 worker, ds read from parquet through Data; every loss must
    be the in-process replay's over the same batches, bit for bit."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import data, train
    from ray_tpu_torch.core import api as rt_api

    run = train.RunConfig(name=f"chip_smoke_ingest_{os.getpid()}")
    trial_dir = os.path.join(run.resolved_storage_path(), run.name)
    t0 = time.perf_counter()
    info = rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    start_s = time.perf_counter() - t0
    path = os.path.join(info["session_dir"], "ingest_data")
    try:
        t0 = time.perf_counter()
        nbytes = _ingest_files(path)
        write_s = time.perf_counter() - t0
        ds = data.read_parquet(path).map_batches(_split_tokens)
        t_fit = time.time()
        result = train.TorchTrainer(
            _ingest_loop,
            train_loop_config={"cfg": cfg, "device": DEVICE},
            # a CPU rehearsal leases no card
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=DEVICE == "cuda"),
            run_config=run,
            datasets={"train": ds},
        ).fit()
        fit_s = time.time() - t_fit
        rows = _ingest_rows(path)
    finally:
        _shutdown_checked(rt, rt_api, "ingest")
        shutil.rmtree(trial_dir, ignore_errors=True)
    _log("ingest", "shutdown(): no process of the driver remains; the trial dir is removed")
    return _ingest_checks(fa, gpt2, spmd, cfg, result, rows, t_fit, fit_s, start_s, nbytes, write_s, smi)


def _ingest_checks(fa, gpt2, spmd, cfg, result, rows, t_fit, fit_s, start_s, nbytes, write_s, smi):
    _require(result.error is None, f"[ingest] fit() ended with {result.error!r}")
    hist = [m for m in result.metrics_dataframe if "step" in m]
    end = next(m for m in result.metrics_dataframe if m.get("end"))
    n_steps = INGEST_ROWS // INGEST_BATCH
    _require([m["step"] for m in hist] == list(range(n_steps)) and end["steps"] == n_steps,
             f"[ingest] reported steps {[m['step'] for m in hist]}, expected {n_steps}")
    seen = [r for m in hist for r in m["row_ids"]]
    _require(sorted(seen) == list(range(INGEST_ROWS)), f"[ingest] row_ids seen {sorted(seen)}")
    per_step = {"fwd": cfg.num_layers, "dq": cfg.num_layers, "dkv": cfg.num_layers}
    bad_launches = [(m["step"], m["launches"]) for m in hist if m["launches"] != per_step]
    _require(not bad_launches, f"[ingest] steps whose launches were not {per_step}: {bad_launches}")
    _require(all(m["device"].startswith(DEVICE) and m["dtype"] == "torch.int64" for m in hist),
             f"[ingest] batches on {[m['device'] for m in hist]} as {[m['dtype'] for m in hist]}")
    f = hist[0]["facts"]
    _check_worker(f, "[ingest] worker")
    if DEVICE == "cuda":
        _require(f["visible"] == "0" and f["device_count"] == 1,
                 f"the ingest worker sees CUDA_VISIBLE_DEVICES={f['visible']!r}, {f['device_count']} card(s)")

    # The replay: phase 6's in-process step over the same batches, in the
    # reported order, read from the files with pyarrow.
    import numpy as np

    model = gpt2.init(cfg, torch.Generator(device=DEVICE).manual_seed(1), DEVICE)
    step = spmd.compile_train_step(gpt2.loss_fn, spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1))
    state, replay = spmd.TrainState(0, model), []
    for m in hist:
        tok = torch.from_numpy(np.stack([rows[r] for r in m["row_ids"]]).astype(np.int64)).to(DEVICE)
        state, metrics = step(state, {"inputs": tok[:, :-1], "targets": tok[:, 1:]})
        replay.append(metrics["loss"].item())
    del model, state, step
    mismatched = [(m["step"], m["loss"], want) for m, want in zip(hist, replay) if m["loss"] != want]
    losses = [m["loss"] for m in hist]
    _log("ingest", "loss " + " ".join(f"{x:.6f}" for x in losses))
    _log("ingest", f"losses against the in-process replay over the same batches: "
                   f"{len(hist) - len(mismatched)} of {len(hist)} bit-equal; differing {mismatched}")
    _require(not mismatched, f"[ingest] losses differ from the replay's: {mismatched}")
    _require(all(math.isfinite(x) for x in losses), f"[ingest] non-finite loss: {losses}")

    waits = [m["wait_ms"] for m in hist]
    steps_ms = [m["step_ms"] for m in hist[1:]]  # the first step's kernels are cold
    wait_med, step_med = _spread(waits[1:])[0], _spread(steps_ms)[0]
    t_import = f["loop_entry"] - t_fit
    parts = {"reserve_lease_worker_to_loop": t_import, "cuda_init": f["cuda_init_s"], "model_build": f["build_s"],
             "first_batch_wait": waits[0] / 1e3, "first_step": hist[0]["step_ms"] / 1e3}
    first_s = hist[0]["_timestamp"] - t_fit
    launches = {k: sum(m["launches"][k] for m in hist) for k in per_step}
    _log("ingest", f"{smi}: runtime start {start_s:.3f} s; {INGEST_ROWS} rows ({nbytes / 1e6:.3f} MB of tokens) "
                   f"written to {INGEST_FILES} parquet files in {write_s:.3f} s; TorchTrainer.fit() {fit_s:.3f} s "
                   f"in all; first reported step at {first_s:.3f} s: "
                   + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
                   + f" (the worker process started {f['proc_start'] - t_fit:+.3f} s from fit())")
    _log("ingest", f"wait for a batch (steps 1-{len(hist) - 1}): median {wait_med:.3f} ms, max {max(waits[1:]):.3f} "
                   f"ms, against the step's median {step_med:.3f} ms (ratio {wait_med / step_med:.4f}); the "
                   f"first batch's wait {waits[0]:.3f} ms, the end of the shard's {end['end_wait_ms']:.3f} ms")
    _log("ingest", f"worker on {f['device_name']} (CUDA_VISIBLE_DEVICES={f['visible']!r}, pid {f['pid']}), "
                   f"no JAX loaded; kernel launches {launches} ({cfg.num_layers} of each per step, "
                   f"{len(hist)} steps); every row seen once")
    for line in end["data_stats"].splitlines():
        _log("ingest", f"data stats: {line}")
    return {"launches": launches, "losses": losses, "losses_bitwise": True, "wait_ms_median": wait_med,
            "wait_ms_max": max(waits[1:]), "step_ms": step_med, "first_step_s": first_s,
            "first_step_parts_s": parts, "fit_s": fit_s, "data_stats": end["data_stats"]}


# [dag], [workflow], [cluster]: a compiled DAG, a durable workflow and a
# multi-raylet Cluster, each driving GPT-2-124M from [train]'s seed on the
# card.  Their batches are BATCH_SHAPE tokens (a CPU rehearsal shrinks it).
BATCH_SHAPE = (8, 1025)
DAG_ITERS = 20  # iterations behind each median the phase prints
DAG_IN_FLIGHT = 4
# Holds the CPU stage's token batch (65.6 KB at BATCH_SHAPE), not the GPU
# stage's output (the last position's f32 logits, 1.6 MB).
DAG_SMALL_BUFFER = 1 << 18
WF_TRAIN_STEPS = 3
# The [cluster] GPU task's forwards go on after its first (at most this
# long) until its node is removed under it: the driver reads its lease and
# stacks meanwhile.
CLUSTER_HOLD_S = 120.0


def _card(device):
    """The device a stage, step or task of these phases computes on: the
    leased card, named explicitly (never the thread's current device), and
    a refusal where the lease has none.  A CPU rehearsal passes "cpu"."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() != 1:
        raise RuntimeError(f"no single card in this lease: CUDA_VISIBLE_DEVICES="
                           f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}")
    return torch.device("cuda", 0)


def _seed1_state(gpt2, cfg, device):
    """[train]'s initial weights (seed 1, drawn on ``device``): the model and
    its CPU state dict (f32, as the model keeps them)."""
    model = gpt2.init(cfg, torch.Generator(device=device).manual_seed(1), device)
    return model, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _seeded_batch(seed, vocab_size):
    """A BATCH_SHAPE int64 token batch drawn on the CPU from ``seed``."""
    return torch.randint(0, vocab_size, BATCH_SHAPE, generator=torch.Generator().manual_seed(seed))


def _rows_forward(model, tokens):
    """One flash forward of tokens[:, :-1]: each row's mean next-token loss
    and the last position's logits, both f32 on the model's device (the
    full logits stay on the card: 1.6 GB at (8, 1024))."""
    import torch.nn.functional as F

    with torch.inference_mode():
        logits = model(tokens[:, :-1])
        rows = F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten(), reduction="none")
        return rows.view(tokens.shape[0], -1).mean(1), logits[:, -1].clone()


def _card_facts():
    return {**_worker_facts(), "device_count": torch.cuda.device_count()}


def _bit_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


class _DagBatcher:
    """[dag]'s CPU stage: the seeded token batch of its input."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def make_batch(self, seed):
        return seed, _seeded_batch(abs(seed), self.vocab_size)

    def echo(self, x):
        return x


class _DagForward:
    """[dag]'s GPU stage: GPT-2-124M on its leased card, per-row losses and
    last-position logits of each batch; it refuses a negative seed."""

    def __init__(self, refs, cfg, device):
        import ray_tpu_torch

        self.device = _card(device)
        _, self.model = _build_gpt2(ray_tpu_torch.get(refs[0]), cfg, self.device)
        self.launches = []

    def forward(self, item):
        from ray_tpu_torch.ops import flash_attention as fa

        seed, tokens = item
        if seed < 0:
            raise ValueError(f"the GPU stage refuses the batch of seed {seed}")
        before = fa.flash_attention_fwd.launches
        rows, last = _rows_forward(self.model, tokens.to(self.device))
        self.launches.append(fa.flash_attention_fwd.launches - before)
        return {"seed": seed, "rows": rows, "last": last}

    def facts(self):
        return {**_card_facts(), "launches": list(self.launches)}


class _CardHolder:
    def facts(self):
        return _card_facts()


def phase_dag(gpt2, cfg, smi):
    """[dag]: InputNode -> CPU actor's make_batch -> GPU actor's forward,
    compiled onto shm channels: bit-equal to the same actor's .remote() and
    to the driver's forward, pipelined, errors, capacity, teardown."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api

    t0 = time.perf_counter()
    rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    start_s = time.perf_counter() - t0
    try:
        out = _dag_checks(rt, gpt2, cfg, smi)
    finally:
        _shutdown_checked(rt, rt_api, "dag")
    _log("dag", f"shutdown(): no process of the driver remains; cluster start {start_s:.3f} s")
    return out


def _dag_checks(rt, gpt2, cfg, smi):
    from ray_tpu_torch.dag import InputNode

    model, state = _seed1_state(gpt2, cfg, DEVICE)
    ref = rt.put(state)
    seeds = list(range(DAG_IN_FLIGHT))
    want = {}
    for s in seeds:
        rows, last = _rows_forward(model, _seeded_batch(s, cfg.vocab_size).to(DEVICE))
        want[s] = (rows.cpu(), last.cpu())
    del model
    cpu = rt.remote(num_cpus=1)(_DagBatcher).remote(cfg.vocab_size)
    gpu = rt.remote(num_gpus=1)(_DagForward).remote([ref], cfg, DEVICE)

    def held(got, s, what):
        _require(got["seed"] == s, f"[dag] {what}: output of seed {got['seed']} where {s} was due")
        _require(got["rows"].device.type == "cpu" and got["last"].device.type == "cpu",
                 f"[dag] {what}: the stage's tensors did not arrive as CPU tensors")
        _require(_bit_equal(got["rows"], want[s][0]) and _bit_equal(got["last"], want[s][1]),
                 f"[dag] {what}: seed {s} differs from the driver's forward: rows max |d| "
                 f"{(got['rows'] - want[s][0]).abs().max().item():.3g}")

    # The same actor through .remote() + get, before the DAG's loop holds
    # the actor's thread (a .remote() call would wait for its teardown).
    t0 = time.perf_counter()
    remote = {s: rt.get(gpu.forward.remote(cpu.make_batch.remote(s)), timeout=600) for s in seeds}
    first_s = time.perf_counter() - t0
    for s in seeds:
        held(remote[s], s, ".remote()")
    remote_ms = []
    for i in range(DAG_ITERS):
        t0 = time.perf_counter()
        rt.get(gpu.forward.remote(cpu.make_batch.remote(i % len(seeds))), timeout=300)
        remote_ms.append((time.perf_counter() - t0) * 1e3)
    n_remote = len(seeds) + DAG_ITERS

    with InputNode() as inp:
        out = gpu.forward.bind(cpu.make_batch.bind(inp))
    t0 = time.perf_counter()
    dag = out.experimental_compile()
    compile_s = time.perf_counter() - t0
    try:
        for s in seeds:
            got = dag.execute(s).get(timeout=300)
            held(got, s, "execute")
            _require(_bit_equal(got["rows"], remote[s]["rows"]) and _bit_equal(got["last"], remote[s]["last"]),
                     f"[dag] seed {s}: the DAG's output differs from the same actor's .remote()")
        refs = [dag.execute(s) for s in seeds]  # all in flight before the first get
        for s, r in zip(seeds, refs):
            held(r.get(timeout=300), s, f"{len(seeds)} in flight")
        try:
            dag.execute(-1).get(timeout=300)
            raise AssertionError("[dag] the GPU stage's error did not reach get()")
        except ValueError as e:
            _require("refuses the batch of seed -1" in str(e), f"[dag] the stage's error arrived as {e!r}")
        held(dag.execute(0).get(timeout=300), 0, "after the error")
        dag_ms = []
        for i in range(DAG_ITERS):
            t0 = time.perf_counter()
            dag.execute(i % len(seeds)).get(timeout=300)
            dag_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        dag.teardown()
    facts = rt.get(gpu.facts.remote(), timeout=60)  # the loop has let go of the actor's thread
    per_iter = facts["launches"][n_remote:]
    n_dag = 2 * len(seeds) + 1 + DAG_ITERS
    _require(len(per_iter) == n_dag and all(n == cfg.num_layers for n in per_iter),
             f"[dag] forward launches per DAG iteration {per_iter}, expected {cfg.num_layers} in each of {n_dag}")
    _check_worker(facts, "[dag] GPU actor")
    _require(DEVICE == "cpu" or (facts["visible"] == "0" and facts["device_count"] == 1),
             f"[dag] the GPU actor sees CUDA_VISIBLE_DEVICES={facts['visible']!r}, "
             f"{facts['device_count']} card(s)")

    # An output over buffer_size_bytes ends the GPU stage's loop; get() names the writer's error.
    small = out.experimental_compile(buffer_size_bytes=DAG_SMALL_BUFFER)
    try:
        small.execute(0).get(timeout=300)
        raise AssertionError("[dag] an output over buffer_size_bytes was delivered")
    except AssertionError:
        raise
    except Exception as e:  # noqa: BLE001 - the writer's error, checked by name
        capacity_err = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        _require("ValueError" in capacity_err and "exceeds channel capacity" in capacity_err,
                 f"[dag] an oversized output failed get() with {capacity_err}")
    finally:
        small.teardown()

    # A no-op through the CPU actor, by DAG and by .remote() + get.
    with InputNode() as inp:
        noop = cpu.echo.bind(inp)
    noop_dag = noop.experimental_compile()
    try:
        noop_dag.execute(0).get(timeout=300)
        noop_dag_ms = []
        for i in range(DAG_ITERS):
            t0 = time.perf_counter()
            _require(noop_dag.execute(i).get(timeout=300) == i, "[dag] the no-op DAG returned another value")
            noop_dag_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        noop_dag.teardown()
    rt.get(cpu.echo.remote(0), timeout=60)
    noop_remote_ms = []
    for i in range(DAG_ITERS):
        t0 = time.perf_counter()
        rt.get(cpu.echo.remote(i), timeout=60)
        noop_remote_ms.append((time.perf_counter() - t0) * 1e3)

    # After teardown the card goes to a fresh one-GPU actor once the old one is gone.
    rt.kill(gpu)
    fresh = rt.get(rt.remote(num_gpus=1)(_CardHolder).remote().facts.remote(), timeout=300)
    _require(fresh["visible"] == "0" and (DEVICE == "cpu" or fresh["device_count"] == 1),
             f"[dag] a fresh one-GPU actor sees CUDA_VISIBLE_DEVICES={fresh['visible']!r}")
    _log("dag", f"{smi}: outputs of {len(seeds)} seeds bit-equal to the same actor's .remote() and to the "
                f"driver's forward, as CPU tensors; {len(seeds)} executions in flight in order; the GPU "
                f"stage's error reached get() and the DAG ran on; {cfg.num_layers} forward launches in each "
                f"of {n_dag} iterations (read after teardown); buffer_size_bytes={DAG_SMALL_BUFFER}: "
                f"get() raised {capacity_err[:160]!r}; a fresh one-GPU actor leased the card "
                f"(CUDA_VISIBLE_DEVICES={fresh['visible']!r})")
    _log("dag", f"{smi}: median of {DAG_ITERS} per iteration: forward by DAG {_pct(dag_ms, 0.5):.3f} ms, by "
                f".remote() + get {_pct(remote_ms, 0.5):.3f} ms; no-op by DAG {_pct(noop_dag_ms, 0.5):.3f} ms, "
                f"by .remote() + get {_pct(noop_remote_ms, 0.5):.3f} ms; compile {compile_s:.3f} s; first "
                f"{len(seeds)} .remote() forwards (actor starts included) {first_s:.3f} s")
    return {"launches": {"fwd": sum(per_iter), "dq": 0, "dkv": 0},
            "forward_ms": {"dag": _pct(dag_ms, 0.5), "remote": _pct(remote_ms, 0.5)},
            "noop_ms": {"dag": _pct(noop_dag_ms, 0.5), "remote": _pct(noop_remote_ms, 0.5)},
            "compile_s": compile_s, "capacity_error": capacity_err}


def _wf_marker(markers, tag):
    """Count one run of the step ``tag`` in its marker file; the count."""
    path = os.path.join(markers, tag)
    n = 1
    if os.path.exists(path):
        with open(path) as f:
            n = int(f.read()) + 1
    with open(path, "w") as f:
        f.write(str(n))
    return n


def _wf_init(state):
    """[workflow]'s first step (CPU): [train]'s initial weights."""
    return {"state": state, "facts": _card_facts()}


def _wf_train(init, cfg, tokens, steps, markers, device):
    """[workflow]'s train step (one card): [train]'s AdamW step on [train]'s
    batch, ``steps`` times, each kernel's launches counted per step."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import spmd

    runs = _wf_marker(markers, "train")
    dev = _card(device)
    model = gpt2.GPT2(cfg, dev)
    model.load_state_dict(init["state"])
    step = spmd.compile_train_step(gpt2.loss_fn, spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1))
    state = spmd.TrainState(0, model)
    batch = {"tokens": tokens.to(dev)}
    losses, launches = [], []
    for _ in range(steps):
        _flash_counts_zero(fa)
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        launches.append(_counts(fa))
    return {"state": {k: v.detach() for k, v in model.state_dict().items()}, "losses": losses,
            "launches": launches, "facts": _card_facts(), "runs": runs}


def _wf_eval(trained, cfg, tokens, markers, fail_once, device):
    """[workflow]'s eval step (one card): the trained weights' forward; with
    ``fail_once`` its first run raises (a marker file counts the runs)."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa

    runs = _wf_marker(markers, "eval")
    if fail_once and runs == 1:
        raise RuntimeError("[workflow] eval's first run fails on purpose")
    dev = _card(device)
    model = gpt2.GPT2(cfg, dev)
    model.load_state_dict(trained["state"])
    _flash_counts_zero(fa)
    rows, last = _rows_forward(model, tokens.to(dev))
    return {"rows": rows, "last": last, "launches": _counts(fa), "train_losses": trained["losses"],
            "train_launches": trained["launches"], "train_facts": trained["facts"],
            "facts": _card_facts(), "runs": runs}


def _wf_report(evaluated, tokens):
    """[workflow]'s last step (CPU): the eval's numbers, and where the batch
    bound into the DAG arrived."""
    return {**{k: v for k, v in evaluated.items() if k != "facts"}, "eval_facts": evaluated["facts"],
            "mean_loss": float(evaluated["rows"].mean()), "tokens_device": str(tokens.device),
            "facts": _card_facts()}


def _wf_dag(rt, cfg, state, tokens, markers, fail_once):
    gpu = {"num_gpus": 1, "max_retries": 0}
    init = rt.remote(num_gpus=0, max_retries=0)(_wf_init).bind(state)
    trained = rt.remote(**gpu)(_wf_train).bind(init, cfg, tokens, WF_TRAIN_STEPS, markers, DEVICE)
    evaluated = rt.remote(**gpu)(_wf_eval).bind(trained, cfg, tokens, markers, fail_once, DEVICE)
    return rt.remote(num_gpus=0, max_retries=0)(_wf_report).bind(evaluated, tokens)


# Run in a process without a card: every step file and get_output() must
# load there, as CPU tensors.
_WF_LOAD = r"""
import json, sys, torch
from ray_tpu_torch import workflow
from ray_tpu_torch.workflow import storage
wid, root = sys.argv[1], sys.argv[2]
st = storage.WorkflowStorage(wid, root)
devices = set()
def walk(x):
    if isinstance(x, torch.Tensor):
        devices.add(x.device.type)
    elif isinstance(x, dict):
        [walk(v) for v in x.values()]
    elif isinstance(x, (list, tuple)):
        [walk(v) for v in x]
    elif hasattr(x, "args") and hasattr(x, "kwargs"):
        [walk(v) for v in list(x.args) + list(x.kwargs.values())]
walk(st.load_dag())
for sid in st.completed_steps():
    walk(st.load_step(sid))
out = workflow.get_output(wid, storage=root)
print(json.dumps({"cuda": torch.cuda.is_available(), "devices": sorted(devices),
                  "steps": st.completed_steps(), "rows": out["rows"].tolist(),
                  "status": workflow.get_status(wid, storage=root)}))
"""


def phase_workflow(gpt2, cfg, tokens, train_out, smi):
    """[workflow]: init (CPU) -> train (card) -> eval (card) -> report (CPU)
    as a durable workflow; eval fails once and resume() reruns it alone."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.workflow import storage as wf_storage

    t0 = time.perf_counter()
    info = rt.init(num_cpus=RUNTIME_CPUS, log_to_driver=False)
    start_s = time.perf_counter() - t0
    root = os.path.join(info["session_dir"], "workflows")
    writes = []
    save_step, save_dag = wf_storage.WorkflowStorage.save_step, wf_storage.WorkflowStorage.save_dag

    def timed_step(self, step_id, value):
        t = time.perf_counter()
        save_step(self, step_id, value)
        writes.append((self.workflow_id, step_id, time.perf_counter() - t,
                       os.path.getsize(self._step_path(step_id))))

    def timed_dag(self, node):
        t = time.perf_counter()
        save_dag(self, node)
        writes.append((self.workflow_id, "dag.pkl", time.perf_counter() - t,
                       os.path.getsize(os.path.join(self.dir, "dag.pkl"))))

    wf_storage.WorkflowStorage.save_step, wf_storage.WorkflowStorage.save_dag = timed_step, timed_dag
    try:
        out = _workflow_checks(rt, gpt2, cfg, tokens, train_out, root, writes, smi)
    finally:
        wf_storage.WorkflowStorage.save_step, wf_storage.WorkflowStorage.save_dag = save_step, save_dag
        _shutdown_checked(rt, rt_api, "workflow")
        shutil.rmtree(root, ignore_errors=True)
    _log("workflow", f"shutdown(): no process of the driver remains; storage removed; cluster start "
                     f"{start_s:.3f} s")
    return out


def _workflow_checks(rt, gpt2, cfg, tokens, train_out, root, writes, smi):
    from ray_tpu_torch import workflow
    from ray_tpu_torch.workflow import storage as wf_storage

    _, state = _seed1_state(gpt2, cfg, DEVICE)
    markers, clean = os.path.join(root, "markers"), os.path.join(root, "markers_clean")
    os.makedirs(markers), os.makedirs(clean)
    wid = f"chip_smoke_wf_{os.getpid()}"
    # tokens is [train]'s batch on the card: a CUDA constant bound into the DAG
    t0 = time.perf_counter()
    try:
        workflow.run(_wf_dag(rt, cfg, state, tokens, markers, True), workflow_id=wid, storage=root)
        raise AssertionError("[workflow] eval's planned failure did not fail the run")
    except AssertionError:
        raise
    except Exception as e:  # noqa: BLE001 - the planned failure, checked by name
        _require("fails on purpose" in str(e), f"[workflow] the run failed with {e!r}")
    first_s = time.perf_counter() - t0
    _require(workflow.get_status(wid, storage=root) == workflow.FAILED, "[workflow] status after the failure")
    done_first = wf_storage.WorkflowStorage(wid, root).completed_steps()
    t0 = time.perf_counter()
    out = workflow.resume(wid, storage=root)
    resume_s = time.perf_counter() - t0
    runs = {tag: int(open(os.path.join(markers, tag)).read()) for tag in ("train", "eval")}
    _require(runs == {"train": 1, "eval": 2}, f"[workflow] step runs {runs}: resume reran train or not eval")
    _require(workflow.get_status(wid, storage=root) == workflow.SUCCEEDED, "[workflow] status after resume")
    t0 = time.perf_counter()
    clean_out = workflow.run(_wf_dag(rt, cfg, state, tokens, clean, False), workflow_id=wid + "_clean",
                             storage=root)
    clean_s = time.perf_counter() - t0
    for key in ("rows", "last"):
        _require(out[key].device.type == "cpu" and _bit_equal(out[key], clean_out[key]),
                 f"[workflow] the resumed run's {key} differ from an uninterrupted run's")
    _require(out["train_losses"] == clean_out["train_losses"] == train_out["losses"][:WF_TRAIN_STEPS],
             f"[workflow] train's losses {out['train_losses']} (uninterrupted {clean_out['train_losses']}) "
             f"are not [train]'s first {WF_TRAIN_STEPS} {train_out['losses'][:WF_TRAIN_STEPS]}")
    per_step = {"fwd": cfg.num_layers, "dq": cfg.num_layers, "dkv": cfg.num_layers}
    _require(all(c == per_step for c in out["train_launches"]),
             f"[workflow] train's launches per step {out['train_launches']}, expected {per_step}")
    _require(out["launches"] == {"fwd": cfg.num_layers, "dq": 0, "dkv": 0},
             f"[workflow] eval's launches {out['launches']}")
    for what, f in (("train", out["train_facts"]), ("eval", out["eval_facts"])):
        _check_worker(f, f"[workflow] {what} step")
        _require(f["visible"] == "0" and (DEVICE == "cpu" or f["device_count"] == 1),
                 f"[workflow] {what} sees CUDA_VISIBLE_DEVICES={f['visible']!r}, {f['device_count']} card(s)")
    _require(out["facts"]["visible"] == "", f"[workflow] report sees {out['facts']['visible']!r}")
    _require(out["tokens_device"] == "cpu", f"[workflow] the bound batch arrived on {out['tokens_device']}")

    # Everything on disk loads where no card is visible.
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", _WF_LOAD, wid, root], env=env, capture_output=True,
                          text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    _require(proc.returncode == 0, f"[workflow] loading without a card failed: {proc.stderr[-2000:]}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    _require(not loaded["cuda"] and loaded["devices"] == ["cpu"] and loaded["status"] == workflow.SUCCEEDED
             and loaded["rows"] == out["rows"].tolist(),
             f"[workflow] without a card: cuda {loaded['cuda']}, tensor devices {loaded['devices']}, "
             f"status {loaded['status']}, rows equal {loaded['rows'] == out['rows'].tolist()}")
    launches = {k: sum(c[k] for c in out["train_launches"]) + out["launches"][k] for k in per_step}
    mine = [w for w in writes if w[0] == wid]
    _log("workflow", f"{smi}: the first run failed at eval with {len(done_first)} steps checkpointed "
                     f"({', '.join(done_first)}) in {first_s:.3f} s; resume() {resume_s:.3f} s ran eval and "
                     f"report only (markers train 1, eval 2) and equals an uninterrupted run ({clean_s:.3f} s) "
                     f"bit for bit; train's losses {out['train_losses']} are [train]'s first "
                     f"{WF_TRAIN_STEPS}; launches: train {per_step} a step, eval {out['launches']}")
    _log("workflow", f"{smi}: without a card (CUDA_VISIBLE_DEVICES=''): get_output() and {len(loaded['steps'])} "
                     f"step files load, tensors on {loaded['devices']}; checkpoints: " + ", ".join(
                         f"{sid} {nbytes} B in {s:.3f} s ({nbytes / s / 1e9:.3f} GB/s)" for _, sid, s, nbytes in mine))
    return {"launches": launches, "first_run_s": first_s, "resume_s": resume_s, "clean_run_s": clean_s,
            "checkpoints": [{"step": sid, "bytes": nbytes, "write_s": s} for _, sid, s, nbytes in mine],
            "train_losses": out["train_losses"], "mean_loss": out["mean_loss"]}


def _cluster_forward(refs, cfg, tokens, q, hold_s, device):
    """[cluster]'s GPU task: GPT-2-124M on its node's card, one counted
    forward whose per-row losses and facts go into ``q``; then forwards
    until its node is removed (or ``hold_s`` passes)."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import flash_attention as fa

    dev = _card(device)
    _, model = _build_gpt2(ray_tpu_torch.get(refs[0]), cfg, dev)
    x = tokens.to(dev)
    fa.flash_attention_fwd.launches = 0
    rows, last = _rows_forward(model, x)
    launches = fa.flash_attention_fwd.launches
    q.put({**_card_facts(), "node_id": ray_tpu_torch.get_runtime_context().node_id,
           "rows": rows, "last": last, "launches": launches})
    t0 = time.monotonic()
    while time.monotonic() - t0 < hold_s:
        _rows_forward(model, x)
    return "held to the end"


def _cluster_probe():
    import ray_tpu_torch

    return {**_card_facts(), "node_id": ray_tpu_torch.get_runtime_context().node_id}


def _gpu_of(row, key):
    return row[key].get("GPU", 0.0)


def phase_cluster(gpt2, cfg, tokens, smi):
    """[cluster]: a head of 2 CPUs and no card, a node of 2 CPUs and the
    card; the driver attached by util.client.connect; the card's task,
    queue, state rows, stacks; the node's death, a pending lease, the card
    handed to a new node."""
    from ray_tpu_torch.cluster_utils import Cluster

    t0 = time.perf_counter()
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    try:
        out = _cluster_checks(cluster, gpt2, cfg, tokens, t0, smi)
    finally:
        import ray_tpu_torch as rt

        if rt.is_initialized():
            rt.shutdown()
        cluster.shutdown()
        deadline = time.monotonic() + 15
        while _descendants(os.getpid()) and time.monotonic() < deadline:
            time.sleep(0.1)
    left = {p: _cmdline(p) for p in _descendants(os.getpid())}
    _require(not left, f"[cluster] processes left after shutdown: {left}")
    _log("cluster", "disconnect() and Cluster.shutdown(): no process of the driver remains")
    return out


def _cluster_checks(cluster, gpt2, cfg, tokens, t_start, smi):
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import client, events
    from ray_tpu_torch.util import state as rt_state
    from ray_tpu_torch.util.queue import Queue

    gpu_node = cluster.add_node(num_cpus=2, num_gpus=1)
    try:
        cluster.add_node(num_cpus=1, num_gpus=1)
        raise AssertionError("[cluster] a second one-card node was added on a one-card host")
    except ValueError as e:
        second_err = str(e)
    ctx = client.connect(cluster.address)
    cluster.wait_for_nodes()
    start_s = time.perf_counter() - t_start
    nodes = {n["node_id"]: n for n in rt_state.list_nodes() if n["alive"]}
    gpus = {nid[:12]: _gpu_of(n, "resources_total") for nid, n in nodes.items()}
    _require(len(nodes) == 2 and gpus[gpu_node.node_id[:12]] == 1 and sum(gpus.values()) == 1,
             f"[cluster] GPUs by node {gpus}: expected 1 on the GPU node only")
    before = rt_state.summarize()
    _require(before["resources_total"].get("GPU") == 1 and before["resources_available"].get("GPU") == 1,
             f"[cluster] summarize() before the task: {before}")

    model, state = _seed1_state(gpt2, cfg, DEVICE)
    want_rows, want_last = (t.cpu() for t in _rows_forward(model, tokens.to(DEVICE)))
    del model
    ref = rt.put(state)
    q = Queue()
    t0 = time.perf_counter()
    fut = rt.remote(num_gpus=1, max_retries=0)(_cluster_forward).remote(
        [ref], cfg, tokens.cpu(), q, CLUSTER_HOLD_S, DEVICE)
    got = q.get(timeout=600)
    first_s = time.perf_counter() - t0
    # The task holds the card: its lease, its stacks, and a second GPU task
    # that pends (queued while a GPU node lives: this runtime, as the JAX
    # package's, refuses at once a lease that no live node could ever hold).
    during = rt_state.summarize()
    lease_row = {n["node_id"]: n for n in rt_state.list_nodes()}[gpu_node.node_id]
    workers = [w for w in rt_state.list_workers([("node_id", "=", gpu_node.node_id)])
               if w["num_running_tasks"] > 0]
    _require(len(workers) == 1, f"[cluster] busy workers on the GPU node: {workers}")
    stacks = rt_state.worker_stacks(workers[0]["worker_id"])
    _require(during["resources_available"].get("GPU", 0.0) == 0
             and _gpu_of(lease_row, "resources_available") == 0,
             f"[cluster] the lease does not show while the task runs: {during['resources_available']}, "
             f"{lease_row['resources_available']}")
    stack_text = "\n".join(stacks["stacks"].values())
    _require("_cluster_forward" in stack_text and stacks["pid"] == got["pid"],
             f"[cluster] the GPU worker's stacks (pid {stacks['pid']}) do not show the task")
    _check_worker(got, "[cluster] GPU task")
    _require(got["node_id"] == gpu_node.node_id, f"[cluster] the GPU task ran on {got['node_id'][:12]}")
    _require(got["visible"] == gpu_node.gpus[0] and (DEVICE == "cpu" or got["device_count"] == 1),
             f"[cluster] the GPU task sees CUDA_VISIBLE_DEVICES={got['visible']!r}, {got['device_count']} card(s)")
    _require(got["launches"] == cfg.num_layers, f"[cluster] forward launches {got['launches']}")
    rows = got["rows"]
    _require(rows.device.type == "cpu" and _bit_equal(rows, want_rows) and _bit_equal(got["last"], want_last),
             f"[cluster] the task's per-row losses (through the queue) differ from the driver's: max |d| "
             f"{(rows - want_rows).abs().max().item():.3g}")
    pending = rt.remote(num_gpus=1)(_cluster_probe).remote()

    def still_pending(what):
        ready, _ = rt.wait([pending], timeout=2.0)
        _require(not ready, f"[cluster] the second GPU task ran {what}")
        deadline, waiting = time.monotonic() + 20, 0
        while not waiting and time.monotonic() < deadline:
            waiting = rt_state.summarize()["pending_leases"]
            time.sleep(0.2)
        _require(waiting >= 1, f"[cluster] no pending lease {what}")
        return waiting

    waiting = still_pending("while the first held the card")

    # The node dies under the first task: its death is an event, the second
    # task still pends, and a new node takes the card back and runs it.
    t0 = time.perf_counter()
    # A hard kill: a graceful one stops the node's workers first, and the
    # GCS can grant the queued lease on the node while it shuts down
    # (ROADMAP C).
    cluster.remove_node(gpu_node, allow_graceful=False)
    deadline = time.monotonic() + 60
    death = []
    while not death and time.monotonic() < deadline:
        death = [e for e in events.list_events() if e.get("node_id") == gpu_node.node_id
                 and "node died" in e["message"]]
        time.sleep(0.2)
    _require(death, "[cluster] no event records the GPU node's death")
    death_s = time.perf_counter() - t0
    try:
        rt.get(fut, timeout=120)
        raise AssertionError("[cluster] the GPU task outlived its node")
    except AssertionError:
        raise
    except Exception as e:  # noqa: BLE001 - the node's death, as the task's error
        lost = type(e).__name__
    deadline = time.monotonic() + 30
    while _alive(got["pid"]) and time.monotonic() < deadline:
        time.sleep(0.1)
    _require(not _alive(got["pid"]), f"[cluster] the GPU worker (pid {got['pid']}) outlived its node")
    waiting_after = still_pending("with no GPU node in the cluster")
    t0 = time.perf_counter()
    new_node = cluster.add_node(num_cpus=2, num_gpus=1)
    moved = rt.get(pending, timeout=300)
    handoff_s = time.perf_counter() - t0
    _require(new_node.gpus == gpu_node.gpus and moved["node_id"] == new_node.node_id
             and moved["visible"] == new_node.gpus[0],
             f"[cluster] the pending task ran on {moved['node_id'][:12]} with CUDA_VISIBLE_DEVICES="
             f"{moved['visible']!r}; the new node has cards {new_node.gpus}")
    ctx.disconnect()
    _log("cluster", f"{smi}: head (2 CPUs, no card) and a node with card {gpu_node.gpus} up and the driver "
                    f"connected in {start_s:.3f} s; a second one-card node refused: {second_err!r}")
    _log("cluster", f"{smi}: the GPU task on its node (CUDA_VISIBLE_DEVICES={got['visible']!r}) ran the "
                    f"forward ({got['launches']} launches) {first_s:.3f} s after submit (worker start and "
                    f"weights included); per-row losses through the queue bit-equal to the driver's; "
                    f"summarize() GPU {before['resources_available'].get('GPU')} -> "
                    f"{during['resources_available'].get('GPU', 0.0)} available while it ran; its worker's "
                    f"stacks name the task")
    _log("cluster", f"{smi}: a second GPU task pended ({waiting} pending lease(s)); remove_node: death "
                    f"recorded in {death_s:.3f} s, the first task lost ({lost}), the second still pending "
                    f"({waiting_after}); it ran on the new node's card {new_node.gpus} {handoff_s:.3f} s "
                    f"after add_node")
    return {"launches": {"fwd": got["launches"], "dq": 0, "dkv": 0}, "start_s": start_s,
            "first_task_s": first_s, "death_event_s": death_s, "handoff_s": handoff_s}


JOB_TIMEOUT_S = 300
AUTOSCALE_IDLE_S = 2.0  # [autoscale]: idle seconds before a drain
AUTOSCALE_PASS_S = 0.2  # [autoscale]: seconds between reconcile passes


def _cli(args, env):
    """``python -m ray_tpu_torch <args>`` from the checkout's root."""
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=120)


def _session_pids(session_dir):
    """Live processes of a runtime session: those naming its dir on the
    command line (GCS, raylet) or in RT_SESSION_DIR (workers)."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{d}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue
        if (session_dir.encode() in cmd or f"RT_SESSION_DIR={session_dir}\0".encode() in env) and _alive(int(d)):
            pids.append(int(d))
    return pids


def job_driver(workdir):
    """[job]'s submitted driver: attach to the cluster the job runs in,
    build GPT-2-124M on the card the head gave this process from the
    weights the phase wrote, run one counted flash forward, and print the
    card's name, per-row losses and launches; the rows and the last
    position's logits go to a file for the bit-for-bit check."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import flash_attention as fa

    ray_tpu_torch.init(address=os.environ["RT_ADDRESS"], log_to_driver=False)
    try:
        cluster_gpus = ray_tpu_torch.cluster_resources().get("GPU")
        inputs = torch.load(os.path.join(workdir, "job_inputs.pt"), weights_only=False)
        dev = _card(inputs["device"])
        _, model = _build_gpt2(inputs["state"], inputs["cfg"], dev)
        fa.flash_attention_fwd.launches = 0
        rows, last = _rows_forward(model, inputs["tokens"].to(dev))
        launches = fa.flash_attention_fwd.launches
        torch.save({"rows": rows.cpu(), "last": last.cpu()}, os.path.join(workdir, "job_result.pt"))
        card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
        print("JOB " + json.dumps({**_worker_facts(), "card": card, "cluster_gpus": cluster_gpus,
                                   "rows": rows.tolist(), "launches": launches}), flush=True)
    finally:
        ray_tpu_torch.shutdown()
    return 0


def _get_json(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read().decode())


def phase_job(gpt2, cfg, tokens, smi):
    """[job]: a CLI-started head with the card, a job's driver running
    GPT-2-124M's forward there, the job and the head's card through the
    CLI and the dashboard, then `stop`."""
    t_start = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="rt_job_")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = workdir  # the CLI session's file and dirs are the phase's own
    session = None
    try:
        out = _cli(["start", "--head", "--num-cpus", "4", "--num-gpus", "1"], env)
        _require(out.returncode == 0, f"[job] start failed: {out.stderr[-2000:]}")
        with open(os.path.join(workdir, "ray_tpu_torch", "latest_cli_session.json")) as f:
            session = json.load(f)
        start_s = time.perf_counter() - t_start
        out_ = _job_checks(gpt2, cfg, tokens, env, workdir, session, out.stdout, smi)
        t0 = time.perf_counter()
        out = _cli(["stop"], env)
        _require(out.returncode == 0 and "stopped 2 control-plane processes" in out.stdout,
                 f"[job] stop: {out.stdout} {out.stderr[-2000:]}")
        deadline = time.monotonic() + 30
        while _session_pids(session["session_dir"]) and time.monotonic() < deadline:
            time.sleep(0.1)
        left = {p: _cmdline(p) for p in _session_pids(session["session_dir"])}
        _require(not left, f"[job] processes of the CLI session left after stop: {left}")
        stop_s = time.perf_counter() - t0
        session = None
    finally:
        if session is not None:  # a failed phase: take the session down all the same
            _cli(["stop"], env)
            for pid in _session_pids(session["session_dir"]):
                os.kill(pid, 9)
    _log("job", f"{smi}: head started by the CLI in {start_s:.3f} s; stop took {stop_s:.3f} s and left no "
                f"process of the session; [job] {time.perf_counter() - t_start:.1f} s in all")
    return {**out_, "start_s": start_s, "stop_s": stop_s}


def _job_checks(gpt2, cfg, tokens, env, workdir, session, started, smi):
    import ray_tpu_torch as rt
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.job_submission import SUCCEEDED, JobSubmissionClient

    addr = session["gcs_address"]
    cards = re.findall(r"GPUs: +1 \(cards: ([^,)]+)\)", started)
    _require(len(cards) == 1, f"[job] the head did not record its one card: {started}")
    model, state = _seed1_state(gpt2, cfg, DEVICE)
    want_rows, want_last = (t.cpu() for t in _rows_forward(model, tokens.to(DEVICE)))
    del model
    t0 = time.perf_counter()
    torch.save({"state": state, "cfg": cfg, "tokens": tokens.cpu(), "device": DEVICE},
               os.path.join(workdir, "job_inputs.pt"))
    write_s = time.perf_counter() - t0
    del state
    client = JobSubmissionClient(addr)
    t0 = time.perf_counter()
    job = client.submit_job(entrypoint=f"{sys.executable} {os.path.abspath(__file__)} --job-driver {workdir}",
                            metadata={"phase": "job"})
    status = client.wait_until_finished(job, timeout=JOB_TIMEOUT_S)
    job_s = time.perf_counter() - t0
    logs = client.get_job_logs(job)
    _require(status == SUCCEEDED, f"[job] the job ended {status}; its log:\n{logs[-4000:]}")
    (line,) = [ln for ln in logs.splitlines() if ln.startswith("JOB ")]
    got = json.loads(line[4:])
    result = torch.load(os.path.join(workdir, "job_result.pt"))
    card = torch.cuda.get_device_name(0) if DEVICE == "cuda" else "cpu"
    _require(got["card"] == card and got["visible"] == cards[0] and not got["foreign"],
             f"[job] the driver ran on {got['card']!r} with CUDA_VISIBLE_DEVICES={got['visible']!r}, "
             f"loaded {got['foreign']}")
    _require(got["launches"] == cfg.num_layers, f"[job] forward launches {got['launches']}")
    _require(_bit_equal(result["rows"], want_rows) and _bit_equal(result["last"], want_last)
             and got["rows"] == want_rows.tolist(),
             f"[job] the job's per-row losses differ from the driver's: max |d| "
             f"{(result['rows'] - want_rows).abs().max().item():.3g}")
    # The CLI and the dashboard on the same cluster.
    status_out = _cli(["status", "--address", addr], env)
    _require(status_out.returncode == 0 and "/1 GPU" in status_out.stdout,
             f"[job] status: {status_out.stdout} {status_out.stderr[-2000:]}")
    out = _cli(["list", "nodes", "--address", addr], env)
    nodes = json.loads(out.stdout) if out.returncode == 0 else out.stderr
    _require(isinstance(nodes, list) and len(nodes) == 1 and nodes[0]["resources_total"].get("GPU") == 1,
             f"[job] list nodes: {nodes}")
    t0 = time.perf_counter()
    rt.init(address=addr, log_to_driver=False)
    try:
        url = start_dashboard(port=0)
        dash_jobs = {j["submission_id"]: j for j in _get_json(f"{url}/api/jobs")}
        dash_nodes = _get_json(f"{url}/api/nodes")
        page = urllib.request.urlopen(f"{url}/nodes", timeout=60).read().decode()
        stop_dashboard()
    finally:
        rt.shutdown()
    dash_s = time.perf_counter() - t0
    _require(dash_jobs.get(job, {}).get("status") == SUCCEEDED, f"[job] /api/jobs: {dash_jobs}")
    _require(len(dash_nodes) == 1 and dash_nodes[0]["resources_total"].get("GPU") == 1
             and "&quot;GPU&quot;: 1" in page, f"[job] /api/nodes: {dash_nodes}")
    _log("job", f"{smi}: job {job} SUCCEEDED {job_s:.3f} s after submit (driver start, attach, torch import, "
                f"weights read, model build and forward; the weights file was written in {write_s:.3f} s); "
                f"its log names the card {got['card']!r} (CUDA_VISIBLE_DEVICES={got['visible']!r}, cluster "
                f"GPU {got['cluster_gpus']}); {got['launches']} forward launches; per-row losses and last "
                f"logits bit-equal to the driver's: {['%.6f' % r for r in got['rows']]}")
    _log("job", f"{smi}: `status` shows {[ln.strip() for ln in status_out.stdout.splitlines() if 'GPU' in ln]} "
                f"and `list nodes` GPU {nodes[0]['resources_total'].get('GPU')} on the head; the dashboard "
                f"(started, read and stopped in {dash_s:.3f} s) shows the job {dash_jobs[job]['status']} "
                f"and the head's GPU {dash_nodes[0]['resources_total'].get('GPU')}")
    return {"launches": {"fwd": got["launches"], "dq": 0, "dkv": 0}, "job_s": job_s, "weights_write_s": write_s,
            "dashboard_s": dash_s}


def _autoscale_forward(refs, cfg, tokens, device):
    """[autoscale]'s task: GPT-2-124M on the card of the node launched for
    it, one counted forward."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import flash_attention as fa

    dev = _card(device)
    _, model = _build_gpt2(ray_tpu_torch.get(refs[0]), cfg, dev)
    fa.flash_attention_fwd.launches = 0
    rows, last = _rows_forward(model, tokens.to(dev))
    return {**_card_facts(), "node_id": ray_tpu_torch.get_runtime_context().node_id,
            "node_cards": os.environ.get("RT_GPU_VISIBLE_DEVICES"), "rows": rows.cpu(), "last": last.cpu(),
            "launches": fa.flash_attention_fwd.launches}


class _Reconciler(threading.Thread):
    """Runs an Autoscaler's reconcile passes every ``interval`` s on a
    loop of its own until stopped; the first error ends it and is kept
    (the monitor's own loop logs and goes on)."""

    def __init__(self, scaler, interval):
        super().__init__(daemon=True)
        self.scaler, self.interval = scaler, interval
        self.stopped, self.passes, self.error = threading.Event(), 0, None

    def run(self):
        import asyncio

        from ray_tpu_torch.core import rpc

        async def go():
            self.scaler.gcs = rpc.ReconnectingConnection(self.scaler.gcs_address, name="autoscaler->gcs")
            try:
                while not self.stopped.is_set():
                    await self.scaler.reconcile()
                    self.passes += 1
                    await asyncio.sleep(self.interval)
            finally:
                await self.scaler.gcs.close()

        try:
            asyncio.run(go())
        except BaseException as e:  # noqa: BLE001 - kept, and raised by the phase
            self.error = e

    def check(self):
        _require(self.error is None and self.is_alive(), f"[autoscale] the reconcile passes failed: {self.error!r}")


def phase_autoscale(gpt2, cfg, tokens, smi):
    """[autoscale]: a one-GPU node type scaled up for a pending one-card
    task, then drained and removed once idle."""
    from ray_tpu_torch.autoscaler import Autoscaler, AutoscalerConfig, LocalSubprocessProvider, NodeTypeConfig
    from ray_tpu_torch.cluster_utils import Cluster

    t0 = time.perf_counter()
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    provider = LocalSubprocessProvider(cluster.gcs_address, cluster.session_dir)
    scaler = Autoscaler(cluster.gcs_address, provider, AutoscalerConfig(
        node_types=[NodeTypeConfig("gpu1", {"CPU": 2, "GPU": 1}, min_workers=0, max_workers=1)],
        idle_timeout_s=AUTOSCALE_IDLE_S, interval_s=AUTOSCALE_PASS_S))
    passes = _Reconciler(scaler, AUTOSCALE_PASS_S)
    try:
        out = _autoscale_checks(cluster, provider, passes, gpt2, cfg, tokens, t0, smi)
    finally:
        import ray_tpu_torch as rt

        passes.stopped.set()
        if passes.is_alive():
            passes.join(timeout=30)
        provider.shutdown()
        if rt.is_initialized():
            rt.shutdown()
        cluster.shutdown()
        deadline = time.monotonic() + 15
        while _descendants(os.getpid()) and time.monotonic() < deadline:
            time.sleep(0.1)
    left = {p: _cmdline(p) for p in _descendants(os.getpid())}
    _require(not left, f"[autoscale] processes left after shutdown: {left}")
    _log("autoscale", f"[autoscale] {time.perf_counter() - t0:.1f} s in all; no process of the driver remains")
    return out


def _autoscale_checks(cluster, provider, passes, gpt2, cfg, tokens, t_start, smi):
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import state as rt_state

    cluster.connect()
    _require(not rt.cluster_resources().get("GPU"), "[autoscale] the head has a card")
    model, state = _seed1_state(gpt2, cfg, DEVICE)
    want_rows, want_last = (t.cpu() for t in _rows_forward(model, tokens.to(DEVICE)))
    del model
    ref = rt.put(state)
    del state
    passes.start()
    deadline = time.monotonic() + 30
    while not passes.passes and time.monotonic() < deadline:  # the node type reported to the GCS
        passes.check()
        time.sleep(0.05)
    passes.check()
    start_s = time.perf_counter() - t_start
    t_demand = time.perf_counter()
    fut = rt.remote(num_gpus=1, max_retries=0)(_autoscale_forward).remote([ref], cfg, tokens.cpu(), DEVICE)
    nodes, waiting = [], 0
    deadline = time.monotonic() + 120
    while not nodes and time.monotonic() < deadline:
        passes.check()
        waiting = max(waiting, rt_state.summarize()["pending_leases"])
        nodes = provider.non_terminated_nodes()
        time.sleep(0.05)
    launch_s = time.perf_counter() - t_demand
    _require(len(nodes) == 1 and nodes[0].node_type == "gpu1", f"[autoscale] nodes launched: {nodes}")
    _require(waiting >= 1, "[autoscale] the one-card task never pended")
    node = nodes[0]
    got = rt.get(fut, timeout=600)
    first_s = time.perf_counter() - t_demand
    passes.check()
    _check_worker(got, "[autoscale] GPU task")
    _require(got["node_id"] == node.node_id_hex and got["visible"] == node.meta["gpus"][0] == got["node_cards"]
             and (DEVICE == "cpu" or got["device_count"] == 1),
             f"[autoscale] the task ran on {got['node_id'][:12]} with CUDA_VISIBLE_DEVICES={got['visible']!r} "
             f"(node cards {got['node_cards']!r}); the launched node {node.node_id_hex[:12]} has {node.meta}")
    _require(got["launches"] == cfg.num_layers, f"[autoscale] forward launches {got['launches']}")
    _require(_bit_equal(got["rows"], want_rows) and _bit_equal(got["last"], want_last),
             f"[autoscale] the task's per-row losses differ from the driver's: max |d| "
             f"{(got['rows'] - want_rows).abs().max().item():.3g}")
    deadline = time.monotonic() + 120
    while provider.non_terminated_nodes() and time.monotonic() < deadline:
        passes.check()
        time.sleep(0.1)
    removed_s = time.perf_counter() - t_demand
    passes.check()
    _require(not provider.non_terminated_nodes(), "[autoscale] the idle GPU node was never removed")
    deadline = time.monotonic() + 30
    while True:  # the GCS sees the terminated raylet's death
        row = {n["node_id"]: n for n in rt_state.list_nodes()}[node.node_id_hex]
        if not row["alive"] or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    after = rt_state.summarize()
    _require(not row["alive"] and after["pending_leases"] == 0 and not after["resources_total"].get("GPU"),
             f"[autoscale] after the drain: node alive {row['alive']}, {after['pending_leases']} pending, "
             f"{after['resources_total']}")
    _log("autoscale", f"{smi}: head (2 CPUs, no card) up and the first pass made in {start_s:.3f} s; a "
                      f"num_gpus=1 task pended ({waiting} lease(s)); node {node.node_id_hex[:12]} with card "
                      f"{node.meta['gpus']} launched {launch_s:.3f} s after the demand; the task's forward "
                      f"({got['launches']} launches, CUDA_VISIBLE_DEVICES={got['visible']!r}) returned "
                      f"{first_s:.3f} s after it, per-row losses bit-equal to the driver's; the idle node "
                      f"was drained and removed {removed_s:.3f} s after it ({passes.passes} passes, idle "
                      f"timeout {AUTOSCALE_IDLE_S} s), no lease pending")
    return {"launches": {"fwd": got["launches"], "dq": 0, "dkv": 0}, "start_s": start_s,
            "demand_to_launch_s": launch_s, "demand_to_first_task_s": first_s,
            "demand_to_removal_s": removed_s}


def _moe_hook(gpt2, record):
    """Wraps gpt2._moe_mlp so that each call records its input and its
    routing: (h, tokens routed, tokens past capacity).  Returns the
    original to restore."""
    orig = gpt2._moe_mlp

    def wrapped(h, router, moe_in, moe_out, config, mask=None, **mesh):
        with torch.no_grad():
            _, _, _, onehot, pos = gpt2.moe_route(h, router, config, mask)
            C = gpt2.moe_capacity(config, h.shape[1])
            record.append((h.detach(), int(onehot.sum()), int(((pos >= C) & (onehot > 0)).sum())))
        return orig(h, router, moe_in, moe_out, config, mask, **mesh)

    gpt2._moe_mlp = wrapped
    return orig


def phase_moe_block(gpt2, model, layer, h):
    """One block's _moe_mlp on the card in f32 against the CPU's, on ``h``:
    the features that reached that block's MoE in the model's forward over
    [moe]'s tokens (bf16 values, exact in f32), so that the comparison
    covers the routing of the model's own features and the tokens that
    overflow their expert."""
    cfg = dataclasses.replace(model.config, dtype=torch.float32)
    blk = model.blocks[layer]
    B, S, E = h.shape
    h = h.float()
    weights = [blk.router.detach(), blk.moe_in.detach(), blk.moe_out.detach()]
    with torch.no_grad():
        probs, _, expert, onehot, pos = gpt2.moe_route(h, weights[0], cfg)
        out, aux = gpt2._moe_mlp(h, *weights, cfg)
        h_c, w_c = h.cpu(), [w.cpu() for w in weights]
        probs_c, _, expert_c, onehot_c, pos_c = gpt2.moe_route(h_c, w_c[0], cfg)
        out_c, aux_c = gpt2._moe_mlp(h_c, *w_c, cfg)
        # How far one direction per row decides the routing: the expert the
        # row's mean feature would choose, against each token's.
        expert_of_mean = torch.argmax(h_c.mean(dim=1) @ w_c[0].float(), dim=-1)
    top2 = probs_c.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= MOE_MARGIN
    expert, pos, out = expert.cpu(), pos.cpu().amax(-1), out.cpu()
    pos_c = pos_c.amax(-1)
    flipped = near & (expert != expert_c)
    rows = ~flipped.any(dim=1, keepdim=True).expand(B, S)  # rows no flip moved
    clear = ~near
    _require(torch.equal(expert[clear], expert_c[clear]),
             f"{int((expert[clear] != expert_c[clear]).sum())} tokens clear of a tie chose another expert")
    _require(torch.equal(pos[rows], pos_c[rows]), "a token's capacity slot differs from the CPU's")
    keep = clear & rows
    d = (out[keep] - out_c[keep]).abs().max().item()
    torch.testing.assert_close(out[keep], out_c[keep], **MOE_TOL)
    C = gpt2.moe_capacity(cfg, S)
    over = pos_c >= C
    compared_over = int((over & keep).sum())
    _require(compared_over > 0, f"no token past capacity among the compared ones (C = {C})")
    with_mean = float((expert_c == expert_of_mean[:, None]).float().mean())
    busiest = float(onehot_c.sum(dim=1).amax(dim=-1).mean() / S)
    _log("moe", f"layer {layer}'s _moe_mlp on its own features over [moe]'s tokens, ({B}, {S}, {E}) f32, card "
                f"against CPU: {int(near.sum())} of {B * S} tokens within {MOE_MARGIN} of a tie "
                f"({int(flipped.sum())} chose another expert, {int((~rows[:, 0]).sum())} rows left out of the "
                f"slot check); experts and slots equal elsewhere; output max |d| {d:.3g}; aux {aux.item():.6f} "
                f"vs {aux_c.item():.6f}; C = {C}, {float(over.float().mean()):.4f} of tokens past capacity "
                f"({compared_over} of them compared)")
    _log("moe", f"layer {layer}: {with_mean:.4f} of tokens choose the expert their row's mean feature "
                f"chooses (1/{cfg.num_experts} = {1 / cfg.num_experts:.4f} if unrelated); the busiest expert "
                f"of a row takes {busiest:.4f} of its tokens (mean over rows)")
    return {"layer": layer, "near_ties": int(near.sum()), "flipped": int(flipped.sum()), "max_abs": d,
            "over_compared": compared_over, "with_row_mean": with_mean, "busiest_share": busiest}


def phase_moe(fa, gpt2, spmd, tokens, cfg):
    """[moe]: GPT-2 with experts (``cfg``) at ``tokens``' batch, trained on
    DEVICE."""
    tokens = tokens.to(DEVICE)
    model = gpt2.init(cfg, torch.Generator(device=DEVICE).manual_seed(6), DEVICE)
    record = []
    orig = _moe_hook(gpt2, record)
    try:
        with torch.no_grad():
            _, aux0 = model.features_aux(tokens[:, :-1])
    finally:
        gpt2._moe_mlp = orig
    per_layer = [o / r for _, r, o in record]
    routed, over = sum(r for _, r, _ in record), sum(o for _, _, o in record)
    layer = max(range(len(record)), key=lambda i: per_layer[i])
    _log("moe", "tokens past capacity at init by layer: " + " ".join(f"{x:.4f}" for x in per_layer))
    block = phase_moe_block(gpt2, model, layer, record[layer][0])
    del record
    batch = {"tokens": tokens}
    step = spmd.compile_train_step(gpt2.loss_fn, spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1))
    state = spmd.TrainState(0, model)
    losses, samples = [], []
    torch.cuda.reset_peak_memory_stats()
    _flash_counts_zero(fa)
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        before = _counts(fa)
        _sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        samples.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: v - before[k] for k, v in _counts(fa).items()}
        _require(all(n == cfg.num_layers for n in per_step.values()),
                 f"[moe] step {i}: launches {per_step}, expected {cfg.num_layers} of each")
    launches = _counts(fa)
    peak = torch.cuda.max_memory_allocated() / 2**30
    record = []
    orig = _moe_hook(gpt2, record)
    try:
        with torch.no_grad():
            model.features_aux(tokens[:, :-1])
    finally:
        gpt2._moe_mlp = orig
    routed1, over1 = sum(r for _, r, _ in record), sum(o for _, _, o in record)
    del record
    ms = _spread(samples[TRAIN_WARMUP:])[0]
    busy = phase_profile(lambda: step(state, batch), "one [moe] step", ms, top=8) if DEVICE == "cuda" else None
    aux0 = aux0.item()
    want0 = math.log(cfg.vocab_size) + cfg.moe_aux_coeff * aux0
    _require(all(math.isfinite(x) for x in losses), f"[moe] non-finite loss: {losses}")
    _require(abs(losses[0] - want0) < LOSS_WINDOW, f"[moe] first loss {losses[0]}, expected about {want0}")
    _require(losses[-1] < losses[0] - 0.1, f"[moe] loss did not fall: {losses}")
    ms, q25, q75 = _spread(samples[TRAIN_WARMUP:])
    n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
    flops = gpt2.flops_per_token(cfg, tokens.shape[1] - 1) * n_tokens
    _log("moe", f"GPT-2-124M with {cfg.num_experts} experts: {gpt2.num_params(cfg) / 1e6:.1f} M parameters, "
                f"capacity factor {cfg.moe_capacity_factor} (C = {gpt2.moe_capacity(cfg, tokens.shape[1] - 1)}), "
                f"aux at init {aux0:.4f} over {cfg.num_layers} layers ({aux0 / cfg.num_layers:.4f} a layer)")
    _log("moe", "loss " + " ".join(f"{x:.4f}" for x in losses))
    _log("moe", f"tokens past capacity: {over / routed:.4f} of {routed} routings at init, {over1 / routed1:.4f} "
                f"after {len(losses)} steps; kernel launches {launches} ({cfg.num_layers} of each per step)")
    _log("moe", f"step {ms:.3f} ms (median of {TRAIN_STEPS}, quartiles {q25:.3f}..{q75:.3f}), "
                f"{n_tokens / ms * 1e3:.0f} tokens/s, {flops / 1e12:.3f} TFLOP per step (active experts) -> "
                f"{flops / (ms / 1e3) / BF16_FLOPS:.4f} of the bf16 peak; peak memory {peak:.2f} GiB")
    return {"launches": launches, "step_ms": ms, "tokens_per_s": n_tokens / ms * 1e3,
            "peak_share": flops / (ms / 1e3) / BF16_FLOPS, "peak_gib": peak, "aux0": aux0, "busy_ms": busy,
            "dropped_init": over / routed, "dropped_end": over1 / routed1, "losses": losses, "block": block}


def phase_vit(fa, vit, smi, cfg):
    """[vit]: the ViT of ``cfg`` (ViT-B/16: bf16 compute, f32 params,
    remat) at B=VIT_BATCH on DEVICE."""
    from ray_tpu_torch.parallel import spmd

    device = DEVICE
    g = torch.Generator(device=device).manual_seed(7)
    model = vit.init(cfg, g, device)
    images = torch.randn((VIT_BATCH, cfg.image_size, cfg.image_size, cfg.channels), generator=g, device=device)
    labels = torch.randint(0, cfg.num_classes, (VIT_BATCH,), generator=g, device=device)
    _flash_counts_zero(fa)

    # Logits in f32, card against CPU, from the same weights.
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    card, cpu = vit.ViT(f32, device), vit.ViT(f32, "cpu")
    card.load_state_dict(model.state_dict())
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = images[:VIT_PARITY_BATCH]
    with torch.inference_mode():
        got, want = card(x).cpu(), cpu(x.cpu())
    del card, cpu
    d = (got - want).abs().max().item()
    _log("vit", f"{smi}: ViT-B/16, {vit.num_params(cfg) / 1e6:.1f} M parameters, {cfg.num_patches} patch "
                f"tokens, {cfg.num_classes} classes; logits at B={VIT_PARITY_BATCH} in f32, card against "
                f"CPU: max |d| {d:.3g}")
    _require(got.shape == (VIT_PARITY_BATCH, cfg.num_classes), f"ViT logits {tuple(got.shape)}")
    torch.testing.assert_close(got, want, **VIT_TOL)

    # remat on and off: the same gradients.
    def grads(m):
        m.zero_grad(set_to_none=True)
        vit.loss_fn(m, {"images": images, "labels": labels}).backward()
        return {n: p.grad.clone() for n, p in m.named_parameters()}

    plain = vit.ViT(dataclasses.replace(cfg, remat=False), device)
    plain.load_state_dict(model.state_dict())
    g_remat, g_plain = grads(model), grads(plain)
    model.zero_grad(set_to_none=True)
    del plain
    remat_d = max((g_remat[n] - g_plain[n]).abs().max().item() for n in g_plain)
    _log("vit", f"one step's gradients at B={VIT_BATCH} with remat on and off: max |d| {remat_d}")
    _require(remat_d == 0, f"remat changed the gradients: max |d| {remat_d}")
    del g_remat, g_plain

    batch = {"images": images, "labels": labels}
    step = spmd.compile_train_step(vit.loss_fn, spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1))
    state = spmd.TrainState(0, model)
    losses, samples = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        _sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        samples.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = _spread(samples[TRAIN_WARMUP:])[0]
    busy = phase_profile(lambda: step(state, batch), "one [vit] step", ms, top=8) if device == "cuda" else None
    counts = _counts(fa)
    _require(not any(counts.values()), f"[vit] launched flash kernels: {counts}")
    _require(all(math.isfinite(v) for v in losses), f"[vit] non-finite loss: {losses}")
    _require(abs(losses[0] - math.log(cfg.num_classes)) < LOSS_WINDOW, f"[vit] first loss {losses[0]}")
    _require(losses[-1] < losses[0] - 0.1, f"[vit] loss did not fall: {losses}")
    ms, q25, q75 = _spread(samples[TRAIN_WARMUP:])
    fpi = vit.flops_per_image(cfg)
    _log("vit", "loss " + " ".join(f"{v:.4f}" for v in losses))
    _log("vit", f"step {ms:.3f} ms at B={VIT_BATCH} (median of {TRAIN_STEPS}, quartiles {q25:.3f}..{q75:.3f}), "
                f"{VIT_BATCH / ms * 1e3:.1f} images/s, {fpi / 1e9:.2f} GFLOP an image (from the shapes, remat's "
                f"recomputation not counted) -> {fpi * VIT_BATCH / (ms / 1e3) / BF16_FLOPS:.4f} of the bf16 "
                f"peak; peak memory {peak:.2f} GiB; flash launches {counts}")
    return {"step_ms": ms, "images_per_s": VIT_BATCH / ms * 1e3, "gflop_per_image": fpi / 1e9,
            "peak_share": fpi * VIT_BATCH / (ms / 1e3) / BF16_FLOPS, "peak_gib": peak, "busy_ms": busy,
            "logits_max_abs": d, "losses": losses}


# [deploy] and [push]: Mistral-7B served through serve.run and a handle from
# a replica that holds a one-GPU lease, then new weights pushed into it.
DEPLOY_CPUS = 4
DEPLOY_SEED = 2  # [serve]'s weights: the replica holds the same bits
PUSH_SEED = 3
PUSH_PROMPT_LENS = (64, 200, 512)
PUSH_NEW = 32
PUSH_STREAM_NEW = 128
STORE_MARGIN_BYTES = 1 << 30


def _seeded_llama(cfg, seed, device):
    """The weights loader a replica runs: ``llama.init`` from a seeded
    generator on the replica's card."""
    from ray_tpu_torch.models import llama

    return llama.init(cfg, torch.Generator(device=device).manual_seed(seed), device)


def _checksum(state, chunk=1 << 24):
    """A checksum of a state dict's bits: each tensor's elements as
    integers, weighted by position, summed in int64 with wrap-around (so
    any summation order gives the same value), over the sorted names; in
    chunks, so that it needs little memory beside the weights."""
    total = 0
    for i, name in enumerate(sorted(state)):
        t = state[name].detach().contiguous().reshape(-1)
        bits = t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])
        for off in range(0, bits.numel(), chunk):
            b = bits[off:off + chunk].to(torch.int64)
            w = torch.arange(off, off + b.numel(), device=t.device, dtype=torch.int64) * 2654435761 + (i + 1)
            total = (total + int((b * w).sum())) % 2**64
    return total


def _replica_facts(inst):
    """In the replica: its process, cards, flash launches, the engine's
    construction and last update timings, its peak card memory and its
    weights' checksum."""
    facts = _worker_facts()
    fa = sys.modules.get("ray_tpu_torch.ops.flash_attention")
    dep = inst._callable
    on_card = torch.cuda.is_available()
    facts.update(
        device_count=torch.cuda.device_count(),
        device_name=torch.cuda.get_device_name(0) if on_card else None,
        flash={} if fa is None else _counts(fa),
        timings=dep.timings, last_update=dep.last_update,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        checksum=_checksum(dep.engine.model.state_dict()),
    )
    return facts


def _replica_reset_peak(inst):
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    return True


def _control_facts(_inst):
    """In a control actor (controller, proxy): its argv, card and whether
    torch or JAX is loaded.  It names no torch global, so shipping it loads
    none."""
    with open("/proc/self/cmdline", "rb") as f:
        argv = [a.decode() for a in f.read().split(b"\0") if a]
    return {"argv": argv, "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "loaded": sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "ray_tpu"))}


def _replicas(name):
    """The live replica actors of deployment ``name`` of the default app."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.controller import get_or_create_controller

    return rt.get(get_or_create_controller().get_replica_actors.remote(name), timeout=30)


def _replay(handle, prompts, new, delays):
    """The requests through the handle, each streamed from its own thread
    after its delay; the records ``_stream_stats`` reads and the wall time.
    Each request is sent after the one before it, so that the replica
    admits them in the order the in-process engine did (the order sets
    which requests wait for a row).  A request's time to first token runs
    from its delay, as in ``[serve]``, and so includes its wait behind the
    sends before it."""
    import threading

    records, errors = [], []
    sent = [threading.Event() for _ in prompts]
    t0 = time.perf_counter()

    def client(i):
        try:
            submit, times, toks = t0 + delays[i], [], []
            time.sleep(max(0.0, submit - time.perf_counter()))
            if i:
                sent[i - 1].wait()
            # off the io loop, remote() sends the request before it returns
            stream = handle.options(method_name="generate", stream=True).remote(prompts[i], int(new[i]))
            sent[i].set()
            for tok in stream:
                times.append(time.perf_counter())
                toks.append(tok)
            records.append((i, submit, times, toks, int(new[i])))
        except Exception as e:  # noqa: BLE001 — reported below
            sent[i].set()
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    _require(not errors and len(records) == len(prompts), f"requests failed: {errors}")
    return records, time.perf_counter() - t0


def _shm_bytes():
    st = os.statvfs("/dev/shm")
    return st.f_frsize * st.f_blocks, st.f_frsize * st.f_bavail


def phase_serving_runtime(fa, llama, cfg, serve_out, serve_tokens, serve_sum, smi):
    """[deploy] and [push] on one cluster of the port's runtime; the flash
    kernels' counts are reset before and must read 0 after, in the driver
    and in the replica; after shutdown() no process of the driver remains."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api

    from ray_tpu_torch.common.config import cfg as rt_cfg

    # The store is sized so that the state dict stays below the fill at
    # which the raylet starts spilling to disk and back (it would then wait
    # on a restore): the spill's low mark of the arena, plus a margin.
    nbytes = llama.num_params(cfg) * torch.finfo(cfg.param_dtype).bits // 8
    shm_total, shm_free = _shm_bytes()
    store = int(nbytes / rt_cfg.object_spill_low_frac) + 1 + STORE_MARGIN_BYTES
    _log("deploy", f"/dev/shm: {shm_total / 1e9:.2f} GB, {shm_free / 1e9:.2f} GB free; the full "
                   f"state dict is {nbytes / 1e9:.3f} GB: object store {store / 1e9:.2f} GB (spill "
                   f"above {rt_cfg.object_spill_high_frac:.0%} full)")
    _require(store <= shm_free * 0.9, f"/dev/shm has {shm_free / 1e9:.2f} GB free, too little for an "
                                      f"object store of {store / 1e9:.2f} GB that holds the state dict")
    _flash_counts_zero(fa)
    rt.init(num_cpus=DEPLOY_CPUS, object_store_bytes=store, log_to_driver=False)
    try:
        out = {"deploy": phase_deploy(rt, fa, llama, cfg, serve_out, serve_tokens, serve_sum, smi)}
        out["push"] = phase_push(rt, fa, llama, cfg, smi)
    finally:
        group = rt_api._node_group
        rt.shutdown()
    deadline = time.monotonic() + 15
    while _descendants(os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = {p: _cmdline(p) for p in _descendants(os.getpid())}
    _require(not left, f"processes left after shutdown(): {left}")
    _require(group.gcs_proc.poll() is not None and group.raylet_proc.poll() is not None,
             "the GCS or the raylet outlived shutdown()")
    counts = _counts(fa)
    _require(not any(counts.values()), f"[deploy]/[push] launched flash kernels in the driver: {counts}")
    _log("push", f"shutdown(): no process of the driver remains; flash launches in the driver {counts}")
    return out


def _deploy(serve, llama, cfg, seed):
    from ray_tpu_torch.serve.llm import LlamaDeployment

    return serve.run(
        LlamaDeployment.options(name="llm", ray_actor_options={"num_gpus": 1}).bind(
            config=cfg, weights_loader=functools.partial(_seeded_llama, cfg, seed, DEVICE),
            device=DEVICE, **SERVE_ENGINE),
        route_prefix=None)


def phase_deploy(rt, fa, llama, cfg, serve_out, serve_tokens, serve_sum, smi):
    """[deploy]: Mistral-7B at full width and depth from a one-GPU replica
    through serve.run; [serve]'s traffic replayed through the handle must
    give [serve]'s tokens, request by request."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.actor import get_actor
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    t0 = time.perf_counter()
    serve.start()
    controller_s = time.perf_counter() - t0
    t_call, t0 = time.time(), time.perf_counter()
    handle = _deploy(serve, llama, cfg, DEPLOY_SEED)
    ready_s = time.perf_counter() - t0
    (replica,) = _replicas("llm")
    facts = rt.get(replica._apply(_replica_facts), timeout=120)
    build_peak = facts["peak_gib"]
    rt.get(replica._apply(_replica_reset_peak), timeout=60)
    _check_worker(facts, "replica")
    _require(facts["visible"] == "0" and facts["device_count"] == 1,
             f"the replica sees CUDA_VISIBLE_DEVICES={facts['visible']!r}, {facts['device_count']} card(s)")
    _require(facts["checksum"] == serve_sum,
             f"the replica's weights differ from [serve]'s: checksum {facts['checksum']} != {serve_sum}")
    ctl = rt.get(get_actor(CONTROLLER_NAME)._apply(_control_facts), timeout=60)
    _require(ctl["visible"] == "" and not ctl["loaded"] and "ray_tpu_torch.core.worker_main" in ctl["argv"],
             f"the controller: CUDA_VISIBLE_DEVICES={ctl['visible']!r}, loaded {ctl['loaded']}")
    tm = facts["timings"]
    start_s = tm["start"] - t_call  # CUDA starts with torch's import: the lease binds it
    _log("deploy", f"{smi}: controller up in {controller_s:.3f} s; serve.run ready in {ready_s:.3f} s: "
                   f"replica lease, worker start, torch import and CUDA init {start_s:.3f} s, weights "
                   f"built on the card {tm['weights_s']:.3f} s, "
                   f"engine and cache {tm['engine_s']:.3f} s, the rest "
                   f"{ready_s - start_s - tm['weights_s'] - tm['engine_s']:.3f} s")
    _log("deploy", f"replica on {facts['device_name']} (CUDA_VISIBLE_DEVICES={facts['visible']!r}, pid "
                   f"{facts['pid']}), loads {facts['foreign'] or 'no JAX'}; weights checksum equals "
                   f"[serve]'s; the controller sees CUDA_VISIBLE_DEVICES='' and loads no torch; no "
                   f"proxy is started (handles only)")

    _, _, new, prompts, delays = _serve_traffic(cfg.vocab_size)
    # The first request on a fresh replica pays its libraries' start
    # (cuBLAS and the first kernels); [serve]'s engine ran in a process
    # that had warmed them, so one short request goes first, timed apart.
    t0 = time.perf_counter()
    first = handle.options(method_name="generate", stream=True).remote(prompts[0][:64], 4)
    warm = [time.perf_counter() - t0 for _ in first]
    _log("deploy", f"first request on the fresh replica (64 tokens, 4 new): first token "
                   f"{warm[0] * 1e3:.1f} ms, last {warm[-1] * 1e3:.1f} ms")
    records, wall = _replay(handle, prompts, new, delays)
    st, tokens = _stream_stats(records, wall, cfg.vocab_size)
    differ = [i for i in range(SERVE_REQUESTS) if tokens[i] != serve_tokens[i]]
    facts = rt.get(replica._apply(_replica_facts), timeout=120)
    _log("deploy", f"{st['output_tokens']} tokens in {wall:.3f} s: {st['output_tokens_per_s']:.1f} output, "
                   f"{st['decode_tokens_per_s']:.1f} decode tokens/s (in process [serve]: "
                   f"{serve_out['output_tokens_per_s']:.1f}, {serve_out['decode_tokens_per_s']:.1f})")
    _log("deploy", _stream_line(st))
    _log("deploy", f"  [serve] in process: {_stream_line(serve_out)}")
    _log("deploy", f"through the handle minus in process: time to first token median "
                   f"{st['ttft_ms_median'] - serve_out['ttft_ms_median']:+.1f} ms, gap median "
                   f"{st['gap_ms_median'] - serve_out['gap_ms_median']:+.2f} ms, p90 "
                   f"{st['gap_ms_p90'] - serve_out['gap_ms_p90']:+.2f} ms; replica peak memory over the "
                   f"requests {_gib(facts['peak_gib'])} (in process {_gib(serve_out['peak_gib'])}), over "
                   f"its construction {_gib(build_peak)}")
    _log("deploy", f"time to first token ms by request, in process: {serve_out['ttft_ms_by_request']}; "
                   f"through the handle: {st['ttft_ms_by_request']}")
    _log("deploy", f"time to the last token ms by request, in process: {serve_out['end_ms_by_request']}; "
                   f"through the handle: {st['end_ms_by_request']}")
    _require(not differ, f"requests {differ} got other tokens through the handle than in process")
    _require(not any(facts["flash"].values()), f"the replica launched flash kernels: {facts['flash']}")
    _log("deploy", f"all {SERVE_REQUESTS} requests: full counts, tokens equal to [serve]'s request by "
                   f"request; flash launches in the replica {facts['flash'] or 'none (not loaded)'}")
    return dict(st, first_request_ttft_ms=warm[0] * 1e3, ready_s=ready_s, controller_s=controller_s,
                replica_start_s=start_s,
                weights_build_s=tm["weights_s"], engine_s=tm["engine_s"], peak_gib=facts["peak_gib"],
                build_peak_gib=build_peak)


def phase_push(rt, fa, llama, cfg, smi):
    """[push]: new weights from another seed into the served deployment
    through push_deployment_weights while streams are in flight."""
    import asyncio
    import threading

    import numpy as np

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMEngine

    (replica,) = _replicas("llm")
    handle = serve.get_deployment_handle("llm")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PUSH_PROMPT_LENS]
    model = _seeded_llama(cfg, PUSH_SEED, DEVICE)
    engine = LLMEngine(model, device=DEVICE, **SERVE_ENGINE)

    async def run():
        async def one(p):
            return [t async for t in engine.stream(p, PUSH_NEW)]
        return await asyncio.gather(*(one(p) for p in prompts))

    want = asyncio.run(run())
    want_sum = _checksum(model.state_dict())
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del engine, model
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    nbytes = sum(v.numel() * v.element_size() for v in state.values())
    rt.get(replica._apply(_replica_reset_peak), timeout=60)
    t0 = time.perf_counter()
    ref = rt.put(state)
    put_s = time.perf_counter() - t0
    del state

    # Streams run back to back from before the push until after it, so
    # that one is in flight when the replica swaps its weights.
    stop, streams = threading.Event(), []

    def streamer():
        while not stop.is_set():
            rec = {"start": time.time(), "times": [], "error": None}
            try:
                for _ in handle.options(method_name="generate", stream=True).remote(prompts[0], PUSH_STREAM_NEW):
                    rec["times"].append(time.time())
            except Exception as e:  # noqa: BLE001 — checked below
                rec["error"] = repr(e)
            streams.append(rec)

    th = threading.Thread(target=streamer)
    th.start()
    time.sleep(0.5)
    t_call, t0 = time.time(), time.perf_counter()
    n = serve.push_deployment_weights("llm", ref, timeout=900)
    push_s = time.perf_counter() - t0
    stop.set()
    th.join(timeout=600)
    del ref
    facts = rt.get(replica._apply(_replica_facts), timeout=120)
    u = facts["last_update"]
    swap_at = u["start"] + u["apply_s"]
    get_s = u["start"] - t_call
    _require(n == 1 and u is not None, f"push_deployment_weights updated {n} replicas")
    bad = [(len(r["times"]), r["error"]) for r in streams if len(r["times"]) != PUSH_STREAM_NEW or r["error"]]
    spanned = [r for r in streams if r["times"] and r["times"][0] < swap_at < r["times"][-1]]
    gaps = [(b - a) * 1e3 for r in streams for a, b in zip(r["times"], r["times"][1:])]
    timeline = [(round(r["times"][0] - t_call, 3), round(r["times"][-1] - t_call, 3))
                 for r in streams if r["times"]]
    _log("push", f"seconds from the push call: update_weights entered {u['start'] - t_call:.3f}, the "
                 f"swap {swap_at - t_call:.3f}, the push returned {push_s:.3f}; each stream's first and "
                 f"last token {timeline}")
    _require(not bad, f"streams in flight during the push ended short or failed: {bad}")
    _require(spanned, "no stream was in flight when the replica swapped its weights")
    got = [r.result(timeout_s=300) for r in
           [handle.options(method_name="generate_all").remote(p, PUSH_NEW) for p in prompts]]
    _require(facts["checksum"] == want_sum,
             f"the replica's checksum {facts['checksum']} != the pushed state dict's {want_sum}")
    _require(got == want, f"after the push the handle gives other tokens than the driver: "
                          f"{[g == w for g, w in zip(got, want)]}")
    _require(not any(facts["flash"].values()), f"the replica launched flash kernels: {facts['flash']}")
    gb = nbytes / 1e9
    _log("push", f"{smi}: {cfg.num_layers} layers, state dict {gb:.3f} GB (bf16, CPU): put in the driver "
                 f"{put_s:.3f} s ({gb / put_s:.3f} GB/s); push_deployment_weights {push_s:.3f} s, of which "
                 f"the call to the replica's update_weights (its get of the state dict) {get_s:.3f} s "
                 f"({gb / get_s:.3f} GB/s) and the apply on the card {u['apply_s']:.3f} s "
                 f"({gb / u['apply_s']:.3f} GB/s); replica peak memory across the swap "
                 f"{_gib(facts['peak_gib'])}")
    _log("push", f"{len(streams)} streams of {PUSH_STREAM_NEW} tokens ran through the push, all whole; "
                 f"{len(spanned)} spanned the swap; token gap median {_pct(gaps, 0.5):.2f} ms, max "
                 f"{max(gaps):.1f} ms; {len(prompts)} prompts ({PUSH_PROMPT_LENS} tokens, {PUSH_NEW} new) "
                 f"give the driver's new tokens; the replica's checksum equals the pushed state dict's")
    return {"layers": cfg.num_layers, "bytes": nbytes, "put_s": put_s, "push_s": push_s, "get_s": get_s,
            "apply_s": u["apply_s"], "put_gb_s": gb / put_s, "get_gb_s": gb / get_s,
            "apply_gb_s": gb / u["apply_s"], "peak_gib": facts["peak_gib"], "streams": len(streams),
            "gap_ms_max": max(gaps)}

def _ms(x):
    return "not measured" if x is None else f"{x:.3f} ms"


def _gib(x):
    return "not measured" if x is None else f"{x:.2f} GiB"


def _time_host(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_llama(fa, smi):
    """Phases 8-10 on one Mistral-7B model; the flash kernels' counts are
    reset before and must read 0 after."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    t0 = time.perf_counter()
    _flash_counts_zero(fa)
    cfg = llama.LlamaConfig.mistral_7b(param_dtype=torch.bfloat16)
    model = llama.init(cfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
    n = llama.num_params(cfg)
    _log("llama-parity", f"Mistral-7B: {n / 1e9:.3f} B parameters ({n * 2 / 1e9:.2f} GB in bf16), "
                         f"{cfg.num_layers} layers, E {cfg.embed_dim}, {cfg.num_heads} q / "
                         f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, MLP {cfg.mlp_dim}, window "
                         f"{cfg.sliding_window}; built in {time.perf_counter() - t0:.1f} s")
    parity = {f"{cfg.num_layers} layers": phase_llama_parity(llama, model, PARITY_TOL),
              f"{PARITY_SHALLOW_LAYERS} layers": phase_llama_parity(
                  llama, _first_layers(llama, model, PARITY_SHALLOW_LAYERS), PARITY_SHALLOW_TOL)}
    phase_llama_rolling(llama, LLMEngine, "cuda")
    serve, serve_tokens = phase_serve(llama, LLMEngine, model, smi)
    counts = _counts(fa)
    _require(not any(counts.values()), f"the Llama paths launched flash kernels: {counts}")
    _log("done", f"llama phases {time.perf_counter() - t0:.1f} s; flash kernel launches on them: {counts}")
    # [serve]'s model is freed before the replica builds its own copy.
    serve_sum = _checksum(model.state_dict())
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = phase_serving_runtime(fa, llama, cfg, serve, serve_tokens, serve_sum, smi)
    _log("done", f"[deploy] and [push] {time.perf_counter() - t0:.1f} s")
    return {"llama_parity": parity, "serve": serve, **served}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.models import gpt2, vit
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import spmd

    t_start = time.perf_counter()
    smi = phase_device_and_build(_build)
    # For the Data library's port, whose blocks are Arrow tables.
    _log("probe", f"pyarrow importable: {importlib.util.find_spec('pyarrow') is not None}")
    # For RLlib's env runners ([rllib] (b)).
    _log("probe", f"gymnasium importable: {importlib.util.find_spec('gymnasium') is not None}")
    fwd_err = phase_check(fa)
    bwd_err = phase_check_bwd(fa)
    phase_tolerance_floor(fa)
    times = {"fwd": phase_time_kernel(fa), **phase_time_bwd(fa)}

    # The forward path (PR 1's main path).
    cfg = gpt2.GPTConfig.gpt2_124m(attention_impl="flash", remat=False, scan_unroll=12)
    g = torch.Generator(device="cuda").manual_seed(0)
    model = gpt2.init(cfg, g, "cuda")
    tokens = torch.randint(0, 50257, (3, 8, 1025), generator=g, device="cuda")
    fwd_launches, (logits, loss) = phase_main_path(fa, gpt2, entry, model, tokens)
    dense = phase_flash_vs_dense(gpt2, model, tokens, logits, loss)
    del logits
    x = tokens[0, :, :-1]
    fwd = phase_time_forward(gpt2, {"flash": model, "dense": dense}, x)
    del dense
    with torch.inference_mode():
        phase_profile(lambda: model(x), "one flash forward", fwd["flash"])

    # The training path, from fresh weights.
    model = gpt2.init(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    phase_grad_flash_vs_dense(gpt2, model, tokens[1])
    launches, step, state, train = phase_train(fa, gpt2, spmd, model, tokens[0])
    head = phase_time_head_backward(model, tokens.shape[1] * (tokens.shape[2] - 1))
    # The step's bf16 kernels are the wgmma ones, one launch a layer each.
    phase_profile(lambda: step(state, {"tokens": tokens[0]}), "one train step", train["step_ms"], top=10,
                  expect={f"flash_{k}_wgmma_kernel": cfg.num_layers for k in ("fwd", "dq", "dkv")})

    del model, state, step, x
    torch.cuda.empty_cache()
    # The same training through the mesh path (this slice's main path).
    t0 = time.perf_counter()
    spmd_out = phase_spmd(fa, gpt2, cfg, tokens[0], train, smi)
    torch.cuda.empty_cache()
    _log("done", f"[spmd] {time.perf_counter() - t0:.1f} s")
    # The same training through the pipeline's stage programs (this slice's
    # main path), then the MPMD trainer over stage actors on the host.
    t0 = time.perf_counter()
    pipe = phase_pipeline(fa, gpt2, cfg, tokens[0], train, smi)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    mpmd = phase_pipeline_mpmd(smi)
    _log("done", f"[pipeline] {t1 - t0:.1f} s, [pipeline-mpmd] {time.perf_counter() - t1:.1f} s")
    # The runtime path: the same GPT-2-124M, from seed 0, through the port's
    # runtime into a GPU-leased worker.
    runtime = phase_runtime(fa, gpt2, cfg, tokens[0], smi)

    # The same training through the Train library from a GPU-leased
    # worker, with a checkpoint and a gang restart; then Tune trials of it
    # queued on the card, and a Tuner over the trainer; then GPT-2 with
    # experts and ViT-B/16.
    t0 = time.perf_counter()
    fit = phase_fit(fa, gpt2, cfg, tokens[0], train, smi)
    t_tune = time.perf_counter()
    tune_out = phase_tune(fa, gpt2, cfg, tokens[0], train, smi)
    _log("done", f"[tune] {time.perf_counter() - t_tune:.1f} s")
    # The same training fed by the Data library from parquet files.
    t_ingest = time.perf_counter()
    ingest = phase_ingest(fa, gpt2, spmd, cfg, smi)
    torch.cuda.empty_cache()
    _log("done", f"[ingest] {time.perf_counter() - t_ingest:.1f} s")
    # Compiled DAGs, a durable workflow and the multi-raylet Cluster, each
    # driving GPT-2-124M from [train]'s seed on the card.
    t0 = time.perf_counter()
    dag_out = phase_dag(gpt2, cfg, smi)
    t1 = time.perf_counter()
    wf_out = phase_workflow(gpt2, cfg, tokens[0], train, smi)
    t2 = time.perf_counter()
    cluster_out = phase_cluster(gpt2, cfg, tokens[0], smi)
    torch.cuda.empty_cache()
    _log("done", f"[dag] {t1 - t0:.1f} s, [workflow] {t2 - t1:.1f} s, [cluster] {time.perf_counter() - t2:.1f} s")
    # The operator surface: a CLI-started head running a submitted job on
    # the card, then an autoscaler launching a GPU node for a pending task.
    t0 = time.perf_counter()
    job_out = phase_job(gpt2, cfg, tokens[0], smi)
    t1 = time.perf_counter()
    autoscale_out = phase_autoscale(gpt2, cfg, tokens[0], smi)
    torch.cuda.empty_cache()
    _log("done", f"[job] {t1 - t0:.1f} s, [autoscale] {time.perf_counter() - t1:.1f} s")
    moe = phase_moe(fa, gpt2, spmd, tokens[0], gpt2.GPTConfig.gpt2_124m(
        num_experts=MOE_EXPERTS, attention_impl="flash", remat=False, scan_unroll=12))
    torch.cuda.empty_cache()
    vit_out = phase_vit(fa, vit, smi, vit.ViTConfig.vit_b16())
    torch.cuda.empty_cache()
    _log("done", f"[fit], [tune], [moe] and [vit] {time.perf_counter() - t0:.1f} s")

    # The serving path (Mistral-7B through the LLM engine), after the GPT-2
    # state is freed so that its peak memory is its own.
    del tokens
    torch.cuda.empty_cache()
    llama_out = phase_llama(fa, smi)
    # RLlib: the learners on the card, PPO on CartPole from a card learner.
    rl_out = phase_rllib(fa, smi)
    # The Podracer plane: its learner actor on the card, then fed by a fleet.
    podracer = phase_podracer(fa, smi)
    # The multi-rank layouts, over gloo on the host.
    t0 = time.perf_counter()
    dryrun_lines = phase_dryrun()
    _log("done", f"[dryrun] {time.perf_counter() - t0:.1f} s")
    _log("done", f"{time.perf_counter() - t_start:.1f} s in all")

    def entry_of(key, name, line, err):
        t = times[key]
        return {
            "name": name,
            "route": "cuda",
            "source": f"ray_tpu_torch/csrc/flash_attention_{'fwd' if key == 'fwd' else 'bwd'}.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": launches[key],
            "max_abs_err": err,
            "ms": t["ms"],
            "wrapper_ms": t["wrapper_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        }

    kernels = [
        entry_of("fwd", "flash_attention_fwd", 39, fwd_err),
        entry_of("dq", "flash_attention_dq", 97, bwd_err["dq"]),
        entry_of("dkv", "flash_attention_dkv", 142, bwd_err["dkv"]),
    ]
    # The forward kernel's launches in the GPU-leased worker (the runtime path).
    kernels[0]["runtime_launches"] = runtime["launches"]
    # Each kernel's launches in the trainer's worker ([fit]), in the Tune
    # trials' processes ([tune] (a) and (b)) and in [moe].
    for entry, key in zip(kernels, ("fwd", "dq", "dkv")):
        entry["fit_launches"] = fit["launches"][key]
        entry["tune_launches"] = tune_out["launches"][key]
        entry["moe_launches"] = moe["launches"][key]
        entry["spmd_launches"] = spmd_out["launches"][key]
        entry["pipeline_launches"] = pipe["launches"][key]
        entry["rllib_launches"] = rl_out["launches"][key]
        entry["ingest_launches"] = ingest["launches"][key]
        entry["podracer_launches"] = podracer["launches"][key]
        entry["dag_launches"] = dag_out["launches"][key]
        entry["workflow_launches"] = wf_out["launches"][key]
        entry["cluster_launches"] = cluster_out["launches"][key]
        entry["job_launches"] = job_out["launches"][key]
        entry["autoscale_launches"] = autoscale_out["launches"][key]
    print(json.dumps({"forward_ms": fwd, "forward_path_fwd_launches": fwd_launches,
                      "train_step_ms": train["step_ms"], "train_tokens_per_s": train["tokens_per_s"],
                      "head_backward_ms": head, "runtime": runtime, "fit": fit, "tune": tune_out, "moe": moe,
                      "vit": vit_out, "spmd": spmd_out, "pipeline": pipe, "pipeline_mpmd": mpmd,
                      "rllib": rl_out, "ingest": ingest, "podracer": podracer, "dryrun": dryrun_lines,
                      "dag": dag_out, "workflow": wf_out, "cluster": cluster_out, "job": job_out,
                      "autoscale": autoscale_out,
                      **llama_out,
                      "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--job-driver"]:
        sys.exit(job_driver(sys.argv[2]))
    sys.exit(main())
