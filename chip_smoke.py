#!/usr/bin/env python3
"""Smoke run of the PyTorch port (satnerf_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, any failure exits nonzero (no phase falls back to the CPU or to a
plain version):
  0  the card: torch.cuda must see a GPU, name and power limit
  1  build the CUDA kernels in satnerf_tpu_torch/csrc/ with nvcc (sm_90a)
  2  the serving kernels (K2) against their plain PyTorch versions on the
     card, at 8 x 512, 64 samples, 8192 + 37 rays (a ragged edge), sat-nerf
     and s-nerf, fp32 and bf16, with the compositing weights; every bf16
     launch of siren_dense on its wgmma mainloop also against the same launch
     on the wmma mainloop (one rounding step; here and in 2b-2d, where every
     bf16 launch of siren_dense_dgrad and siren_dense_wgrad on wgmma is held
     against the same launch on wmma too); then every kernel alone at its
     main-path shape: time, plain version's time, the one library call that
     computes the same function, and the card's bound, and for siren_dense,
     siren_dense_dgrad and siren_dense_wgrad both mainloops' times (the
     wgrad's GEMM with its bias sum: on wgmma in its epilogue, on wmma by
     narrow_grads); siren_dense's K = 0 kernel at layer 0 (with the slope)
     and sky_0 beside the first one it replaced (k0_v1), bit-equal; the
     skip layer's wgrad with dC folded into its epilogue beside the same
     launch with the column walk, dW and db bit-equal at one point range;
     narrow_grads and the walk small_grads alone at layer 0's launch (the
     library call torch.einsum over [E | 1] beside them) and summing db of a
     layer with a bias alone, beside torch.einsum, and the chain's joined
     launch (sky_0's job and beta_0's t_grad) against its plain version;
     sc_loss_bwd (a block a ray) at 1024 x 64 and x 128 samples,
     field_heads (the streaming kernel) and field_heads_bwd (streaming, the
     sky head folded in) at 1024 x 128 and on 131,072 points that are their
     own rays, and heads_composite (a block scan) at a serving chunk and,
     with sigma noise, at a training batch, each beside the time PERF.md
     gives the body it replaced; one heads_composite launch at 256 x 640
     with weights (its scan carried over three chunks) against its plain
     version (1e-4);
     every K = 0 launch of siren_dense in phases 2-2d is also held against
     k0_v1 to the bit, every siren_dense_wgrad launch in 2b-2d against the
     same launch with the column walk (db, dC, dE within 1e-4), and the
     chains' joined narrow_grads launch in 2b-2d, as the main path runs it,
     each job against its plain version and the same job launched alone
  2b the training kernels (K1) against their plain versions, at 8 x 512,
     64 samples, 1024 and 1000 + 37 rays: sat-nerf with the beta gate at 1
     and at 0 (with sigma noise and the weights output), s-nerf; fp32 and
     bf16; each with the depths jittered from a torch.Generator and from
     the main path's draw (jax.random's uniform, ops/jax_draws.py); loss
     parts, every gradient by name, t_grad, weights, and every launch of
     the chain alone (the sky head's cotangent d_skyh in bf16 within a
     step of one of its three terms, TrainCheck._hold_cotangents); every launch of composite_loss_bwd (a block
     a ray) also against the same launch on the warp-a-ray body it replaced
     (so in 2c for composite_bwd), and both bodies timed in phase 2; then
     every launch of the chain again past 256 samples a ray, at 1024 x 320
     (phase 6's long run) and 256 x 640 (shared memory opted into past
     48 KB on both bodies), fp32 and bf16 (so in 2c for K4's chain)
  2c the solar-correction pass (K3) and the differentiable training render
     (K4) against their plain versions, at 8 x 512, 64 samples, 1024 and
     1000 + 37 rays, sat-nerf and s-nerf, fp32 and bf16, sigma noise on and
     off: K3's two terms and every gradient by name; K4's products and, from
     a random (R, 16) cotangent on all seven products, every gradient and
     the t-gradient; and every launch of both chains alone, sc_loss_bwd,
     heads_composite with noise and composite_bwd among them; every launch
     of K3's chain again at 1024 x 320 and 256 x 640 (sc_loss_bwd's scan
     carried over two and three chunks of 256 samples). Then the new
     kernels alone at a training batch: time, plain time, bound
  3  the serving path through its entry point: a 128 x 128 synthetic AOI,
     a seeded sat-nerf 8 x 512 checkpoint, create_pretty_dsm on the card
     (finite DSM and MAE, every serving kernel launched), then render_image
     on 262,144 rays for a rays/s reading
  4  the training path through its entry point: cli.train on that AOI at
     8 x 512, 64 samples, batch 1024, bf16, across two epoch boundaries and
     the beta switch-on, with validation and checkpoints; a second call
     resumes from the checkpoint; create_pretty_dsm serves the trained
     weights. Every kernel must have been launched, every siren_dense,
     siren_dense_dgrad and siren_dense_wgrad launch with K > 0 on the wgmma
     mainloop, 13 wgrad launches and 2 narrow_grads launches a step (layer
     0; sky_0 joined with beta_0's t_grad), the column walk never, every
     K = 0 siren_dense launch on its new kernel, and every
     composite_loss_bwd launch a block a ray (phase 5:
     composite_bwd's too), the loss must fall, the resumed run must start at the saved
     step and the trained loss level. Its rate is read from the log
     intervals that hold no validation (the loop's clock runs through
     validation, as the JAX loop's does; so in phases 5-7)
  5  the paper's full recipe through its entry point: a second AOI with
     key points, cli.train with --sc_lambda 0.1 --ds_lambda 1000 at the same
     sizes across an epoch boundary, the beta switch-on and the step where
     the depth term drops out; sc_loss_bwd once a step, composite_bwd once
     an active step and never after, heads_composite once a step beside
     its serving launches, loss_depth logged and finite, the loss falling;
     then short runs with --grad_accum 2 (and sigma noise) and with
     --sampling shuffle
  2d (run after 2c) the per-sample field: fused_field_apply_rays (K5) and
     fused_field_apply (K6) against their plain versions at 8 x 512, sat-nerf
     and s-nerf, fp32 and bf16, 1024 and 1000 + 37 rays, 64, 72 and 128
     samples a ray (K6: 65,536 + 37 points): every output, and from a random
     (P, 16) cotangent every gradient, the t-gradient and K6's xyz and sun
     gradients; every launch of both chains alone, field_heads and
     field_heads_bwd among them; K1, K2 and K3 once each at 72 and 128
     samples, which the earlier phases never gave them; then the two new
     kernels alone at 1,024 x 128 points: time, plain time, bound
  6  hierarchical sampling through the entry points, on phase 5's AOI:
     cli.train --n_importance 64 --sc_lambda 0.1 --ds_lambda 1000 at the same
     sizes across an epoch boundary, the beta switch-on and the depth term's
     drop, every kernel's launches checked against the step count (the
     per-ray loss and solar-correction kernels twice a step, field_heads
     twice a step, field_heads_bwd twice an active step, composite_bwd
     never); validation through the two-launch serving dispatch; resume;
     create_pretty_dsm on the trained checkpoint; render_image on 262,144
     rays with its peak memory; a short --n_importance 256 run (a fine pass
     of 320 samples, past one chunk of the block body; the loss finite and
     falling); then a short --fused on --n_importance 8 run (K6 under the
     trainer and the server) and a short --fused off run that must launch no
     field kernel

  2e the classic NeRF variant's kernels: fused_nerf_train_loss_grads (K7),
     fused_nerf_render_rays (K8) and fused_nerf_apply (K9) against their
     plain versions at 8 x 256, fp32 and bf16, 1024 and 1000 + 37 rays, 64,
     72 and 128 samples a ray (K9: 65,536 + 37 points, with and without a
     view direction), sigma noise on and off, K8 with and without weights:
     the loss, every gradient by name, the products, and every launch of the
     three chains alone on the inputs the chain gave it (the relu masks come
     from the same stored activations on both sides), every bf16 launch of
     nerf_dense_dgrad and nerf_dense_wgrad on wgmma also against the same
     launch on wmma (and nerf_bias_grad, the wmma wgrad's db, against the
     plain db); then each kernel alone at its main-path shape: time, plain
     time, library call, bound, and for the dgrad and the wgrad both
     mainloops' times and the wgrad's second library reading [h | enc].t() @
     G (dW and dC in one call), and the two per-ray kernels (block scans)
     held against their plain versions at those shapes and, timed and held,
     at 256 x 640 with sigma noise; every launch of K7's chain also at 1024
     x 320 and 256 x 512 samples (nerf_composite_loss_bwd's block over two
     chunks of 256, T kept a sample); every bf16 launch of nerf_dense on wgmma
     also against the same launch on wmma (one rounding step), and each of
     the chain's five layer shapes at a serving chunk (65,536 x 64 points)
     on the rule's mainloop (wgmma) against wmma and the plain version
  7  the nerf variant through the entry points: cli.train --model nerf
     --fc_units 256 on phase 3's AOI at 64 samples, batch 1024, bf16, across
     an epoch boundary with validation (K8) and checkpoints, every launch
     count checked against the step count, every nerf_dense, dgrad and wgrad
     launch on wgmma, nerf_bias_grad never launched and no SIREN kernel
     launched (so in the two runs below);
     resume; create_pretty_dsm on the trained checkpoint; render_image on
     262,144 rays with its peak memory, held against the plain version; then
     a short --n_importance 64 run (K9 under the trainer, K8 twice a served
     chunk), a short --ds_lambda 1000 run on phase 5's AOI and short
     --n_samples 320 and 512 runs (K7's block over two chunks; the loss
     finite and falling)

  8  fields wider than the heads' kernels hold, a JAX checkpoint, and the
     capability tool: one cli.train step of sat-nerf and of nerf at 8 x 1024
     on phase 3's AOI must resolve --fused auto to "off" at construction
     with the width named and launch no kernel (the plain path's device-ms
     and event-ms a step are read beside it), and an explicit --fused rays
     there must raise ValueError at construction; the JAX package's
     checkpoint under tests/data/ (sat-nerf 4 x 32) loads and renders its
     stored ray batch through siren_dense and heads_composite, held against
     the JAX render stored beside it (fp32 1e-4, bf16 2e-2); then the
     transient experiment's smoke preset through
     tools/run_capability_experiments_torch.py (its phases in this process)
     must give finite metrics and a finite beta ratio
  9  the CPU geometry anchor's configuration on the card
     (tests/test_torch_geometry_anchor_cpu.py): cli.train on a 128 px
     10-view smooth-terrain AOI, sat-nerf 8 x 64, 32 samples, batch 512 x
     800 steps, lr 1e-3, seed 0, through the kernels (K1 every step, K2 for
     the final validation); the final val/mae must be under 4.0 m and
     val/psnr over 12.5, as on the CPU; the step's device-ms and the
     phase's seconds are printed

  10 training across devices (M7) at the main path's width: cli.train at
     sat-nerf 8 x 512, 64 samples, batch 1,024, bf16, --fused rays, 5 steps
     and validation (K2), without a process group and as a world of one
     through SATNERF_COORDINATOR (NCCL; the all-reduce must leave every
     gradient and metric as it was, to the bit, at every step); these two
     differ by the kernels' fp32 atomics alone, which is printed. Then the
     same on the path without atomics (--fused off, plain PyTorch on the
     card, its deterministic algorithms): twice without a group, which must
     agree to the bit, and as a world of one, whose parameters must be
     theirs to the bit. With two cards or more, two ranks (NCCL) whose
     parameters must be bit-equal
  11 the parity tool (M8): tools/parity_report_torch.py on the committed
     JAX checkpoint (sat-nerf 4 x 32) over a 16 px synthetic AOI, on the card
     (through K2) and on the CPU: finite PSNR, SSIM and MAE, the card's
     within 2e-2 of the CPU's
  12 the training draws (R5): the draw kernel csrc/jax_draws.cu, jax.random's
     bits, uniform, randint and normal, against its plain version
     (utils/jax_prng.py, numpy) to the bit, each at the main path's shapes
     (1,024 x 64, the batch's indices 1,024), at 65,536 x 64 and at an odd
     1,000,003; each timed beside its bound (threefry's instructions at the
     SM's issue rate, or the bytes written; the phase fails where the
     profiler reads no launch of the kernel or a device time under the
     bound), the plain version's host time and
     torch's own draw of the same shape (another function: library_ms is
     null); a permutation of two sort rounds; then two main-path steps
     (sat-nerf 8 x 512, 64 samples, batch 1,024, bf16), whose indices and
     jitter must equal the plain draws of their keys to the bit and whose
     depths within 1e-6. Phases 4 and 5 check the draw kernel's launches
     (2 a step; 4 with depth supervision), and phase 6's --fused off run,
     which launches no field kernel, still draws on the card.
  13 serving across the host's cards (M9), on phase 3's AOI and 8 x 512
     checkpoint, 64 samples, bf16, chunk 65,536: (a) render_image of its
     262,144-ray view for sat-nerf, --n_importance 64 and nerf 8 x 256 as a
     world of one (NCCL, through SATNERF_COORDINATOR) equal to the same call
     without a group, to the bit, every serving kernel launched (the kernels
     line's launches_render_group), and cli.eval's scores as a world of one
     those without a group; (b) where the host has w >= 2 cards (at most
     4), the three views across w ranks (parallel.spawn), each rank's
     products equal and rank 0's those of one card (bit for bit; else
     within one bf16 step, reported), every serving kernel launched on
     every rank, rays/s on 1 and w cards, device-ms a card, the NCCL
     kernels' and the gathers' ms; create_pretty_dsm with opts.json's
     n_devices w stays in its one process for its 16,384-ray view
     (eval/loader.py render_ranks), and on w ranks that each join the group
     gives one card's DSM and MAE (the ranks' start timed); a view 1.5 times
     the smallest for which render_ranks starts w ranks, rendered on one
     card and on w ranks started for it, each timed whole, products equal.
     With one card (b) prints that it did not run. Phase 10's two ranks
     also validate: both render their half of every chunk, and the logged
     val/psnr is one card's validation of the saved checkpoint
  14 the bench (python -m satnerf_tpu_torch.cli.bench, the root bench.py's
     counterpart): its ten rows through tools/bench_matrix_torch.py at
     BENCH_STEPS 5, each a process of its own on this card (the nine of
     tools/bench_matrix.py at bench.py's sizes, 8 x 512 for every model, and
     train_default_b1024). Every row's line must hold value > 0, 0 < mfu <
     1, device_ms > 0, 0 <= idle < 1, vs_baseline null, flops_per_ray the
     port's utils/flops.py for the row's configuration, and launches of the
     kernels its path runs (K1's on the train rows, K3's sc_loss_bwd on
     train_sc, K7's on train_nerf, K2's on serve_rays, serve_nimp and
     image_surface, K6's field_heads on serve_points, K8's on serve_nerf,
     and the draw kernel on every train row); each row's figures are
     printed. Then tools/profile_render_torch.py --train and its default
     262,144-ray render run in this phase, and the rows train_default_b1024
     and image_surface must read their device-ms within 10 % of them (the
     two read one sum, utils/device_time.py)

No earlier phase was cut when phases 2d, 2e, 6, 7, 8, 9, 10, 11, 12, 13 and
14 came: the whole run stays inside half its time limit.

The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Scratch files go to build/chip_smoke/.
"""

from __future__ import annotations

import glob
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
TRAIN_KERNELS = ("siren_dense", "composite_loss_bwd", "siren_dense_dgrad",
                 "siren_dense_wgrad", "narrow_grads")
AUX_KERNELS = ("sc_loss_bwd", "composite_bwd")  # first launched by phase 5's path
FIELD_KERNELS = ("field_heads", "field_heads_bwd")  # and these by phase 6's
TPU_KERNEL = {"render": "satnerf_tpu/ops/pallas/fused_mlp.py:1035",
              "train": "satnerf_tpu/ops/pallas/fused_mlp.py:1536",
              "sc": "satnerf_tpu/ops/pallas/fused_mlp.py:1638",
              "train_render": "satnerf_tpu/ops/pallas/fused_mlp.py:1290",
              "train_render_bwd": "satnerf_tpu/ops/pallas/fused_mlp.py:1312",
              "field_rays": "satnerf_tpu/ops/pallas/fused_mlp.py:635",
              "field_rays_bwd": "satnerf_tpu/ops/pallas/fused_mlp.py:657",
              "field_points": "satnerf_tpu/ops/pallas/fused_mlp.py:356",
              "field_points_bwd": "satnerf_tpu/ops/pallas/fused_mlp.py:526"}
_BWD_SRC = "satnerf_tpu_torch/csrc/dense_bwd_wgmma.cuh"  # the wgmma dgrad and wgrad
KERNELS = {  # name -> (source in the repo, the TPU kernels it replaces)
    "siren_dense": ("satnerf_tpu_torch/csrc/fused_render.cu", "render"),
    # its K = 0 kernel (layer 0, sky_0: the first layer of _trunk_fwd), counted
    # by MAINLOOP_LAUNCHES[("siren_dense", "k0")]
    "siren_dense_k0": ("satnerf_tpu_torch/csrc/fused_render.cu", "render", "train"),
    # with sigma noise it is also the forward of the training render
    "heads_composite": ("satnerf_tpu_torch/csrc/fused_render.cu", "render",
                        "train_render"),
    "composite_loss_bwd": ("satnerf_tpu_torch/csrc/fused_train.cu", "train"),
    # their wgmma kernels: the body shared with the nerf variant's backward
    "siren_dense_dgrad": (_BWD_SRC, "train"),
    "siren_dense_wgrad": (_BWD_SRC, "train"),
    # the narrow gradients db, dC, dE where the wgrad's GEMM does not form them
    # (layer 0, sky_0, t_grad; beside a wmma or simt GEMM), several layers a
    # launch; the column walk small_grads it replaced, kept to compare, is off
    # the path
    "narrow_grads": ("satnerf_tpu_torch/csrc/fused_train.cu", "train"),
    "small_grads": ("satnerf_tpu_torch/csrc/fused_train.cu", "train"),
    "sc_loss_bwd": ("satnerf_tpu_torch/csrc/fused_aux.cu", "sc"),
    "composite_bwd": ("satnerf_tpu_torch/csrc/fused_train.cu",
                      "train_render_bwd"),
    "field_heads": ("satnerf_tpu_torch/csrc/fused_field.cu", "field_rays",
                    "field_points"),
    "field_heads_bwd": ("satnerf_tpu_torch/csrc/fused_field.cu",
                        "field_rays_bwd", "field_points_bwd"),
}
NERF_TRAIN_KERNELS = ("nerf_dense", "nerf_composite_loss_bwd",
                      "nerf_dense_dgrad", "nerf_dense_wgrad")
NERF_FIELD_KERNELS = ("nerf_field_heads", "nerf_field_heads_bwd")
NERF_KERNELS = (NERF_TRAIN_KERNELS + ("nerf_heads_composite",)
                + NERF_FIELD_KERNELS)
_NERF_SRC = "satnerf_tpu_torch/csrc/fused_nerf.cu"
TPU_KERNEL.update({
    "nerf_train": "satnerf_tpu/ops/pallas/fused_nerf.py:594",
    "nerf_render": "satnerf_tpu/ops/pallas/fused_nerf.py:442",
    "nerf_points": "satnerf_tpu/ops/pallas/fused_nerf.py:180",
    "nerf_points_bwd": "satnerf_tpu/ops/pallas/fused_nerf.py:257"})
KERNELS.update({
    # the dense layers of all three chains: first on the path as K7's forward
    "nerf_dense": (_NERF_SRC, "nerf_train", "nerf_render", "nerf_points"),
    "nerf_composite_loss_bwd": (_NERF_SRC, "nerf_train"),
    "nerf_dense_dgrad": (_BWD_SRC, "nerf_train", "nerf_points_bwd"),
    "nerf_dense_wgrad": (_BWD_SRC, "nerf_train", "nerf_points_bwd"),
    "nerf_heads_composite": (_NERF_SRC, "nerf_render"),
    "nerf_field_heads": (_NERF_SRC, "nerf_points"),
    "nerf_field_heads_bwd": (_NERF_SRC, "nerf_points_bwd"),
})
# the draw kernel (phase 12): jax.random's draws of the JAX training step,
# which no Pallas kernel made; "replaces" names the JAX step's largest draw
DRAW_KERNEL = "jax_draws"
DRAW_SOURCE = "satnerf_tpu_torch/csrc/jax_draws.cu"
DRAW_REPLACES = "satnerf_tpu/render/sampling.py:31"
DRAW_REPLACES_ALSO = ["satnerf_tpu/train/system.py:674",
                      "satnerf_tpu/train/system.py:682",
                      "satnerf_tpu/render/render.py:82",
                      "satnerf_tpu/render/sampling.py:96",
                      "satnerf_tpu/train/system.py:795"]
# The draw kernel's bound is its instructions at the SM's issue rate. No
# published table gives Hopper an int32 rate; what holds for every pipe is
# the issue: four schedulers an SM, each one warp instruction a clock, 128
# thread-instructions a clock, integer or float, ALU or FMA pipe (an IMAD
# may carry an integer add). The float32 peak counts the same 128 lanes at
# two operations an FMA: 67e12 / 2 instructions a second at the H100 SXM's
# 1.98 GHz boost.
PEAK_FP32_FLOPS = 67e12
PEAK_ISSUE = PEAK_FP32_FLOPS / 2
# instructions a threefry word, at the fewest: twenty rounds of an add, a
# rotate (one funnel shift) and an xor (60); the counter's low word into x1
# (1); the five key injections into x1, which the next rotate needs alone
# (5; those into x0 ride in the next round's three-input add, but for the
# last, 1); the final xor (1). Loop, address and store instructions are not
# counted.
THREEFRY_OPS = 60 + 1 + 5 + 1 + 1
# a draw's instructions past its words, at the fewest, counted from
# csrc/jax_draws.cu: the uniform's shift-or (one LEA.HI), subtract, FMA and
# max (4); randint's three remainders at one each and its multiply-add (4);
# the normal, the uniform's 4 and 32 float instructions on the log1p branch
# its draws take most (erf_inv's square, log1p's 12 Horner FMAs past the
# constant first step, its square, cube, quotient, product and sum of three,
# erf_inv's shift, 8 Horner FMAs, the products by x and sqrt(2), the test
# for |x| = 1)
DRAW_EXTRA = {"bits": 0, "uniform": 4, "randint": 4, "normal": 36}
DRAW_WORDS = {"bits": 1, "uniform": 1, "randint": 2, "normal": 1}
LAYERS, FEAT, SAMPLES, TAU = 8, 512, 64, 4
NERF_FEAT, NERF_FREQ = 256, (10, 4)  # run 1/7: --model nerf --fc_units 256
BATCH = 1024  # rays a training step draws (--batch_size default)
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# the yardsticks of the bound_ms column.
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
N_RAYS = 8192 + 37
CHUNK = 65536  # rays a render_image chunk holds (--chunk default)
N_IMPORTANCE = 64  # phase 6: the fine pass marches SAMPLES + N_IMPORTANCE depths
# The kernels redesigned in the last two slices, and the shapes phase 2
# times them at, each with the time by CUDA events of the body it replaced,
# as PERF.md section 6 gives it (tools/outputs_torch.py time on the parent
# tree; NVIDIA H100 80GB HBM3, 700 W).
REDESIGNED = {
    "sc_loss_bwd": {
        "": (f"{BATCH} rays x {SAMPLES}",
             "the warp walk it replaced: 0.220 ms, PERF.md"),
        "s128_": (f"{BATCH} rays x {SAMPLES + N_IMPORTANCE}",
                  "the warp walk: 0.409 ms, PERF.md")},
    "field_heads": {
        "": (f"{BATCH} rays x {SAMPLES + N_IMPORTANCE}",
             "the warp-a-point body it replaced: 0.373 ms, PERF.md"),
        "k6_": (f"{BATCH * (SAMPLES + N_IMPORTANCE)} points, each its own ray",
                "the warp-a-point body: 0.484 ms, PERF.md")},
    "heads_composite": {
        "": (f"{CHUNK} rays x {SAMPLES} with weights",
             "the warp-a-ray walk it replaced: 5.95 ms, PERF.md"),
        "train_": (f"{BATCH} rays x {SAMPLES} with sigma noise",
                   "the warp-a-ray walk: 0.354 ms, PERF.md")},
    "field_heads_bwd": {
        "": (f"{BATCH} rays x {SAMPLES + N_IMPORTANCE}",
             "the warp-a-point body and field_sky_bwd it replaced: 0.614 ms, PERF.md"),
        "k6_": (f"{BATCH * (SAMPLES + N_IMPORTANCE)} points, each its own ray",
                "the two kernels: 0.808 ms, PERF.md")},
}
# phase 6's run past 256 samples a ray (a fine pass of 320) and phase 7's;
# phase 7's run at 512 samples (two chunks of nerf_composite_loss_bwd's block)
LONG_IMPORTANCE, NERF_LONG_SAMPLES, LONG_STEPS = 256, 320, 24
NERF_LONGER_SAMPLES = 512
# (rays, samples a ray) at which phase 2e times and holds the nerf variant's
# two per-ray kernels past two chunks of their block scans
NERF_SCAN_CASE = (256, 640)
# (points, F) at which phase 2e holds the per-point kernels against their
# plain versions in both dtypes: the fine and the coarse pass of a
# hierarchical batch at the nerf field's width, and the widest width the
# kernels take (Fh = F / 2)
NERF_POINT_CASES = ((BATCH * (SAMPLES + N_IMPORTANCE), NERF_FEAT),
                    (BATCH * SAMPLES, NERF_FEAT), (BATCH * 16, 512))
# (rays, samples a ray) at which phases 2b, 2c (SIREN) and 2e (nerf) hold
# every launch of their chains past 256 samples: the long runs' training
# batch, and a length whose shared memory needs the opt-in past 48 KB (the
# block body at 640 samples 51 KB, the warp body 102 KB; the nerf block at
# 512 samples 39 KB), at fewer rays
LONG_CASES = ((BATCH, SAMPLES + LONG_IMPORTANCE), (256, 640))
NERF_LONG_CASES = ((BATCH, NERF_LONG_SAMPLES), (256, NERF_LONGER_SAMPLES))
DEPTH_RANGE = 1.0  # far - near of the phase 2 rays

# Tolerances (kernel vs plain version, same inputs, same operand dtype).
# fp32: both sum the same fp32 products in another order; over 512-term dots,
#   eight layers and sin(30 x) at layer 0 that stays well below 1e-3.
# bf16: every activation is rounded to bf16 between layers. A different
#   summation order can move a pre-activation across a bf16 rounding boundary,
#   one step of 2^-8 relative, and such steps travel through the remaining
#   layers: 2e-2 on the [0, 1] products and 2e-2 * (far - near) on depth.
# siren_dense alone (one layer, same inputs): fp32 1e-4 abs + 1e-4 rel;
#   bf16 at most one bf16 rounding step, 2^-7 * |ref| + 1e-4.
# heads_composite alone: identical operands, fp32 arithmetic, 1e-4.
K2_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
# K1, each launch alone against its plain version on the same inputs: both
#   round the same operands at the same points and sum in fp32, the kernels
#   in another order and, across blocks, by atomicAdd in an order that
#   changes from run to run. Over sums of up to 66,368 points that stays
#   below 1e-3 of the tensor's largest entry. The cotangents that
#   composite_loss_bwd writes are products of a value rounded to bf16; where
#   the two sides land on either side of a rounding boundary the entry
#   differs by one bf16 step, 2^-7 of itself.
K1_STAGE_TOL = 1e-3
# K1 as a whole against the plain version (autograd through the field
#   module): fp32 differs by summation order only, 1e-3 of each gradient's
#   largest entry. In bf16 the forward's activations differ by rounding-
#   boundary steps that travel through the layers (see K2_TOL) and the
#   backward adds its own; the gradients agree to 5e-2 of each tensor's
#   largest entry, the loss parts to 2e-2 of their value.
K1_GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
K1_PART_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K1_RAYS = (1024, 1000 + 37)
# K5 and K6 are held as K4 is: each launch alone to K1_STAGE_TOL, the outputs
#   to K2_TOL (of the tensor's largest entry where that is above 1: sigma and
#   beta are not bounded by 1), every gradient to K1_GRAD_TOL.
# K3 and K4 are held as K1 is: each launch alone to K1_STAGE_TOL, the whole
#   chain against autograd through the field module to K1_GRAD_TOL on every
#   gradient (and exactly 0 where autograd has 0: the heads K3 leaves out),
#   K3's two terms to K1_PART_TOL, K4's products to K2_TOL.


def log(msg: str) -> None:
    print(msg, flush=True)


def phase0():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on "
              "a GPU", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    print(card, flush=True)
    return name, card


def phase1():
    sys.path.insert(0, REPO)
    from satnerf_tpu_torch.ops._build import build, load_library

    path, secs = build()
    load_library()
    log(f"phase 1: built {os.path.relpath(path, REPO)} in {secs:.1f} s")
    return secs


def _cuda_ms(fn, reps: int = 3) -> float:
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _inputs(n_rays: int, seed: int, device, samples: int = SAMPLES,
            jitter: str = "torch"):
    """Rays (o, d, sun, t) and depths z of a kernel check, from a seeded
    torch.Generator; the depths' jitter from it too, or with jitter="jax"
    the main path's draw, jax.random's uniform of the key of `seed`
    (ops/jax_draws.py, on the card)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    o = torch.rand(n_rays, 3, generator=g) - 0.5
    d = torch.randn(n_rays, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    sun = torch.randn(n_rays, 3, generator=g)
    sun = sun / sun.norm(dim=1, keepdim=True)
    t = torch.randn(n_rays, TAU, generator=g)
    near, far = torch.zeros(n_rays, 1), torch.ones(n_rays, 1)
    from satnerf_tpu_torch.render.sampling import stratified_zvals

    if jitter == "jax":
        from satnerf_tpu_torch.utils import jax_prng

        z = stratified_zvals(jax_prng.prng_key(seed), near.to(device),
                             far.to(device), samples)
        return [x.to(device) for x in (o, d, sun, t)] + [z]
    # the bins of stratified_zvals, jittered from this generator
    z = stratified_zvals(None, near, far, samples, perturb=0.0)
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    lower = torch.cat([z[:, :1], mid], -1)
    upper = torch.cat([mid, z[:, -1:]], -1)
    z = lower + (upper - lower) * torch.rand(z.shape, generator=g)
    return [x.to(device) for x in (o, d, sun, t, z)]


class StageCheck:
    """Stands in for siren_dense / heads_composite in the staged render:
    launches the kernel, runs the plain version on the same inputs, records
    the error against the stated tolerance."""

    def __init__(self, dtype):
        self.bf16 = str(dtype).endswith("bfloat16")
        self.err = {"siren_dense": 0.0, "heads_composite": 0.0,
                    "siren_dense_vs_wmma": 0.0, "siren_dense_k0": 0.0,
                    "siren_dense_k0_vs_v1": 0.0}
        self.bad = []

    def dense(self, *args, **kw):
        from satnerf_tpu_torch.ops.fused_mlp import (siren_dense,
                                                     siren_dense_reference)

        took = _took("siren_dense")
        y = siren_dense(*args, **kw)
        ref = siren_dense_reference(*args, **kw).float()
        diff = (y.float() - ref).abs()
        tol = (2.0 ** -7 * ref.abs() + 1e-4 if self.bf16
               else 1e-4 * ref.abs() + 1e-4)
        loop = took()
        for k in ("siren_dense",) + (("siren_dense_k0",) if loop == "k0" else ()):
            self.err[k] = max(self.err[k], diff.max().item())
        if bool((diff > tol).any()):
            self.bad.append(f"siren_dense extra={kw.get('extra')} "
                            f"max err {diff.max().item():.3g}")
        if loop == "k0":
            _k0_vs_v1(self, (y,), (siren_dense(*args, mainloop="k0_v1", **kw),), kw)
        if loop == "wgmma":  # the same launch on wmma: one rounding step
            other = siren_dense(*args, mainloop="wmma", **kw).float()
            d = (y.float() - other).abs()
            self.err["siren_dense_vs_wmma"] = max(self.err["siren_dense_vs_wmma"],
                                                  d.max().item())
            if bool((d > 2.0 ** -7 * other.abs() + 1e-4).any()):
                self.bad.append(f"siren_dense extra={kw.get('extra')} wgmma vs "
                                f"wmma max err {d.max().item():.3g}")
        return y

    def heads(self, *args, **kw):
        from satnerf_tpu_torch.ops.fused_mlp import (heads_composite,
                                                     heads_composite_reference)

        out, w = heads_composite(*args, **kw)
        ref, ref_w = heads_composite_reference(*args, **kw)
        e = (out - ref).abs().max().item()
        if w is not None:
            e = max(e, (w - ref_w).abs().max().item())
        self.err["heads_composite"] = max(self.err["heads_composite"], e)
        if e > 1e-4:
            self.bad.append(f"heads_composite max err {e:.3g}")
        return out, w


def _k0_vs_v1(chk, outs, olds, kw) -> None:
    """siren_dense's K = 0 kernel against the first one (k0_v1) on the same
    inputs: Y (and the slope) equal to the bit."""
    d = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs, olds))
    chk.err["siren_dense_k0_vs_v1"] = max(chk.err["siren_dense_k0_vs_v1"], d)
    if not all(torch_equal(a, b) for a, b in zip(outs, olds)):
        chk.bad.append(f"siren_dense k0 extra={kw.get('extra')} differs from "
                       f"k0_v1 by {d:.3g}: not the same bits")


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


# the three kernels with a wgmma mainloop: each such launch is also held
# against the same launch on the wmma mainloop
VS_WMMA = ("siren_dense_vs_wmma", "siren_dense_dgrad_vs_wmma",
           "siren_dense_wgrad_vs_wmma")
# the two kernels with two bodies: each launch (on the default body, a block a
# ray) is also held against the same launch on the warp a ray it replaced
# (loss sums, every cotangent, dWn and dbn within 1e-3 of the tensor's largest
# entry; a cotangent entry may also differ by one bf16 step of itself or, d_r
# and d_skyh, of one of their three terms: the two bodies sum in another order
# and may round a cotangent to either side of a bf16 boundary)
VS_WARP = ("composite_loss_bwd_vs_warp", "composite_bwd_vs_warp")
# the two kernels redesigned beside the ones they replaced: each launch is also
# held against the same launch on the old kernel (siren_dense's K = 0 kernel
# against k0_v1 to the bit; the narrow gradients against the column walk
# small_grads, db, dC and dE within 1e-4 of the tensor's largest entry, dW
# within K1_STAGE_TOL: the wgrad's fp32 atomics across point ranges add in
# an order that changes from run to run), and the old kernels against the
# plain version
NEW_VS_OLD = ("siren_dense_k0", "siren_dense_k0_vs_v1", "narrow_grads_vs_walk",
              "small_grads")
NARROW_VS_WALK_TOL = 1e-4
# the chain's joined narrow_grads launch (several layers' jobs in one grid):
# each job also against the same job launched alone, db, dC and dE within
# NARROW_VS_WALK_TOL (the atomics add in another order)
JOINED_VS_ALONE = "narrow_grads_joined_vs_alone"
COMPOSITE_KERNELS = ("composite_loss_bwd", "composite_bwd")


def _counts() -> dict:
    """Every kernel's launches (satnerf_tpu_torch.ops.launch_counts), the K = 0
    kernel of siren_dense apart as "siren_dense_k0" and the draw kernel's
    among them (the draws run on the card on every path)."""
    from satnerf_tpu_torch.ops import launch_counts

    return launch_counts()


def _reset_launches() -> None:
    """Every count _counts reads to 0."""
    from satnerf_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def _field_launches(launches: dict) -> dict:
    """The launches of the field's kernels: all but the draws'."""
    return {k: v for k, v in launches.items() if k != DRAW_KERNEL}


def _took(name: str):
    """A function that names the mainloop the one launch of `name` made
    between this call and its own call took."""
    from satnerf_tpu_torch.ops import fused_mlp as FM

    before = dict(FM.MAINLOOP_LAUNCHES)
    return lambda: next(k[1] for k, v in FM.MAINLOOP_LAUNCHES.items()
                        if k[0] == name and v > before.get(k, 0))


def _on_block(what: str, launches: dict, kernels=COMPOSITE_KERNELS) -> dict:
    """The launches of a run of composite_loss_bwd / composite_bwd by body:
    every one on the default body, a block a ray, or the run fails."""
    from satnerf_tpu_torch.ops import fused_mlp as FM

    by = {k: {b: n for (kk, b), n in FM.BODY_LAUNCHES.items() if kk == k}
          for k in kernels}
    for k, bodies in by.items():
        if launches[k] and bodies != {"block": launches[k]}:
            raise SystemExit(f"{what} failed: {k} launched {launches[k]} times, "
                             f"by body {bodies}: not every one a block a ray")
    return by


def _rel_err(got, ref) -> float:
    """max |got - ref| relative to the reference tensor's largest entry."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


class TrainCheck:
    """Stands in for the four stage functions of the training chain
    (ops/fused_mlp.TrainOps): launches each kernel, runs its plain version
    on the same inputs and records the error against K1_STAGE_TOL."""

    def __init__(self, dtype):
        self.bf16 = str(dtype).endswith("bfloat16")
        self.err = dict.fromkeys(TRAIN_KERNELS + AUX_KERNELS + FIELD_KERNELS
                                 + ("heads_composite",) + VS_WMMA + VS_WARP
                                 + NEW_VS_OLD + (JOINED_VS_ALONE,), 0.0)
        self.bad = []
        self._held = []  # checks of wgrad launches whose narrow job was deferred

    def _hold(self, kernel, what, got, ref, tol_rel_max, elementwise=False,
              terms: int = 1):
        """terms: how many products of a rounded cotangent the entry sums
        (d_r sums three, one a color channel)."""
        if ref is None:
            return
        got, ref = got.float(), ref.float()
        diff = (got - ref).abs()
        scale = ref.abs().max().clamp_min(1e-30)
        self.err[kernel] = max(self.err[kernel], diff.max().item())
        lim = tol_rel_max * scale
        if elementwise and self.bf16:  # one bf16 rounding step of the entry
            lim = lim + 2.0 ** -7 * ref.abs()
            if terms > 1:
                # or of one of its terms, which the entry may be smaller
                # than: a step of the tensor's largest entry at most
                lim = lim + 2.0 ** -8 * scale
        if bool((diff > lim).any()):
            self.bad.append(f"{kernel} {what}: max err {diff.max().item():.3g} "
                            f"(tensor max {scale.item():.3g})")

    def dense(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_mlp as FM

        took = _took("siren_dense")
        out = FM.siren_dense(*args, **kw)
        ref = FM.siren_dense_reference(*args, **kw)
        loop = took()
        if loop == "wgmma":  # the same launch on the wmma mainloop
            self._vs_wmma_dense(out, FM.siren_dense(*args, mainloop="wmma", **kw),
                                kw)
        if loop == "k0":  # the same launch on the first K = 0 kernel
            old = FM.siren_dense(*args, mainloop="k0_v1", **kw)
            _k0_vs_v1(self, out if kw.get("save") else (out,),
                      old if kw.get("save") else (old,), kw)
        if not kw.get("save"):
            out, ref = (out, None), (ref, None)
        y, y_ref = out[0].float(), ref[0].float()
        diff = (y - y_ref).abs()
        tol = (2.0 ** -7 * y_ref.abs() + 1e-4 if self.bf16
               else 1e-4 * y_ref.abs() + 1e-4)
        for k in ("siren_dense",) + (("siren_dense_k0",) if loop == "k0" else ()):
            self.err[k] = max(self.err[k], diff.max().item())
        if bool((diff > tol).any()):
            self.bad.append(f"siren_dense extra={kw.get('extra')} max err "
                            f"{diff.max().item():.3g}")
        if kw.get("save"):
            w0 = kw.get("w0", 1.0)
            e = (out[1] - ref[1]).abs().max().item()
            if e > 1e-5 * w0 * w0 + 1e-4:
                self.bad.append(f"siren_dense slope w0={w0} max err {e:.3g}")
            return out
        return out[0]

    def _vs_warp(self, kernel, out, fn, args, kw):
        """The launch on the warp-a-ray body, the same inputs (VS_WARP)."""
        other = fn(*args, body="warp", **kw)
        for k, v in other.items():
            self._hold(f"{kernel}_vs_warp", k, out[k], v, K1_STAGE_TOL,
                       elementwise=k.startswith("d_"),
                       terms=3 if k in ("d_r", "d_skyh") else 1)

    # d_skyh against the plain version: both round the sky head's three
    # cotangents g_c = d_sky_c * s_c (1 - s_c) to bf16 before their products
    # with the weight rows (the kernel's gb_sky; the plain version's
    # rounded_matmul), but each forms g_c from its own fp32 sums over the
    # ray's samples. Where g_c lies at a bf16 boundary the two round it to
    # neighbours, so a term g_c * w_ck moves by one bf16 step of itself, and
    # the entry, a sum of three such terms that may cancel, by one step of a
    # term, which the entry's own step need not cover: terms=3, as the warp
    # body check (VS_WARP) allows for the same sums.
    def _hold_cotangents(self, kernel, out, ref):
        for k in ref:
            self._hold(kernel, k, out[k], ref[k], K1_STAGE_TOL,
                       elementwise=k.startswith("d_"),
                       terms=3 if k == "d_skyh" else 1)

    def composite(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_mlp as FM

        out = FM.composite_loss_bwd(*args, **kw)
        self._hold_cotangents("composite_loss_bwd", out,
                              FM.composite_loss_bwd_reference(*args, **kw))
        self._vs_warp("composite_loss_bwd", out, FM.composite_loss_bwd, args, kw)
        return out

    def composite_given(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_mlp as FM

        out = FM.composite_bwd(*args, **kw)
        self._hold_cotangents("composite_bwd", out,
                              FM.composite_bwd_reference(*args, **kw))
        self._vs_warp("composite_bwd", out, FM.composite_bwd, args, kw)
        return out

    def sc(self, *args):
        from satnerf_tpu_torch.ops import fused_mlp as FM

        out = FM.sc_loss_bwd(*args)
        ref = FM.sc_loss_bwd_reference(*args)
        for k in ref:
            self._hold("sc_loss_bwd", k, out[k], ref[k], K1_STAGE_TOL,
                       elementwise=k.startswith("d_"))
        return out

    def field_heads(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_mlp as FM

        out = FM.field_heads(*args, **kw)
        ref = FM.field_heads_reference(*args, **kw)
        self._hold("field_heads", "outputs", out, ref, 1e-4)
        return out

    def field_heads_bwd(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_mlp as FM

        out = FM.field_heads_bwd(*args, **kw)
        ref = FM.field_heads_bwd_reference(*args, **kw)
        for k in ref:
            self._hold("field_heads_bwd", k, out[k], ref[k], K1_STAGE_TOL,
                       elementwise=k.startswith("d_"),
                       terms=3 if k == "d_r" else 1)
        return out

    def heads(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_mlp as FM

        out, _ = FM.heads_composite(*args, **kw)
        ref, _ = FM.heads_composite_reference(*args, **kw)
        self._hold("heads_composite", "products", out, ref, 1e-4)
        return out, None

    def dgrad(self, dy, slope, weight, out=None):
        from satnerf_tpu_torch.ops import fused_mlp as FM

        base = None if out is None else out.clone()  # the reference adds onto it
        base_wmma = None if out is None else out.clone()
        took = _took("siren_dense_dgrad")
        got = FM.siren_dense_dgrad(dy, slope, weight, out=out)
        ref = FM.siren_dense_dgrad_reference(dy, slope, weight, out=base)
        what = f"N={dy.shape[1]} K={weight.shape[0]}"
        self._hold("siren_dense_dgrad", what, got, ref, K1_STAGE_TOL)
        if took() == "wgmma":  # the same launch on the wmma mainloop
            other = FM.siren_dense_dgrad(dy, slope, weight, out=base_wmma,
                                         mainloop="wmma")
            self._hold("siren_dense_dgrad_vs_wmma", what, got, other, K1_STAGE_TOL)
        return got

    def _vs_wmma_dense(self, out, other, kw):
        """siren_dense's rule (wgmma) against its wmma mainloop: Y within one
        rounding step, the slope as against the plain version."""
        if not kw.get("save"):
            out, other = (out, None), (other, None)
        d = (out[0].float() - other[0].float()).abs()
        self.err["siren_dense_vs_wmma"] = max(self.err["siren_dense_vs_wmma"],
                                              d.max().item())
        if bool((d > 2.0 ** -7 * other[0].float().abs() + 1e-4).any()):
            self.bad.append(f"siren_dense extra={kw.get('extra')} wgmma vs wmma "
                            f"max err {d.max().item():.3g}")
        if kw.get("save"):
            w0 = kw.get("w0", 1.0)
            e = (out[1] - other[1]).abs().max().item()
            if e > 1e-5 * w0 * w0 + 1e-4:
                self.bad.append(f"siren_dense slope wgmma vs wmma max err {e:.3g}")

    def wgrad(self, *args, defer=None, **kw):
        from satnerf_tpu_torch.ops import fused_mlp as FM

        loop = _took("siren_dense_wgrad")
        narrow, queued = FM.LAUNCHES["narrow_grads"], len(defer or ())
        got = FM.siren_dense_wgrad(*args, defer=defer, **kw)
        loop = loop() if args[0] is not None else "k0"
        # its narrow_grads job: launched here, or appended to the chain's list
        # (defer) for the joined launch, which self.narrow holds
        asked = (FM.LAUNCHES["narrow_grads"] > narrow if defer is None
                 else len(defer) > queued)
        ref = FM.siren_dense_wgrad_reference(*args, **kw)
        extra, ew = kw.get("extra"), kw.get("extra_weight")
        what = f"extra={extra} on {loop}"
        # what narrow_grads formed: db where the GEMM did not sum it, dC where
        # the GEMM did not fold it, dE where asked for
        mode = FM.small_grads_mode(loop, extra, "rays",
                                   0 if ew is None else ew.shape[0])
        by_narrow = (({"db"} if mode == "db" else set())
                     | ({"dC"} if mode in ("db", "dc") else set())
                     | ({"dE"} if kw.get("extra_grad") else set()))
        if asked != bool(by_narrow):
            self.bad.append(f"siren_dense_wgrad {what}: narrow_grads job "
                            f"{asked}, asked for {sorted(by_narrow)}")
        # the column walk it replaced and the wmma mainloop, on the same
        # inputs, now; held once got is filled (after the joined launch where
        # the job was deferred)
        walked = FM.siren_dense_wgrad(*args, narrow="walk", **kw)
        other = (FM.siren_dense_wgrad(*args, mainloop="wmma", **kw)
                 if loop == "wgmma" else None)

        def hold():
            for name, a, b in zip(("dW", "db", "dC", "dE"), got, ref):
                self._hold("siren_dense_wgrad", f"{name} {what}", a, b,
                           K1_STAGE_TOL)
                if name in by_narrow:
                    self._hold("narrow_grads", f"{name} {what}", a, b,
                               K1_STAGE_TOL)
            for name, a, b, r in zip(("dW", "db", "dC", "dE"), got, walked, ref):
                self._hold("narrow_grads_vs_walk", f"{name} {what}", a, b,
                           K1_STAGE_TOL if name == "dW" else NARROW_VS_WALK_TOL)
                if name != "dW":
                    self._hold("small_grads", f"{name} {what}", b, r, K1_STAGE_TOL)
            if other is not None:  # the same launch on the wmma mainloop
                for name, a, b in zip(("dW", "db", "dC", "dE"), got, other):
                    self._hold("siren_dense_wgrad_vs_wmma", f"{name} {what}", a,
                               b, K1_STAGE_TOL)

        if defer is not None and asked:
            self._held.append(hold)
        else:
            hold()
        return got

    def narrow(self, jobs):
        """The chain's joined narrow_grads launch of the jobs its wgrad
        launches deferred (sky_0's db and dC, beta_0's t_grad; sun_v_0's dE
        in K6), as the main path runs it; then each job against its plain
        version and against the same job launched alone (JOINED_VS_ALONE),
        and the deferred wgrad launches' own checks."""
        from satnerf_tpu_torch.ops import fused_mlp as FM

        alone = [FM.NarrowJob(j.dy, j.slope, j.rays16, j.samples, extra=j.extra,
                              extra_weight=j.extra_weight, z=j.z, dtype=j.dtype,
                              db=j.db is not None, dc=j.dc is not None,
                              de=j.de is not None) for j in jobs]
        before = FM.LAUNCHES["narrow_grads"]
        FM.narrow_grads(jobs)
        if FM.LAUNCHES["narrow_grads"] - before != 1:
            self.bad.append(f"narrow_grads: {len(jobs)} jobs were not one launch")
        for job, one in zip(jobs, alone):
            FM.narrow_grads([one])
            what = f"extra={job.extra}, joined with {len(jobs) - 1} more"
            for name, a, b, r in zip(("db", "dC", "dE"),
                                     (job.db, job.dc, job.de),
                                     (one.db, one.dc, one.de),
                                     FM.narrow_grads_reference(job)):
                if a is not None:
                    self._hold("narrow_grads", f"{name} {what}", a, r,
                               K1_STAGE_TOL)
                    self._hold(JOINED_VS_ALONE, f"{name} {what}", a, b,
                               NARROW_VS_WALK_TOL)
        held, self._held = self._held, []
        for hold in held:
            hold()


# The nerf variant (K7, K8, K9) is held as the SIREN chains are: each launch
#   alone to K1_STAGE_TOL (the dense layer to one rounding step), the products
#   to K2_TOL. Each launch sees the inputs the chain gave it, so the relu's
#   mask comes from the same stored activation on both sides. The whole chains
#   against autograd through the field module do not have that: the two
#   forwards sum in another order, and of the 134 M relu units of a batch of
#   65,536 points a few tens have a pre-activation within an ulp of 0 and land
#   on either side of the kink. Each such unit moves one point's term of one
#   column of a weight gradient, about 1 / sqrt(65,536) of that column's sum:
#   the fp32 gradients are held to 1e-2 of each tensor's largest entry, the
#   bf16 gradients to K1_GRAD_TOL's 5e-2, which rounding steps already need.
NERF_GRAD_TOL = {"float32": 1e-2, "bfloat16": 5e-2}
NERF_CASES = ((K1_RAYS[0], 64, True), (K1_RAYS[1], 72, False),
              (K1_RAYS[1], 128, True))  # rays, samples a ray, sigma noise


# the nerf variant's three kernels with a wgmma mainloop: each such launch is
# also held against the same launch on wmma (nerf_dense's Y to one bf16
# rounding step; the wmma wgrad sums db by nerf_bias_grad, held against the
# plain version's db where it ran)
NERF_VS_WMMA = ("nerf_dense_vs_wmma", "nerf_dense_dgrad_vs_wmma",
                "nerf_dense_wgrad_vs_wmma")


class NerfCheck(TrainCheck):
    """Stands in for the stage functions of the nerf chains
    (ops/fused_nerf.NerfOps): launches each kernel, runs its plain version on
    the same inputs and records the error."""

    def __init__(self, dtype):
        self.bf16 = str(dtype).endswith("bfloat16")
        self.err = dict.fromkeys(NERF_KERNELS + NERF_VS_WMMA
                                 + ("nerf_bias_grad",), 0.0)
        self.bad = []

    def dense(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_nerf as FN

        took = _took("nerf_dense")
        y = FN.nerf_dense(*args, **kw)
        ref = FN.nerf_dense_reference(*args, **kw).float()
        diff = (y.float() - ref).abs()
        tol = (2.0 ** -7 * ref.abs() + 1e-4 if self.bf16
               else 1e-4 * ref.abs() + 1e-4)
        self.err["nerf_dense"] = max(self.err["nerf_dense"], diff.max().item())
        what = f"nerf_dense enc={kw.get('enc')} act={kw.get('act')}"
        if bool((diff > tol).any()):
            self.bad.append(f"{what} max err {diff.max().item():.3g}")
        if took() == "wgmma":  # the same launch on wmma: one rounding step
            other = FN.nerf_dense(*args, mainloop="wmma", **kw).float()
            d = (y.float() - other).abs()
            self.err["nerf_dense_vs_wmma"] = max(self.err["nerf_dense_vs_wmma"],
                                                 d.max().item())
            if bool((d > 2.0 ** -7 * other.abs() + 1e-4).any()):
                self.bad.append(f"{what} wgmma vs wmma max err {d.max().item():.3g}")
        return y

    def heads(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_nerf as FN

        out, w = FN.nerf_heads_composite(*args, **kw)
        ref, ref_w = FN.nerf_heads_composite_reference(*args, **kw)
        self._hold("nerf_heads_composite", "products", out, ref, 1e-4)
        self._hold("nerf_heads_composite", "weights", w, ref_w, 1e-4)
        return out, w

    def _hold_adjoint(self, kernel, out, ref):
        for k in ref:
            self._hold(kernel, k, out[k], ref[k], K1_STAGE_TOL,
                       elementwise=k.startswith("d_"),
                       terms=3 if k == "d_r" else 1)
        return out

    def composite(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_nerf as FN

        return self._hold_adjoint(
            "nerf_composite_loss_bwd", FN.nerf_composite_loss_bwd(*args, **kw),
            FN.nerf_composite_loss_bwd_reference(*args, **kw))

    def field_heads(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_nerf as FN

        out = FN.nerf_field_heads(*args, **kw)
        self._hold("nerf_field_heads", "outputs", out,
                   FN.nerf_field_heads_reference(*args, **kw), 1e-4)
        return out

    def field_heads_bwd(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_nerf as FN

        return self._hold_adjoint(
            "nerf_field_heads_bwd", FN.nerf_field_heads_bwd(*args, **kw),
            FN.nerf_field_heads_bwd_reference(*args, **kw))

    def dgrad(self, dy, y, weight, out=None):
        from satnerf_tpu_torch.ops import fused_nerf as FN

        base = None if out is None else out.clone()
        base_wmma = None if out is None else out.clone()
        took = _took("nerf_dense_dgrad")
        got = FN.nerf_dense_dgrad(dy, y, weight, out=out)
        ref = FN.nerf_dense_dgrad_reference(dy, y, weight, out=base)
        what = f"N={dy.shape[1]} K={weight.shape[0]}"
        self._hold("nerf_dense_dgrad", what, got, ref, K1_STAGE_TOL)
        if took() == "wgmma":  # the same launch on the wmma mainloop
            other = FN.nerf_dense_dgrad(dy, y, weight, out=base_wmma,
                                        mainloop="wmma")
            self._hold("nerf_dense_dgrad_vs_wmma", what, got, other, K1_STAGE_TOL)
        return got

    def wgrad(self, *args, **kw):
        from satnerf_tpu_torch.ops import fused_nerf as FN

        loop = _took("nerf_dense_wgrad")
        got = FN.nerf_dense_wgrad(*args, **kw)
        loop = loop()
        ref = FN.nerf_dense_wgrad_reference(*args, **kw)
        what = f"enc={kw.get('enc')} on {loop}"
        for name, a, b in zip(("dW", "db", "dC"), got, ref):
            self._hold("nerf_dense_wgrad", f"{name} {what}", a, b, K1_STAGE_TOL)
        if FN.nerf_bias_grad_runs(loop):  # db came from nerf_bias_grad
            self._hold("nerf_bias_grad", f"db {what}", got[1], ref[1], K1_STAGE_TOL)
        if loop == "wgmma":  # the same launch on the wmma mainloop
            other = FN.nerf_dense_wgrad(*args, mainloop="wmma", **kw)
            self._hold("nerf_bias_grad", f"db {what}", other[1], ref[1],
                       K1_STAGE_TOL)
            for name, a, b in zip(("dW", "db", "dC"), got, other):
                self._hold("nerf_dense_wgrad_vs_wmma", f"{name} {what}", a, b,
                           K1_STAGE_TOL)
        return got


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(nbytes: int, flops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the card's memory rate
    and operations over its bf16 tensor-core peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _time_kernels(packed: dict, dev) -> dict:
    """Each kernel alone in bf16 at the shape its main path gives it: the
    serving kernels at one chunk of CHUNK rays x 64 samples (4.19 M points),
    the training kernels at one batch of BATCH rays x 64 (65,536 points);
    for the dense kernels the 512 x 512 skip layer (the wgrad: a 512 x 512
    trunk layer, and small_grads alone at layer 0's launch). Returns name ->
    {ms, plain_ms, library_ms, bound_ms, bound_by}, and for siren_dense and
    siren_dense_dgrad and siren_dense_wgrad also mainloop (the rule's),
    wgmma_ms and wmma_ms. bound_ms counts every
    input read once and every output written once, and 2*P*K*N operations
    for the dense kernels; library_ms times the one PyTorch call that
    computes the same function in the kernel's dtype, where there is one.
    composite_loss_bwd and composite_bwd also get block_ms and warp_ms, both
    bodies on the same inputs."""
    import torch
    from satnerf_tpu_torch.ops import fused_mlp as FM

    dtype, fh = torch.bfloat16, FEAT // 2
    g = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape, to=dtype):
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1).to(to)

    def entry(fn, plain, library, nbytes, flops):
        bound_ms, by = _bound(nbytes, flops)
        return {"ms": _cuda_ms(fn), "plain_ms": _cuda_ms(plain),
                "library_ms": None if library is None else _cuda_ms(library),
                "bound_ms": bound_ms, "bound_by": by}

    def mainloops(name, fn, e):
        """e, with the mainloop the rule took (fn(None)) and both tensor-core
        mainloops timed on the same inputs in turns: wmma, wgmma, wgmma,
        wmma."""
        before = dict(FM.MAINLOOP_LAUNCHES)
        fn(None)
        e["mainloop"] = next(k[1] for k, v in FM.MAINLOOP_LAUNCHES.items()
                             if k[0] == name and v > before.get(k, 0))
        ms = {m: [] for m in FM.MAINLOOPS}
        for m in ("wmma", "wgmma", "wgmma", "wmma"):
            ms[m].append(_cuda_ms(lambda: fn(m)))
        e.update({f"{m}_ms": sum(v) / len(v) for m, v in ms.items()})
        return e

    def bodies(fn, e):
        """e, with both bodies of a composite kernel timed on the same inputs
        in turns: warp, block, block, warp."""
        ms = {b: [] for b in FM.COMPOSITE_BODIES}
        for b in ("warp", "block", "block", "warp"):
            ms[b].append(_cuda_ms(lambda: fn(b)))
        e.update({f"{b}_ms": sum(v) / len(v) for b, v in ms.items()})
        return e

    w, bias, c = packed["B"][3], packed["bt"][4], packed["C"]
    out = {}

    # ---- serving shapes
    o, d, sun, t, z = _inputs(CHUNK, 3, dev)
    rays16 = FM.pack_rays(o, d, sun, t, TAU)
    p = CHUNK * SAMPLES
    h = rand(p, FEAT)
    args = (h, w, bias, rays16, SAMPLES)
    dkw = dict(extra="xyz", extra_weight=c, z=z)
    y_bytes = p * FEAT * 2
    out["siren_dense"] = mainloops("siren_dense", lambda m: FM.siren_dense(
        *args, mainloop=m, **dkw), entry(
        lambda: FM.siren_dense(*args, **dkw),
        lambda: FM.siren_dense_reference(*args, **dkw),
        lambda: torch.sin(torch.addmm(bias.to(dtype), h, w)),
        _nbytes(h, w, bias, rays16, z, c) + y_bytes,
        2.0 * p * FEAT * (FEAT + 3)))
    hs = [rand(p, fh) for _ in range(3)]
    skyh = rand(CHUNK, fh).abs()
    hargs = (h, *hs, skyh, packed["wn"], packed["bn"], z)
    hkw = dict(rgb_padding=0.001, return_weights=True)
    out["heads_composite"] = entry(
        lambda: FM.heads_composite(*hargs, **hkw),
        lambda: FM.heads_composite_reference(*hargs, **hkw), None,
        _nbytes(*hargs) + CHUNK * 16 * 4 + CHUNK * SAMPLES * 4,
        2.0 * p * (FEAT + 5 * fh))
    del h, hs, skyh, args, hargs

    # ---- training shapes
    o, d, sun, t, z = _inputs(BATCH, 3, dev)
    rays16 = FM.pack_rays(o, d, sun, t, TAU)
    p = BATCH * SAMPLES
    h = rand(p, FEAT)
    args = (h, w, bias, rays16, SAMPLES)
    dkw = dict(extra="xyz", extra_weight=c, z=z, save=True)
    t_entry = mainloops("siren_dense", lambda m: FM.siren_dense(
        *args, mainloop=m, **dkw), entry(
        lambda: FM.siren_dense(*args, **dkw),
        lambda: FM.siren_dense_reference(*args, **dkw),
        lambda: torch.sin(torch.addmm(bias.to(dtype), h, w)),
        _nbytes(h, w, bias, rays16, z, c) + p * FEAT * (2 + 4),
        2.0 * p * FEAT * (FEAT + 3)))
    out["siren_dense"].update({f"train_{k}": v for k, v in t_entry.items()})

    # siren_dense's K = 0 kernel: layer 0 with the saved slope (E = xyz, w0
    # 30; Y bf16 and the slope fp32 written, 201 MB) beside the first K = 0
    # kernel (k0_v1), in turns; and sky_0 (once a ray, relu, no slope). No
    # one PyTorch call computes sin(30 (b + E C)) and its slope.
    k0kw = dict(extra="xyz", extra_weight=packed["A"], z=z, w0=30.0, save=True)
    k0args = (None, None, packed["bt"][0], rays16, SAMPLES)
    k0 = entry(lambda: FM.siren_dense(*k0args, **k0kw),
               lambda: FM.siren_dense_reference(*k0args, **k0kw), None,
               _nbytes(packed["bt"][0], rays16, z, packed["A"]) + p * FEAT * (2 + 4),
               2.0 * p * FEAT * 3)
    ms = {"k0": [], "k0_v1": []}
    for m in ("k0_v1", "k0", "k0", "k0_v1"):
        ms[m].append(_cuda_ms(lambda: FM.siren_dense(*k0args, mainloop=m, **k0kw)))
    k0.update({f"{m}_ms": sum(v) / len(v) for m, v in ms.items()})
    new, old = (FM.siren_dense(*k0args, mainloop=m, **k0kw) for m in ("k0", "k0_v1"))
    k0["bit_equal_to_v1"] = all(bool(torch.equal(a, b)) for a, b in zip(new, old))
    skykw = dict(extra="sun", extra_weight=packed["Wsky0"], act="relu")
    skyargs = (None, None, packed["bsky0"], rays16, 1)
    sky = entry(lambda: FM.siren_dense(*skyargs, **skykw),
                lambda: FM.siren_dense_reference(*skyargs, **skykw), None,
                _nbytes(packed["bsky0"], rays16, packed["Wsky0"]) + BATCH * fh * 2,
                2.0 * BATCH * fh * 3)
    sky["k0_v1_ms"] = _cuda_ms(lambda: FM.siren_dense(*skyargs, mainloop="k0_v1",
                                                      **skykw))
    k0.update({f"sky0_{k}": v for k, v in sky.items()})
    out["siren_dense_k0"] = k0
    del new, old

    dy, slope = rand(p, FEAT, to=torch.float32), rand(p, FEAT, to=torch.float32)
    gb = (dy * slope).to(dtype)
    out["siren_dense_dgrad"] = mainloops(
        "siren_dense_dgrad",
        lambda m: FM.siren_dense_dgrad(dy, slope, w, mainloop=m), entry(
            lambda: FM.siren_dense_dgrad(dy, slope, w),
            lambda: FM.siren_dense_dgrad_reference(dy, slope, w),
            lambda: gb @ w.t(),
            _nbytes(dy, slope, w) + p * FEAT * 4, 2.0 * p * FEAT * FEAT))
    # the wgrad's GEMM with its bias sum, a trunk layer (no E operand): on
    # wgmma db comes from its epilogue, on wmma from small_grads
    wargs = (h, dy, slope, rays16, SAMPLES)
    out["siren_dense_wgrad"] = mainloops(
        "siren_dense_wgrad",
        lambda m: FM.siren_dense_wgrad(*wargs, mainloop=m), entry(
            lambda: FM.siren_dense_wgrad(*wargs),
            lambda: FM.siren_dense_wgrad_reference(*wargs),
            lambda: h.t() @ gb,
            _nbytes(h, dy, slope) + (FEAT * FEAT + FEAT) * 4,
            2.0 * p * FEAT * FEAT))
    got = {m: FM.siren_dense_wgrad(*wargs, mainloop=m) for m in FM.MAINLOOPS}
    ref = FM.siren_dense_wgrad_reference(*wargs)
    out["siren_dense_wgrad"]["dw_rel_err"] = {
        "wgmma_vs_plain": _rel_err(got["wgmma"][0], ref[0]),
        "wgmma_vs_wmma": _rel_err(got["wgmma"][0], got["wmma"][0]),
        "db_wgmma_vs_plain": _rel_err(got["wgmma"][1], ref[1])}
    # the skip layer's wgrad with its E operand (xyz): dC folded into the
    # wgmma epilogue, against the same launch with the column walk for dC
    # (GEMM + small_grads), in turns; and dW, db of the two to the bit where
    # the atomics' order is fixed (every point in one block's range)
    sargs, skw = (h, dy, slope, rays16, SAMPLES), dict(extra="xyz",
                                                       extra_weight=c, z=z)
    ms = {"rays": [], "walk": []}
    for m in ("walk", "rays", "rays", "walk"):
        ms[m].append(_cuda_ms(lambda: FM.siren_dense_wgrad(*sargs, narrow=m, **skw)))
    out["siren_dense_wgrad"].update({"fold_ms": sum(ms["rays"]) / 2,
                                     "unfolded_ms": sum(ms["walk"]) / 2})
    n1 = FM.FOLD_SPLIT // SAMPLES
    one = (h[:n1 * SAMPLES], dy[:n1 * SAMPLES], slope[:n1 * SAMPLES],
           rays16[:n1], SAMPLES)
    okw = dict(extra="xyz", extra_weight=c, z=z[:n1], split=FM.FOLD_SPLIT)
    a, b = (FM.siren_dense_wgrad(*one, narrow=m, **okw) for m in ("rays", "walk"))
    out["siren_dense_wgrad"]["fold_bits"] = {
        "dw_equal": bool(torch.equal(a[0], b[0])),
        "db_equal": bool(torch.equal(a[1], b[1])),
        "dc_rel_err": _rel_err(a[2], b[2])}
    del a, b, one
    # the narrow gradients alone: layer 0's launch (no X: db, and dC of xyz),
    # the bigger of the two a main-path step, beside the column walk it
    # replaced (small_grads) and the one library call over [E | 1] from G;
    # the chain's joined launch of sky_0's job (db, dC of sun_dir, 1,024
    # rays) and beta_0's t_grad (dE, 512 x 256 with the slope); and a layer
    # with a bias alone (db), the work the wgmma GEMM took over
    zargs, zkw = (None, dy, slope, rays16, SAMPLES), dict(extra="xyz",
                                                         extra_weight=c, z=z)
    e1 = torch.cat([FM._extra_operand(rays16, SAMPLES, z, "xyz", 3, dtype),
                    torch.ones(p, 1, device=dev)], 1)
    g32 = dy * slope
    zbytes = _nbytes(dy, slope, rays16, z, c) + 4 * FEAT * 4
    out["narrow_grads"] = entry(
        lambda: FM.siren_dense_wgrad(*zargs, **zkw),
        lambda: FM.siren_dense_wgrad_reference(*zargs, **zkw),
        lambda: torch.einsum("pj,pn->jn", e1, g32), zbytes, 2.0 * p * FEAT * 4)
    out["small_grads"] = entry(
        lambda: FM.siren_dense_wgrad(*zargs, narrow="walk", **zkw),
        lambda: FM.siren_dense_wgrad_reference(*zargs, **zkw),
        lambda: torch.einsum("pj,pn->jn", e1, g32), zbytes, 2.0 * p * FEAT * 4)
    del e1, g32
    bdy, bsl = rand(p, fh, to=torch.float32), rand(p, fh, to=torch.float32)
    sky_dy = rand(BATCH, fh, to=torch.float32).relu()

    def jobs():
        return [FM.NarrowJob(sky_dy, None, rays16, 1, extra="sun",
                             extra_weight=packed["Wsky0"], dtype=dtype, db=True,
                             dc=True, de=False),
                FM.NarrowJob(bdy, bsl, rays16, SAMPLES, extra="t",
                             extra_weight=packed["Wbeta0t"], dtype=dtype,
                             db=False, dc=False, de=True)]

    jbytes = _nbytes(sky_dy, bdy, bsl, rays16, packed["Wsky0"],
                     packed["Wbeta0t"]) + (4 * fh + BATCH * TAU) * 4
    j = entry(lambda: FM.narrow_grads(jobs()),
              lambda: [FM.narrow_grads_reference(jb) for jb in jobs()], None,
              jbytes, 2.0 * (BATCH * fh * 4 + p * fh * TAU))
    out["narrow_grads"].update({f"joined_{k}": v for k, v in j.items()
                                if k in ("ms", "plain_ms", "bound_ms")})
    # the joined launch's outputs against the plain version, of each
    # tensor's largest entry
    held = jobs()
    FM.narrow_grads(held)
    out["narrow_grads"]["joined_rel_err"] = max(
        _rel_err(a, r) for jb in held
        for a, r in zip((jb.db, jb.dc, jb.de), FM.narrow_grads_reference(jb))
        if a is not None)
    del held
    del bdy, bsl, sky_dy
    for name, body in (("narrow_grads", "rays"), ("small_grads", "walk")):
        db_only = entry(
            lambda: FM.siren_dense_wgrad(*zargs, narrow=body),
            lambda: FM.siren_dense_wgrad_reference(*zargs),
            lambda: torch.einsum("pn,pn->n", dy, slope),
            _nbytes(dy, slope) + FEAT * 4, 2.0 * p * FEAT)
        out[name].update({f"db_only_{k}": v for k, v in db_only.items()})
    hs = [rand(p, fh) for _ in range(3)]
    skyh = rand(BATCH, fh).abs()
    noise = rand(BATCH, SAMPLES, to=torch.float32)
    gt = rand(BATCH, 3, to=torch.float32).abs()
    cargs = (h, *hs, skyh, packed["wn"], packed["bn"], z, noise, gt, 1.0)
    out["composite_loss_bwd"] = bodies(
        lambda b: FM.composite_loss_bwd(*cargs, return_weights=True, body=b),
        entry(
            lambda: FM.composite_loss_bwd(*cargs, return_weights=True),
            lambda: FM.composite_loss_bwd_reference(*cargs, return_weights=True),
            None,
            _nbytes(*cargs[:-1]) + (p * (FEAT + 3 * fh) + BATCH * fh + 9 * FEAT
                                    + 9 + 3 + p) * 4,
            4.0 * p * (FEAT + 5 * fh)))

    # ---- the full recipe's kernels, at the same training batch
    cot = rand(BATCH, 16, to=torch.float32)
    gargs = (h, *hs, skyh, packed["wn"], packed["bn"], z, noise, cot)
    out["composite_bwd"] = bodies(
        lambda b: FM.composite_bwd(*gargs, body=b), entry(
            lambda: FM.composite_bwd(*gargs),
            lambda: FM.composite_bwd_reference(*gargs), None,
            _nbytes(*gargs) + (p * (FEAT + 3 * fh) + BATCH * fh + 9 * FEAT + 9) * 4,
            4.0 * p * (FEAT + 5 * fh)))
    sargs = (h, hs[1], packed["wn"], packed["bn"], z, noise, 0.1 / 3)
    out["sc_loss_bwd"] = entry(
        lambda: FM.sc_loss_bwd(*sargs),
        lambda: FM.sc_loss_bwd_reference(*sargs), None,
        _nbytes(*sargs[:-1]) + (p * fh + 9 * FEAT + 9 + 2) * 4,
        2.0 * p * (FEAT + 3 * fh))
    hargs = (h, *hs, skyh, packed["wn"], packed["bn"], z)
    t_entry = entry(
        lambda: FM.heads_composite(*hargs, noise=noise),
        lambda: FM.heads_composite_reference(*hargs, noise=noise), None,
        _nbytes(*hargs, noise) + BATCH * 16 * 4, 2.0 * p * (FEAT + 5 * fh))
    out["heads_composite"].update({f"train_{k}": v for k, v in t_entry.items()})
    del h, hs, skyh, cargs, gargs, sargs, hargs, wargs, zargs, args, got

    # ---- the per-sample field's kernels, at the fine pass of a hierarchical
    # depth batch: BATCH rays x (SAMPLES + N_IMPORTANCE) points
    n_s = SAMPLES + N_IMPORTANCE
    p = BATCH * n_s
    h = rand(p, FEAT)
    hs = [rand(p, fh) for _ in range(3)]
    skyh = rand(BATCH, fh).abs()
    cot = rand(p, 16, to=torch.float32)
    fargs = (h, *hs, skyh, packed["wn"], packed["bn"], n_s)
    out["field_heads"] = entry(
        lambda: FM.field_heads(*fargs),
        lambda: FM.field_heads_reference(*fargs), None,
        _nbytes(*fargs[:-1]) + p * 16 * 4, 2.0 * p * (FEAT + 5 * fh))
    # sc_loss_bwd at the fine model's shape of the hierarchical recipe
    z128 = torch.sort(torch.rand(BATCH, n_s, generator=g, device=dev), 1).values
    sargs = (h, hs[1], packed["wn"], packed["bn"], z128,
             rand(BATCH, n_s, to=torch.float32), 0.1 / 3)
    s128 = entry(lambda: FM.sc_loss_bwd(*sargs),
                 lambda: FM.sc_loss_bwd_reference(*sargs), None,
                 _nbytes(*sargs[:-1]) + (p * fh + 9 * FEAT + 9 + 2) * 4,
                 2.0 * p * (FEAT + 3 * fh))
    out["sc_loss_bwd"].update({f"s128_{k}": v for k, v in s128.items()})
    # field_heads on points that are their own rays (K6, --fused on): as
    # many points, sky once a point
    kargs = (h, *hs, rand(p, fh).abs(), packed["wn"], packed["bn"], 1)
    k6 = entry(lambda: FM.field_heads(*kargs),
               lambda: FM.field_heads_reference(*kargs), None,
               _nbytes(*kargs[:-1]) + p * 16 * 4, 2.0 * p * (FEAT + 8 * fh))
    out["field_heads"].update({f"k6_{k}": v for k, v in k6.items()})
    # forward again, the rows of dWn, the cotangents of h, r, s2 and bh
    out["field_heads_bwd"] = entry(
        lambda: FM.field_heads_bwd(*fargs, cot),
        lambda: FM.field_heads_bwd_reference(*fargs, cot), None,
        _nbytes(*fargs[:-1], cot) + (p * (FEAT + 3 * fh) + BATCH * fh + 9 * FEAT
                                     + 9) * 4,
        6.0 * p * (FEAT + 5 * fh))
    # and on the points that are their own rays: the sky head's too, once a
    # point (its row read, d_skyh written)
    k6 = entry(lambda: FM.field_heads_bwd(*kargs, cot),
               lambda: FM.field_heads_bwd_reference(*kargs, cot), None,
               _nbytes(*kargs[:-1], cot) + (p * (FEAT + 4 * fh) + 9 * FEAT + 9) * 4,
               6.0 * p * (FEAT + 8 * fh))
    out["field_heads_bwd"].update({f"k6_{k}": v for k, v in k6.items()})
    return out


def phase2(results: dict):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from satnerf_tpu_torch.models.nerf import build_model
    from satnerf_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda:0")
    failures = []
    launches_before = dict(FM.LAUNCHES)
    for variant in ("sat-nerf", "s-nerf"):
        use_beta = variant == "sat-nerf"
        field = build_model(variant, LAYERS, FEAT, t_dim=TAU,
                            generator=torch.Generator().manual_seed(1)).to(dev)
        o, d, sun, t, z = _inputs(N_RAYS, 2, dev)
        t_in = t if use_beta else None
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            kw = dict(layers=LAYERS, feat=FEAT, skip=4, use_beta=use_beta,
                      tau=TAU, dtype=dtype, return_weights=True)
            with torch.inference_mode():
                out = FM.fused_render_rays(field, o, d, sun, t_in, z, **kw)
                ref = FM.fused_render_rays_reference(field, o, d, sun, t_in, z,
                                                     **kw)
                torch.cuda.synchronize()
                errs = {k: (out[k] - ref[k]).abs().max().item() for k in ref}
                tol = K2_TOL[dname]
                for k, e in errs.items():
                    lim = tol * DEPTH_RANGE if k == "depth" else tol
                    if not e <= lim:
                        failures.append(f"K2 {variant} {dname} {k}: {e:.3g} > {lim}")

                # every launch of the chain against its plain version
                chk = StageCheck(dtype)
                rays16 = FM.pack_rays(o, d, sun, t_in, TAU)
                packed = FM.pack_params(field, skip=4, use_beta=use_beta,
                                        dtype=dtype)
                FM._render_staged(packed, rays16, z, skip=4, use_beta=use_beta,
                                  rgb_padding=0.001, return_weights=True,
                                  dense_fn=chk.dense, heads_fn=chk.heads)
                torch.cuda.synchronize()
                failures += [f"{variant} {dname}: {b}" for b in chk.bad]
                for k, e in chk.err.items():
                    key = (k, dname)
                    results["err"][key] = max(results["err"].get(key, 0.0), e)

                k2_ms = _cuda_ms(lambda: FM.fused_render_rays(
                    field, o, d, sun, t_in, z, **kw))
                plain_ms = _cuda_ms(lambda: FM.fused_render_rays_reference(
                    field, o, d, sun, t_in, z, **kw))
            log(f"phase 2: K2 {variant} {dname} R={N_RAYS} S={SAMPLES}: "
                f"kernel {k2_ms:.2f} ms, plain {plain_ms:.2f} ms; max err "
                + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                + "; per launch " + ", ".join(f"{k} {e:.2e}"
                                              for k, e in chk.err.items()))
            results["k2"][(variant, dname)] = (k2_ms, plain_ms, errs)
            del out, ref
    # outside inference mode: the training kernels' plain versions use autograd
    field = build_model("sat-nerf", LAYERS, FEAT, t_dim=TAU,
                        generator=torch.Generator().manual_seed(1)).to(dev)
    packed = FM.pack_params(field, skip=4, use_beta=True, dtype=torch.bfloat16)
    times = _time_kernels(packed, dev)
    # one heads_composite launch past two chunks of its block scan (T and the
    # integrals carried over chunks), with weights, against its plain version
    chk = StageCheck(torch.bfloat16)
    n_rays, n_s = LONG_CASES[1]
    g = torch.Generator(device=dev).manual_seed(9)

    def rand(*shape):
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1).to(torch.bfloat16)

    p = n_rays * n_s
    z = torch.sort(torch.rand(n_rays, n_s, generator=g, device=dev), 1).values
    with torch.inference_mode():
        chk.heads(rand(p, FEAT), rand(p, FEAT // 2), rand(p, FEAT // 2),
                  rand(p, FEAT // 2), rand(n_rays, FEAT // 2).relu(), packed["wn"],
                  packed["bn"], z, rgb_padding=0.001, return_weights=True)
    torch.cuda.synchronize()
    failures += [f"heads_composite bf16 at {n_rays} x {n_s}: {b}" for b in chk.bad]
    log(f"phase 2: heads_composite bf16 at {n_rays} rays x {n_s} with weights: "
        f"products and weights vs plain {chk.err['heads_composite']:.2e} (1e-4)")
    def loops(e, pre=""):
        if "block_ms" in e:
            return f" (block {e['block_ms']:.3f} ms, warp {e['warp_ms']:.3f} ms)"
        if "mainloop" not in e:
            return ""
        return (f" ({e[pre + 'mainloop']}; wgmma {e[pre + 'wgmma_ms']:.3f} ms, "
                f"wmma {e[pre + 'wmma_ms']:.3f} ms)")

    for name, e in times.items():
        lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.3f} ms"
        log(f"phase 2: {name} bf16 at its main-path shape: kernel "
            f"{e['ms']:.3f} ms{loops(e)}, plain {e['plain_ms']:.3f} ms, library "
            f"call {lib}, bound {e['bound_ms']:.3f} ms ({e['bound_by']})")
    e = times["siren_dense"]
    log(f"phase 2: siren_dense bf16 with the saved slope at a training batch "
        f"({BATCH} rays x {SAMPLES}): kernel {e['train_ms']:.3f} ms"
        f"{loops(e, 'train_')}, plain "
        f"{e['train_plain_ms']:.3f} ms, library call "
        f"{e['train_library_ms']:.3f} ms, bound {e['train_bound_ms']:.3f} ms")
    e = times["siren_dense_wgrad"]["dw_rel_err"]
    log(f"phase 2: siren_dense_wgrad 512 x 512: dW wgmma vs plain "
        f"{e['wgmma_vs_plain']:.2e}, vs wmma {e['wgmma_vs_wmma']:.2e}, db vs "
        f"plain {e['db_wgmma_vs_plain']:.2e} (of the largest entry)")
    if not max(e.values()) <= K1_STAGE_TOL:
        failures.append(f"siren_dense_wgrad at its main-path shape: {e}")
    e = times["siren_dense_k0"]
    log(f"phase 2: siren_dense_k0, layer 0 with the saved slope ({BATCH} rays x "
        f"{SAMPLES}, {FEAT} columns): {e['k0_ms']:.3f} ms (k0_v1, the first "
        f"K = 0 kernel, {e['k0_v1_ms']:.3f} ms), bit-equal "
        f"{e['bit_equal_to_v1']}, plain {e['plain_ms']:.3f} ms, bound "
        f"{e['bound_ms']:.3f} ms; sky_0 ({BATCH} rays, relu): "
        f"{e['sky0_ms']:.3f} ms (k0_v1 {e['sky0_k0_v1_ms']:.3f} ms), bound "
        f"{e['sky0_bound_ms']:.3f} ms")
    if not e["bit_equal_to_v1"]:
        failures.append("siren_dense_k0 differs from k0_v1 at layer 0")
    e = times["siren_dense_wgrad"]
    log(f"phase 2: siren_dense_wgrad, the skip layer with dC of xyz folded "
        f"into the wgmma epilogue {e['fold_ms']:.3f} ms, with the column walk "
        f"for dC (GEMM + small_grads) {e['unfolded_ms']:.3f} ms; at one "
        f"range of {FM.FOLD_SPLIT} points: {e['fold_bits']}")
    if not (e["fold_bits"]["dw_equal"] and e["fold_bits"]["db_equal"]
            and e["fold_bits"]["dc_rel_err"] <= NARROW_VS_WALK_TOL):
        failures.append(f"the fold changed dW / db: {e['fold_bits']}")
    for name in ("narrow_grads", "small_grads"):
        e = times[name]
        log(f"phase 2: {name} alone summing db (a {FEAT}-column layer with a "
            f"bias alone, {BATCH * SAMPLES} points): kernel "
            f"{e['db_only_ms']:.3f} ms, plain {e['db_only_plain_ms']:.3f} ms, "
            f"library einsum {e['db_only_library_ms']:.3f} ms, bound "
            f"{e['db_only_bound_ms']:.3f} ms")
    e = times["narrow_grads"]
    log(f"phase 2: narrow_grads, the heads' joined launch (sky_0's db and dC, "
        f"beta_0's t_grad): {e['joined_ms']:.3f} ms, plain "
        f"{e['joined_plain_ms']:.3f} ms, bound {e['joined_bound_ms']:.3f} ms; "
        f"db, dC, dE vs plain {e['joined_rel_err']:.2e} (of the largest entry)")
    if not e["joined_rel_err"] <= K1_STAGE_TOL:
        failures.append(f"narrow_grads' joined launch vs plain: "
                        f"{e['joined_rel_err']:.3g}")
    for name, shapes in REDESIGNED.items():
        e = times[name]
        for pre, (shape, old) in shapes.items():
            log(f"phase 2: {name} bf16 at {shape}: kernel {e[pre + 'ms']:.3f} ms "
                f"[{old}], plain {e[pre + 'plain_ms']:.3f} ms, bound "
                f"{e[pre + 'bound_ms']:.3f} ms ({e[pre + 'bound_by']})")
    results["times"] = times
    grown = {k: FM.LAUNCHES[k] - launches_before[k]
             for k in ("siren_dense", "heads_composite")}
    if not all(v > 0 for v in grown.values()):
        failures.append(f"launch counters did not grow: {grown}")
    if failures:
        raise SystemExit("phase 2 failed:\n  " + "\n  ".join(failures))


def phase2b(results: dict):
    """K1 against its plain version on the card."""
    import torch

    from satnerf_tpu_torch.models.nerf import build_model
    from satnerf_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda:0")
    failures = []
    before = dict(FM.LAUNCHES)
    # (variant, gate, rays, noise, weights), each with the depths' jitter
    # from a torch.Generator and from the main path's draw
    cases = [("sat-nerf", 1.0, K1_RAYS[0], False, False),
             ("sat-nerf", 0.0, K1_RAYS[1], True, True),
             ("s-nerf", 0.0, K1_RAYS[1], False, False)]
    for (variant, wmix, n_rays, with_noise, with_weights), jitter in \
            itertools.product(cases, ("torch", "jax")):
        use_beta = variant == "sat-nerf"
        field = build_model(variant, LAYERS, FEAT, t_dim=TAU,
                            generator=torch.Generator().manual_seed(1)).to(dev)
        o, d, sun, t, z = _inputs(n_rays, 5, dev, jitter=jitter)
        g = torch.Generator().manual_seed(6)
        gt = torch.rand(n_rays, 3, generator=g).to(dev)
        noise = (torch.randn(n_rays, SAMPLES, generator=g).to(dev)
                 if with_noise else None)
        t_in = t if use_beta else None
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            kw = dict(layers=LAYERS, feat=FEAT, skip=4, use_beta=use_beta,
                      tau=TAU, dtype=dtype, return_weights=with_weights)
            args = (field, o, d, sun, t_in, z, noise, gt, wmix)
            out = FM.fused_train_loss_grads(*args, **kw)
            ref = FM.fused_train_loss_grads_reference(*args, **kw)
            torch.cuda.synchronize()
            tag = f"K1 {variant} gate {wmix:g} R={n_rays} {dname} {jitter} jitter"
            part_err = {k: abs(out[0][k].item() - ref[0][k].item())
                        / max(abs(ref[0][k].item()), 1e-6) for k in ref[0]}
            grad_err = {k: _rel_err(out[1][k], ref[1][k]) for k in ref[1]}
            if set(out[1]) != set(ref[1]):
                failures.append(f"{tag}: gradient names differ")
            extra_err = {}
            if use_beta:
                extra_err["t_grad"] = _rel_err(out[2], ref[2])
            if with_weights:
                extra_err["weights"] = (out[3] - ref[3]).abs().max().item()
            for k, e in part_err.items():
                if not e <= K1_PART_TOL[dname]:
                    failures.append(f"{tag} part {k}: {e:.3g}")
            for k, e in {**grad_err, **extra_err}.items():
                lim = (K2_TOL[dname] if k == "weights" else K1_GRAD_TOL[dname])
                if not e <= lim:
                    failures.append(f"{tag} {k}: {e:.3g} > {lim}")
            for k, v in out[1].items():
                if not bool(torch.isfinite(v).all()):
                    failures.append(f"{tag} {k}: not finite")
            worst = max(grad_err, key=grad_err.get)

            # every launch of the chain against its plain version
            chk = TrainCheck(dtype)
            rays16 = FM.pack_rays(o, d, sun, t_in, TAU)
            packed = FM.pack_params(field, skip=4, use_beta=use_beta, dtype=dtype)
            with torch.no_grad():
                FM._train_staged(packed, rays16, z, noise, gt, wmix, skip=4,
                                 use_beta=use_beta, rgb_padding=0.001,
                                 beta_min=0.05, return_weights=with_weights,
                                 ops=chk)
            torch.cuda.synchronize()
            failures += [f"{tag}: {b}" for b in chk.bad]
            for k, e in chk.err.items():
                key = (k, dname)
                results["err"][key] = max(results["err"].get(key, 0.0), e)
            ms = _cuda_ms(lambda: FM.fused_train_loss_grads(*args, **kw))
            plain_ms = _cuda_ms(
                lambda: FM.fused_train_loss_grads_reference(*args, **kw))
            log(f"phase 2b: {tag}: kernels {ms:.2f} ms, plain {plain_ms:.2f} ms; "
                f"parts " + ", ".join(f"{k} {e:.1e}" for k, e in part_err.items())
                + f"; worst gradient {worst} {grad_err[worst]:.1e}"
                + "".join(f", {k} {e:.1e}" for k, e in extra_err.items())
                + "; per launch " + ", ".join(f"{k} {chk.err[k]:.1e}"
                                              for k in TRAIN_KERNELS))
            results["k1"][(variant, wmix, n_rays, dname)] = (ms, plain_ms)
            del out, ref
    # past 256 samples a ray (the block body takes ceil(S / 256) samples a
    # thread): every launch of the chain alone, composite_loss_bwd also
    # against the warp body
    for n_rays, n_s in LONG_CASES:
        field, rays16, z, noise, gt, _ = _long_inputs(n_rays, n_s, dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            tag = f"K1 sat-nerf R={n_rays} S={n_s} {dname}"
            chk = TrainCheck(dtype)
            packed = FM.pack_params(field, skip=4, use_beta=True, dtype=dtype)
            with torch.no_grad():
                FM._train_staged(packed, rays16, z, noise, gt, 1.0, skip=4,
                                 use_beta=True, rgb_padding=0.001,
                                 beta_min=0.05, return_weights=True, ops=chk)
            torch.cuda.synchronize()
            _record(results, failures, tag, chk)
            log(f"phase 2b: {tag}: per launch " + ", ".join(
                f"{k} {chk.err[k]:.1e}" for k in TRAIN_KERNELS
                + ("composite_loss_bwd_vs_warp", JOINED_VS_ALONE)))
            del packed
        del field, rays16, z, noise, gt
    grown = {k: FM.LAUNCHES[k] - before[k] for k in TRAIN_KERNELS}
    if not all(v > 0 for v in grown.values()):
        failures.append(f"launch counters did not grow: {grown}")
    if failures:
        raise SystemExit("phase 2b failed:\n  " + "\n  ".join(failures))


def _long_inputs(n_rays: int, n_s: int, dev):
    """A seeded sat-nerf 8 x 512 field and a batch of n_rays x n_s samples
    (LONG_CASES): (field, rays16, z, sigma noise, gt, a (R, 16) cotangent)."""
    import torch

    from satnerf_tpu_torch.models.nerf import build_model
    from satnerf_tpu_torch.ops import fused_mlp as FM

    field = build_model("sat-nerf", LAYERS, FEAT, t_dim=TAU,
                        generator=torch.Generator().manual_seed(1)).to(dev)
    o, d, sun, t, z = _inputs(n_rays, 15, dev, n_s)
    g = torch.Generator().manual_seed(16)
    gt = torch.rand(n_rays, 3, generator=g).to(dev)
    noise = torch.randn(n_rays, n_s, generator=g).to(dev)
    cot = torch.randn(n_rays, 16, generator=g).to(dev)
    return field, FM.pack_rays(o, d, sun, t, TAU), z, noise, gt, cot


def _record(results, failures, tag, chk) -> None:
    """A check's failures into failures, its errors into results["err"]."""
    failures += [f"{tag}: {b}" for b in chk.bad]
    dname = "bfloat16" if chk.bf16 else "float32"
    for k, e in chk.err.items():
        results["err"][(k, dname)] = max(results["err"].get((k, dname), 0.0), e)


def _hold_grads(failures, tag, got: dict, ref: dict, tol: float) -> tuple:
    """Every gradient by name within tol of its tensor's largest entry, and
    exactly zero where the plain version's is. Returns (worst name, error)."""
    import torch

    if set(got) != set(ref):
        failures.append(f"{tag}: gradient names differ")
    errs = {}
    for k, r in ref.items():
        if not bool(torch.isfinite(got[k]).all()):
            failures.append(f"{tag} {k}: not finite")
        if float(r.abs().max()) == 0.0:
            if float(got[k].abs().max()) != 0.0:
                failures.append(f"{tag} {k}: not zero where autograd has zero")
            continue
        errs[k] = _rel_err(got[k], r)
        if not errs[k] <= tol:
            failures.append(f"{tag} {k}: {errs[k]:.3g} > {tol}")
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def phase2c(results: dict):
    """K3 and K4 against their plain versions on the card."""
    import torch

    from satnerf_tpu_torch.models.nerf import build_model
    from satnerf_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda:0")
    failures = []
    before = dict(FM.LAUNCHES)
    lam = 0.1
    cases = [("sat-nerf", K1_RAYS[0], True), ("sat-nerf", K1_RAYS[1], False),
             ("s-nerf", K1_RAYS[1], True)]
    for variant, n_rays, with_noise in cases:
        use_beta = variant == "sat-nerf"
        field = build_model(variant, LAYERS, FEAT, t_dim=TAU,
                            generator=torch.Generator().manual_seed(1)).to(dev)
        o, d, sun, t, z = _inputs(n_rays, 7, dev)
        g = torch.Generator().manual_seed(8)
        noise = (torch.randn(n_rays, SAMPLES, generator=g).to(dev)
                 if with_noise else None)
        cot = torch.randn(n_rays, 16, generator=g).to(dev)
        t_in = t if use_beta else None
        names = [n for n, _ in field.named_parameters()]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            kw = dict(layers=LAYERS, feat=FEAT, skip=4, use_beta=use_beta,
                      tau=TAU, dtype=dtype)
            tag = f"{variant} R={n_rays} noise {'on' if with_noise else 'off'} {dname}"
            chk = TrainCheck(dtype)
            packed = FM.pack_params(field, skip=4, use_beta=use_beta, dtype=dtype)

            # ---- K3 whole, then every launch of its chain
            sc_args = (field, o, sun, t_in, z, noise, lam)
            parts, grads = FM.fused_sc_loss_grads(*sc_args, **kw)
            r_parts, r_grads = FM.fused_sc_loss_grads_reference(*sc_args, **kw)
            torch.cuda.synchronize()
            part_err = {k: abs(parts[k].item() - r_parts[k].item())
                        / max(abs(r_parts[k].item()), 1e-6) for k in r_parts}
            for k, e in part_err.items():
                if not e <= K1_PART_TOL[dname]:
                    failures.append(f"K3 {tag} {k}: {e:.3g}")
            worst3 = _hold_grads(failures, f"K3 {tag}", grads, r_grads,
                                 K1_GRAD_TOL[dname])
            with torch.no_grad():
                FM._sc_staged(packed, FM.pack_rays(o, sun, sun, t_in, TAU), z,
                              noise, lam / 3, skip=4, use_beta=use_beta, ops=chk)
            k3_ms = _cuda_ms(lambda: FM.fused_sc_loss_grads(*sc_args, **kw))
            k3_plain = _cuda_ms(
                lambda: FM.fused_sc_loss_grads_reference(*sc_args, **kw))

            # ---- K4: products, then the backward from a random cotangent
            def k4(fn):
                t_leaf = t.clone().requires_grad_(True) if use_beta else None
                out = fn(field, o, d, sun, t_leaf, z, noise, **kw)
                cols = {"rgb": slice(0, 3), "depth": 3, "sun": slice(4, 5),
                        "sky": slice(5, 8), "beta": slice(8, 9),
                        "albedo": slice(9, 12), "opacity": 12}
                total = sum((out[k] * cot[:, cols[k]]).sum() for k in out)
                leaves = list(field.parameters()) + ([t_leaf] if use_beta else [])
                gr = torch.autograd.grad(total, leaves, allow_unused=True)
                named = dict(zip(names + ["t_embed"], gr))
                return {k: v.detach() for k, v in out.items()}, named

            out, grads4 = k4(FM.fused_train_render_rays)
            r_out, r_grads4 = k4(FM.fused_train_render_rays_reference)
            torch.cuda.synchronize()
            prod_err = {k: (out[k] - r_out[k]).abs().max().item() for k in r_out}
            for k, e in prod_err.items():
                lim = K2_TOL[dname] * (DEPTH_RANGE if k == "depth" else 1.0)
                if not e <= lim:
                    failures.append(f"K4 {tag} {k}: {e:.3g} > {lim}")
            worst4 = _hold_grads(failures, f"K4 {tag}", grads4, r_grads4,
                                 K1_GRAD_TOL[dname])
            with torch.no_grad():
                rays16 = FM.pack_rays(o, d, sun, t_in, TAU)
                a = FM._chain_forward(packed, rays16, z, skip=4,
                                      use_beta=use_beta, ops=chk)
                nargs = (a["h"], a["r"], a["s2"], a["bh"], a["skyh"],
                         packed["wn"], packed["bn"], z)
                chk.heads(*nargs, noise=noise, rgb_padding=0.001)
                c = chk.composite_given(*nargs, noise, cot, rgb_padding=0.001)
                FM._chain_backward(packed, a, c, rays16, z, skip=4,
                                   use_beta=use_beta, ops=chk)
                del a, c, nargs
            torch.cuda.synchronize()
            failures += [f"{tag}: {b}" for b in chk.bad]
            for k, e in chk.err.items():
                key = (k, dname)
                results["err"][key] = max(results["err"].get(key, 0.0), e)
            k4_ms = _cuda_ms(lambda: k4(FM.fused_train_render_rays))
            k4_plain = _cuda_ms(lambda: k4(FM.fused_train_render_rays_reference))
            log(f"phase 2c: {tag}: K3 kernels {k3_ms:.2f} ms, plain "
                f"{k3_plain:.2f} ms; terms "
                + ", ".join(f"{k} {e:.1e}" for k, e in part_err.items())
                + f"; worst gradient {worst3[0]} {worst3[1]:.1e}. K4 forward + "
                f"backward kernels {k4_ms:.2f} ms, plain {k4_plain:.2f} ms; "
                f"products max {max(prod_err.values()):.1e}; worst gradient "
                f"{worst4[0]} {worst4[1]:.1e}; per launch "
                + ", ".join(f"{k} {chk.err[k]:.1e}" for k in
                            AUX_KERNELS + ("heads_composite",)))
            results["k34"][(variant, n_rays, dname)] = (k3_ms, k3_plain, k4_ms,
                                                        k4_plain)
    # past 256 samples a ray: K3's and K4's chains, every launch alone (the
    # scan of sc_loss_bwd carried over chunks), composite_bwd also against
    # the warp body
    for n_rays, n_s in LONG_CASES:
        field, rays16, z, noise, _, cot = _long_inputs(n_rays, n_s, dev)
        sun_rays = rays16.clone()
        sun_rays[:, 3:6] = rays16[:, 6:9]  # K3 marches along the sun direction
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            tag = f"K3 sat-nerf R={n_rays} S={n_s} {dname}"
            chk = TrainCheck(dtype)
            packed = FM.pack_params(field, skip=4, use_beta=True, dtype=dtype)
            with torch.no_grad():
                FM._sc_staged(packed, sun_rays, z, noise, lam / 3, skip=4,
                              use_beta=True, ops=chk)
            torch.cuda.synchronize()
            _record(results, failures, tag, chk)
            log(f"phase 2c: {tag}: per launch " + ", ".join(
                f"{k} {chk.err[k]:.1e}" for k in
                ("sc_loss_bwd",) + TRAIN_KERNELS[2:] + (JOINED_VS_ALONE,)))
            tag = f"K4 sat-nerf R={n_rays} S={n_s} {dname}"
            chk = TrainCheck(dtype)
            with torch.no_grad():
                a = FM._chain_forward(packed, rays16, z, skip=4, use_beta=True,
                                      ops=chk)
                nargs = (a["h"], a["r"], a["s2"], a["bh"], a["skyh"],
                         packed["wn"], packed["bn"], z)
                chk.heads(*nargs, noise=noise, rgb_padding=0.001)
                c = chk.composite_given(*nargs, noise, cot, rgb_padding=0.001)
                FM._chain_backward(packed, a, c, rays16, z, skip=4,
                                   use_beta=True, ops=chk)
                del a, c, nargs
            torch.cuda.synchronize()
            _record(results, failures, tag, chk)
            log(f"phase 2c: {tag}: per launch " + ", ".join(
                f"{k} {chk.err[k]:.1e}" for k in
                ("composite_bwd", "composite_bwd_vs_warp", "heads_composite")
                + TRAIN_KERNELS[2:] + (JOINED_VS_ALONE,)))
            del packed
        del field, rays16, sun_rays, z, noise, cot
    grown = {k: FM.LAUNCHES[k] - before[k] for k in AUX_KERNELS}
    if not all(v > 0 for v in grown.values()):
        failures.append(f"launch counters did not grow: {grown}")
    times = results["times"]
    for name in AUX_KERNELS:
        e = times[name]
        both = (f" (block {e['block_ms']:.3f} ms, warp {e['warp_ms']:.3f} ms)"
                if "block_ms" in e else f" [{REDESIGNED[name][''][1]}]")
        log(f"phase 2c: {name} bf16 at a training batch ({BATCH} rays x "
            f"{SAMPLES}): kernel {e['ms']:.3f} ms{both}, plain "
            f"{e['plain_ms']:.3f} ms, library call none, bound "
            f"{e['bound_ms']:.3f} ms ({e['bound_by']})")
    if failures:
        raise SystemExit("phase 2c failed:\n  " + "\n  ".join(failures))


FIELD_COLS = {"rgb": slice(0, 3), "sigma": 3, "sun_v": slice(4, 5),
              "sky_rgb": slice(5, 8), "beta": slice(8, 9)}
# (variant, rays, samples a ray): both ray counts and all three sample counts
# for sat-nerf, the ragged pair for s-nerf
FIELD_CASES = (("sat-nerf", K1_RAYS[0], 64), ("sat-nerf", K1_RAYS[1], 72),
               ("sat-nerf", K1_RAYS[0], 128), ("s-nerf", K1_RAYS[1], 128))
K6_POINTS = 65536 + 37


def _field_vjp(fn, field, inputs: dict, cot, names, kw):
    """fn's per-sample outputs and, from the (P, 16) cotangent, the gradients
    of the field's parameters and of every input in `inputs` that is a leaf."""
    import torch

    leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
    out = fn(field, leaves, **kw)
    total = sum((v * cot[:, FIELD_COLS[k]].reshape(v.shape)).sum()
                for k, v in out.items())
    gr = torch.autograd.grad(total, list(field.parameters())
                             + list(leaves.values()), allow_unused=True)
    return ({k: v.detach() for k, v in out.items()},
            dict(zip(names + [f"d_{k}" for k in leaves], gr)))


def _off_the_kink(field, sun, cot, samples: int, dtype):
    """The cotangent with its sky columns zeroed for the rays (of `samples`
    points each) that have a sky_0 pre-activation within 1e-5 of 0. The
    kernels and the plain version sum that pre-activation in another order
    and may land on either side of relu's kink, where the gradient jumps;
    among the 16.8 M hidden units of 65,573 points a few always do."""
    lin = field.sky_color[0]
    pre = (sun.to(dtype).float() @ lin.weight.detach().to(dtype).float().t()
           + lin.bias.detach().float())
    near = (pre.abs() < 1e-5).any(1).repeat_interleave(samples)
    cot = cot.clone()
    cot[near, 5:8] = 0.0
    return cot


def _hold_field(failures, tag, got, ref, dname) -> tuple:
    """Outputs to K2_TOL, gradients to K1_GRAD_TOL; (worst output error,
    (worst gradient, its error))."""
    out, grads = got
    r_out, r_grads = ref
    worst_out = 0.0
    if set(out) != set(r_out):
        failures.append(f"{tag}: outputs differ: {sorted(out)}")
    for k, r in r_out.items():
        e = (out[k] - r).abs().max().item()
        worst_out = max(worst_out, e)
        lim = K2_TOL[dname] * max(1.0, r.abs().max().item())
        if out[k].shape != r.shape or not e <= lim:
            failures.append(f"{tag} {k}: {e:.3g} > {lim:.3g}")
    return worst_out, _hold_grads(failures, tag, grads, r_grads,
                                  K1_GRAD_TOL[dname])


def phase2d(results: dict):
    """K5 and K6 against their plain versions on the card; K1, K2 and K3 at
    72 and 128 samples a ray."""
    import torch

    from satnerf_tpu_torch.models.nerf import build_model
    from satnerf_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda:0")
    failures = []
    before = dict(FM.LAUNCHES)

    def stage_errors(chk, tag, dname):
        failures.extend(f"{tag}: {b}" for b in chk.bad)
        for k, e in chk.err.items():
            key = (k, dname)
            results["err"][key] = max(results["err"].get(key, 0.0), e)

    for variant, n_rays, n_s in FIELD_CASES:
        use_beta = variant == "sat-nerf"
        field = build_model(variant, LAYERS, FEAT, t_dim=TAU,
                            generator=torch.Generator().manual_seed(1)).to(dev)
        names = [n for n, _ in field.named_parameters()]
        o, d, sun, t, z = _inputs(n_rays, 9, dev, n_s)
        g = torch.Generator().manual_seed(10)
        cot = torch.randn(n_rays * n_s, 16, generator=g).to(dev)
        xyz = (torch.rand(K6_POINTS, 3, generator=g) - 0.5).to(dev)
        sun_p = torch.nn.functional.normalize(
            torch.randn(K6_POINTS, 3, generator=g)).to(dev)
        t_p = torch.randn(K6_POINTS, TAU, generator=g).to(dev)
        cot_p = torch.randn(K6_POINTS, 16, generator=g).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            kw = dict(layers=LAYERS, feat=FEAT, skip=4, use_beta=use_beta,
                      tau=TAU, dtype=dtype)
            tag = f"{variant} R={n_rays} S={n_s} {dname}"
            chk = TrainCheck(dtype)
            packed = FM.pack_params(field, skip=4, use_beta=use_beta, dtype=dtype)
            cot5 = _off_the_kink(field, sun, cot, n_s, dtype)
            cot6 = _off_the_kink(field, sun_p, cot_p, 1, dtype)

            # ---- K5 whole, then every launch of its chain
            def k5(fn):
                return _field_vjp(
                    lambda f, lv, **k: fn(f, o, d, sun, lv.get("t"), z, **k),
                    field, {"t": t} if use_beta else {}, cot5, names, kw)

            got5, ref5 = (k5(FM.fused_field_apply_rays),
                          k5(FM.fused_field_apply_rays_reference))
            torch.cuda.synchronize()
            out5, worst5 = _hold_field(failures, f"K5 {tag}", got5, ref5, dname)
            with torch.no_grad():
                rays16 = FM.pack_rays(o, d, sun, t if use_beta else None, TAU)
                a = FM._chain_forward(packed, rays16, z, skip=4,
                                      use_beta=use_beta, ops=chk)
                nargs = (a["h"], a["r"], a["s2"], a["bh"], a["skyh"],
                         packed["wn"], packed["bn"], n_s)
                chk.field_heads(*nargs)
                c = chk.field_heads_bwd(*nargs, cot)
                FM._chain_backward(packed, a, c, rays16, z, skip=4,
                                   use_beta=use_beta, ops=chk)
                del a, c, nargs
            torch.cuda.synchronize()
            k5_ms = _cuda_ms(lambda: k5(FM.fused_field_apply_rays))
            k5_plain = _cuda_ms(lambda: k5(FM.fused_field_apply_rays_reference))
            del got5, ref5

            # ---- K6 on points that are their own rays, with the input gradients
            def k6(fn):
                ins = {"xyz": xyz, "sun": sun_p}
                if use_beta:
                    ins["t"] = t_p
                return _field_vjp(
                    lambda f, lv, **k: fn(f, lv["xyz"], lv["sun"], lv.get("t"),
                                          **k),
                    field, ins, cot6, names, kw)

            got6, ref6 = k6(FM.fused_field_apply), k6(FM.fused_field_apply_reference)
            torch.cuda.synchronize()
            out6, worst6 = _hold_field(failures, f"K6 {tag}", got6, ref6, dname)
            for k in ("d_xyz", "d_sun") + (("d_t",) if use_beta else ()):
                if got6[1].get(k) is None:
                    failures.append(f"K6 {tag}: no gradient for {k}")
            with torch.no_grad():
                zero3 = torch.zeros_like(xyz)
                rays16 = FM.pack_rays(xyz, zero3, sun_p,
                                      t_p if use_beta else None, TAU)
                z1 = torch.zeros((K6_POINTS, 1), device=dev)
                a = FM._chain_forward(packed, rays16, z1, skip=4,
                                      use_beta=use_beta, ops=chk)
                nargs = (a["h"], a["r"], a["s2"], a["bh"], a["skyh"],
                         packed["wn"], packed["bn"], 1)
                chk.field_heads(*nargs)
                c = chk.field_heads_bwd(*nargs, cot_p)
                FM._chain_backward(packed, a, c, rays16, z1, skip=4,
                                   use_beta=use_beta, ops=chk, input_grads={})
                del a, c, nargs
            torch.cuda.synchronize()
            stage_errors(chk, tag, dname)
            k6_ms = _cuda_ms(lambda: k6(FM.fused_field_apply))
            k6_plain = _cuda_ms(lambda: k6(FM.fused_field_apply_reference))
            del got6, ref6
            log(f"phase 2d: {tag}: K5 forward + backward kernels {k5_ms:.2f} ms, "
                f"plain {k5_plain:.2f} ms; outputs max {out5:.1e}; worst gradient "
                f"{worst5[0]} {worst5[1]:.1e}. K6 at {K6_POINTS} points kernels "
                f"{k6_ms:.2f} ms, plain {k6_plain:.2f} ms; outputs max {out6:.1e}; "
                f"worst gradient {worst6[0]} {worst6[1]:.1e}; per launch "
                + ", ".join(f"{k} {chk.err[k]:.1e}" for k in FIELD_KERNELS))
            results["k56"][(variant, n_rays, n_s, dname)] = (k5_ms, k5_plain,
                                                             k6_ms, k6_plain)

    # ---- K2, K1 and K3 off 64 samples a ray: sat-nerf, ragged rays
    field = build_model("sat-nerf", LAYERS, FEAT, t_dim=TAU,
                        generator=torch.Generator().manual_seed(1)).to(dev)
    for n_s, dtype in ((72, torch.float32), (128, torch.bfloat16),
                       (72, torch.bfloat16)):
        dname = str(dtype).split(".")[-1]
        n_rays = K1_RAYS[1]
        o, d, sun, t, z = _inputs(n_rays, 11, dev, n_s)
        g = torch.Generator().manual_seed(12)
        gt = torch.rand(n_rays, 3, generator=g).to(dev)
        noise = torch.randn(n_rays, n_s, generator=g).to(dev)
        kw = dict(layers=LAYERS, feat=FEAT, skip=4, use_beta=True, tau=TAU,
                  dtype=dtype)
        tag = f"S={n_s} R={n_rays} {dname}"
        with torch.inference_mode():
            out = FM.fused_render_rays(field, o, d, sun, t, z,
                                       return_weights=True, **kw)
            ref = FM.fused_render_rays_reference(field, o, d, sun, t, z,
                                                 return_weights=True, **kw)
        e2 = max((out[k] - ref[k]).abs().max().item() for k in ref)
        if not e2 <= K2_TOL[dname]:
            failures.append(f"K2 {tag}: {e2:.3g}")
        args = (field, o, d, sun, t, z, noise, gt, 1.0)
        out = FM.fused_train_loss_grads(*args, return_weights=True, **kw)
        ref = FM.fused_train_loss_grads_reference(*args, return_weights=True,
                                                  **kw)
        for k in ref[0]:
            e = abs(out[0][k].item() - ref[0][k].item()) / max(
                abs(ref[0][k].item()), 1e-6)
            if not e <= K1_PART_TOL[dname]:
                failures.append(f"K1 {tag} part {k}: {e:.3g}")
        worst1 = _hold_grads(failures, f"K1 {tag}", out[1], ref[1],
                             K1_GRAD_TOL[dname])
        e_w = (out[3] - ref[3]).abs().max().item()
        if not (_rel_err(out[2], ref[2]) <= K1_GRAD_TOL[dname]
                and e_w <= K2_TOL[dname]):
            failures.append(f"K1 {tag}: t_grad or weights off ({e_w:.3g})")
        sc_args = (field, o, sun, t, z, noise, 0.1)
        parts, grads = FM.fused_sc_loss_grads(*sc_args, **kw)
        r_parts, r_grads = FM.fused_sc_loss_grads_reference(*sc_args, **kw)
        for k in r_parts:
            e = abs(parts[k].item() - r_parts[k].item()) / max(
                abs(r_parts[k].item()), 1e-6)
            if not e <= K1_PART_TOL[dname]:
                failures.append(f"K3 {tag} {k}: {e:.3g}")
        worst3 = _hold_grads(failures, f"K3 {tag}", grads, r_grads,
                             K1_GRAD_TOL[dname])
        torch.cuda.synchronize()
        log(f"phase 2d: {tag}: K2 products max {e2:.1e}; K1 worst gradient "
            f"{worst1[0]} {worst1[1]:.1e}, weights {e_w:.1e}; K3 worst gradient "
            f"{worst3[0]} {worst3[1]:.1e}")
        del out, ref

    grown = {k: FM.LAUNCHES[k] - before[k] for k in FIELD_KERNELS}
    if not all(v > 0 for v in grown.values()):
        failures.append(f"launch counters did not grow: {grown}")
    times = results["times"]
    for name in FIELD_KERNELS:
        e = times[name]
        old = f" [{REDESIGNED[name][''][1]}]" if name in REDESIGNED else ""
        log(f"phase 2d: {name} bf16 at the fine pass of a depth batch ({BATCH} "
            f"rays x {SAMPLES + N_IMPORTANCE}): kernel {e['ms']:.3f} ms{old}, plain "
            f"{e['plain_ms']:.3f} ms, library call none, bound "
            f"{e['bound_ms']:.3f} ms ({e['bound_by']})")
    if failures:
        raise SystemExit("phase 2d failed:\n  " + "\n  ".join(failures))


def _time_nerf_kernels(field, dev, failures: list) -> dict:
    """Each nerf kernel alone in bf16 at the shape its main path gives it, as
    `_time_kernels` does: the serving kernels at one chunk of CHUNK rays x 64
    samples, the training kernels at one batch of BATCH rays x 64, the
    per-point kernels at the fine pass of a hierarchical batch (BATCH x 128
    points); for the dense kernels the 256 x 256 skip layer with its 64-row
    encoding operand (the dgrad: a 256 x 256 trunk layer), and for the dgrad
    and the wgrad both mainloops' times (the wgrad on wmma: its two GEMM
    launches and nerf_bias_grad). The wgrad has two library readings:
    library_ms times h.t() @ G (dW alone), library_xe_ms xe.t() @ G with
    xe = [h | enc] built beforehand (dW and dC in one call). nerf_dense's
    chunk_err holds each of the chain's five layer shapes at the serving
    chunk: the rule's mainloop, its launch against wmma and the plain
    version. The two per-ray kernels are also held against their plain
    versions at their timed shapes, and timed and held at NERF_SCAN_CASE
    (long_*: their block scans carried over three chunks); what fails goes
    to `failures`."""
    import torch
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.ops import fused_nerf as FN

    dtype, feat, fh = torch.bfloat16, NERF_FEAT, NERF_FEAT // 2
    packed = FN.pack_params(field, skip=4, dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape, to=dtype):
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1).to(to)

    def entry(fn, plain, library, nbytes, flops):
        bound_ms, by = _bound(nbytes, flops)
        return {"ms": _cuda_ms(fn), "plain_ms": _cuda_ms(plain),
                "library_ms": None if library is None else _cuda_ms(library),
                "bound_ms": bound_ms, "bound_by": by}

    def mainloops(name, fn, e):
        """e, with the mainloop the rule took (fn(None)) and both tensor-core
        mainloops timed on the same inputs in turns: wmma, wgmma, wgmma,
        wmma."""
        before = dict(FM.MAINLOOP_LAUNCHES)
        fn(None)
        e["mainloop"] = next(k[1] for k, v in FM.MAINLOOP_LAUNCHES.items()
                             if k[0] == name and v > before.get(k, 0))
        ms = {m: [] for m in FM.MAINLOOPS}
        for m in ("wmma", "wgmma", "wgmma", "wmma"):
            ms[m].append(_cuda_ms(lambda: fn(m)))
        e.update({f"{m}_ms": sum(v) / len(v) for m, v in ms.items()})
        return e

    w, bias, c = packed["B"][3], packed["bt"][4], packed["C"]
    n_xyz, e_rows = NERF_FREQ[0], packed["C"].shape[0]
    out = {}

    # ---- serving shapes
    o, d, _, _, z = _inputs(CHUNK, 3, dev)
    rays8 = FN.pack_rays(o, d)
    p = CHUNK * SAMPLES
    h = rand(p, feat).abs()
    args = (h, w, bias, rays8, SAMPLES)
    dkw = dict(enc="xyz", enc_weight=c, z=z, n_freq=n_xyz)
    out["nerf_dense"] = mainloops("nerf_dense", lambda m: FN.nerf_dense(
        *args, mainloop=m, **dkw), entry(
        lambda: FN.nerf_dense(*args, **dkw),
        lambda: FN.nerf_dense_reference(*args, **dkw),
        lambda: torch.relu(torch.addmm(bias.to(dtype), h, w)),
        _nbytes(h, w, bias, rays8, z, c) + p * feat * 2,
        2.0 * p * feat * (feat + 6 * n_xyz)))
    # every layer shape of the chain at a serving chunk: the rule's launch
    # (wgmma) against wmma (one rounding step) and the plain version
    layers = {"layer 0": (None, None, packed["bt"][0], "xyz", packed["A"], n_xyz, "relu"),
              "trunk": (h, w, bias, None, None, 0, "relu"),
              "skip": (h, w, bias, "xyz", c, n_xyz, "relu"),
              "feats": (h, packed["Wfeat"], packed["bfeat"], None, None, 0, "none"),
              "rgb_0": (h, packed["Wrgb0h"], packed["brgb0"], "dir", packed["Wrgb0d"],
                        NERF_FREQ[1], "relu")}
    chunk_err = {}
    for what, (x, wt, b, enc, ew, nf, act) in layers.items():
        lkw = dict(enc=enc, enc_weight=ew, z=z, n_freq=nf, act=act)
        took = _took("nerf_dense")
        y = FN.nerf_dense(x, wt, b, rays8, SAMPLES, **lkw).float()
        loop = took()
        other = FN.nerf_dense(x, wt, b, rays8, SAMPLES, mainloop="wmma", **lkw).float()
        ref = FN.nerf_dense_reference(x, wt, b, rays8, SAMPLES, **lkw).float()
        chunk_err[what] = {"mainloop": loop, "vs_wmma": (y - other).abs().max().item(),
                           "vs_plain": (y - ref).abs().max().item(),
                           "ok": loop == "wgmma"
                           and bool(((y - other).abs() <= 2.0 ** -7 * other.abs()
                                     + 1e-4).all())
                           and bool(((y - ref).abs() <= 2.0 ** -7 * ref.abs()
                                     + 1e-4).all())}
        del y, other, ref
    out["nerf_dense"]["chunk_err"] = chunk_err
    r = rand(p, fh).abs()
    hargs = (h, r, packed["wn"], packed["bn"], z)
    out["nerf_heads_composite"] = entry(
        lambda: FN.nerf_heads_composite(*hargs, return_weights=True),
        lambda: FN.nerf_heads_composite_reference(*hargs, return_weights=True),
        None, _nbytes(*hargs) + CHUNK * 8 * 4 + p * 4, 2.0 * p * (feat + 3 * fh))
    chk = NerfCheck(dtype)  # the timed launches held against the plain versions
    chk.heads(*hargs, return_weights=True)
    del h, r, args, hargs

    # ---- training shapes
    o, d, _, _, z = _inputs(BATCH, 3, dev)
    rays8 = FN.pack_rays(o, d)
    p = BATCH * SAMPLES
    h = rand(p, feat).abs()
    args = (h, w, bias, rays8, SAMPLES)
    t_entry = mainloops("nerf_dense", lambda m: FN.nerf_dense(
        *args, mainloop=m, **dkw | {"z": z}), entry(
        lambda: FN.nerf_dense(*args, **dkw | {"z": z}),
        lambda: FN.nerf_dense_reference(*args, **dkw | {"z": z}),
        lambda: torch.relu(torch.addmm(bias.to(dtype), h, w)),
        _nbytes(h, w, bias, rays8, z, c) + p * feat * 2,
        2.0 * p * feat * (feat + 6 * n_xyz)))
    out["nerf_dense"].update({f"train_{k}": v for k, v in t_entry.items()})
    dy, y = rand(p, feat, to=torch.float32), rand(p, feat).clamp_min(0)
    gb = (dy * (y > 0)).to(dtype)
    out["nerf_dense_dgrad"] = mainloops(
        "nerf_dense_dgrad",
        lambda m: FN.nerf_dense_dgrad(dy, y, w, mainloop=m), entry(
            lambda: FN.nerf_dense_dgrad(dy, y, w),
            lambda: FN.nerf_dense_dgrad_reference(dy, y, w),
            lambda: gb @ w.t(),
            _nbytes(dy, y, w) + p * feat * 4, 2.0 * p * feat * feat))
    wargs = (h, dy, y, rays8, SAMPLES)
    wkw = dict(enc="xyz", z=z, n_freq=n_xyz, enc_rows=e_rows)
    out["nerf_dense_wgrad"] = mainloops(
        "nerf_dense_wgrad",
        lambda m: FN.nerf_dense_wgrad(*wargs, mainloop=m, **wkw), entry(
            lambda: FN.nerf_dense_wgrad(*wargs, **wkw),
            lambda: FN.nerf_dense_wgrad_reference(*wargs, **wkw),
            lambda: h.t() @ gb,
            _nbytes(h, dy, y, rays8, z) + (feat * feat + feat + e_rows * feat) * 4,
            2.0 * p * feat * (feat + 6 * n_xyz)))
    xe = torch.cat([h, FN._encoding(rays8, SAMPLES, z, "xyz", n_xyz, e_rows,
                                    dtype).to(dtype)], dim=1)
    out["nerf_dense_wgrad"]["library_xe_ms"] = _cuda_ms(lambda: xe.t() @ gb)
    got = {m: FN.nerf_dense_wgrad(*wargs, mainloop=m, **wkw) for m in FM.MAINLOOPS}
    ref = FN.nerf_dense_wgrad_reference(*wargs, **wkw)
    out["nerf_dense_wgrad"]["rel_err"] = {
        f"{name}_wgmma_vs_{other}": _rel_err(got["wgmma"][i], b[i])
        for other, b in (("plain", ref), ("wmma", got["wmma"]))
        for i, name in enumerate(("dw", "db", "dc"))}
    r = rand(p, fh).abs()
    noise = rand(BATCH, SAMPLES, to=torch.float32)
    gt = rand(BATCH, 3, to=torch.float32).abs()
    cargs = (h, r, packed["wn"], packed["bn"], z, noise, gt)
    # forward and backward walk: h and r read, d_h and d_r written in fp32
    out["nerf_composite_loss_bwd"] = entry(
        lambda: FN.nerf_composite_loss_bwd(*cargs),
        lambda: FN.nerf_composite_loss_bwd_reference(*cargs), None,
        _nbytes(*cargs) + (p * (feat + fh) + 4 * feat + 4 + 1) * 4,
        4.0 * p * (feat + 3 * fh))
    chk.composite(*cargs)
    del h, r, dy, y, gb, cargs, wargs, args, xe, got

    # ---- the two per-ray kernels past two chunks of their block scans, at
    # fewer rays: timed (long_*) and held against the plain versions
    n_r, n_s = NERF_SCAN_CASE
    _, _, _, _, z = _inputs(n_r, 5, dev, n_s)
    p = n_r * n_s
    h, r = rand(p, feat).abs(), rand(p, fh).abs()
    noise = rand(n_r, n_s, to=torch.float32)
    gt = rand(n_r, 3, to=torch.float32).abs()
    hargs = (h, r, packed["wn"], packed["bn"], z)
    cargs = hargs + (noise, gt)
    hkw = dict(noise=noise, return_weights=True)
    for name, e in (("nerf_heads_composite", entry(
            lambda: FN.nerf_heads_composite(*hargs, **hkw),
            lambda: FN.nerf_heads_composite_reference(*hargs, **hkw), None,
            _nbytes(*hargs, noise) + n_r * 8 * 4 + p * 4, 2.0 * p * (feat + 3 * fh))),
                    ("nerf_composite_loss_bwd", entry(
            lambda: FN.nerf_composite_loss_bwd(*cargs),
            lambda: FN.nerf_composite_loss_bwd_reference(*cargs), None,
            _nbytes(*cargs) + (p * (feat + fh) + 4 * feat + 4 + 1) * 4,
            4.0 * p * (feat + 3 * fh)))):
        out[name].update({f"long_{k}": v for k, v in e.items()})
    chk.heads(*hargs, **hkw)
    chk.composite(*cargs)
    for name in ("nerf_heads_composite", "nerf_composite_loss_bwd"):
        out[name]["held_err"] = chk.err[name]
    failures += [f"{b} (timed launches)" for b in chk.bad]
    del h, r, noise, gt, hargs, cargs

    # ---- the per-point kernels: the fine pass of a hierarchical batch,
    # timed; then held against their plain versions there, at the coarse
    # pass (65,536 points) and at the widest width, in both dtypes
    p = BATCH * (SAMPLES + N_IMPORTANCE)
    h, r = rand(p, feat).abs(), rand(p, fh).abs()
    cot = rand(p, 8, to=torch.float32)
    fargs = (h, r, packed["wn"], packed["bn"])
    out["nerf_field_heads"] = entry(
        lambda: FN.nerf_field_heads(*fargs),
        lambda: FN.nerf_field_heads_reference(*fargs), None,
        _nbytes(*fargs) + p * 8 * 4, 2.0 * p * (feat + 3 * fh))
    out["nerf_field_heads_bwd"] = entry(
        lambda: FN.nerf_field_heads_bwd(*fargs, cot),
        lambda: FN.nerf_field_heads_bwd_reference(*fargs, cot), None,
        _nbytes(*fargs, cot) + (p * (feat + fh) + 4 * feat + 4) * 4,
        6.0 * p * (feat + 3 * fh))
    del h, r, cot, fargs
    for pdtype in (torch.bfloat16, torch.float32):
        pchk = NerfCheck(pdtype)
        for n_p, width in NERF_POINT_CASES:
            wn = rand(4, width, to=pdtype) * (3.0 / width ** 0.5)
            wn[1:, width // 2:] = 0
            fargs = (rand(n_p, width, to=pdtype).abs(),
                     rand(n_p, width // 2, to=pdtype).abs(), wn,
                     rand(4, to=torch.float32))
            pchk.field_heads(*fargs)
            pchk.field_heads_bwd(*fargs, rand(n_p, 8, to=torch.float32))
            del fargs, wn
        failures += [f"{b} ({pdtype}, NERF_POINT_CASES)" for b in pchk.bad]
        for name in NERF_FIELD_KERNELS:
            out[name][f"held_err_{str(pdtype).split('.')[-1]}"] = pchk.err[name]
    return out


def phase2e(results: dict):
    """K7, K8 and K9 against their plain versions on the card."""
    import torch

    from satnerf_tpu_torch.models.nerf import build_model
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.ops import fused_nerf as FN

    dev = torch.device("cuda:0")
    failures = []
    before = dict(FM.LAUNCHES)
    field = build_model("nerf", LAYERS, NERF_FEAT,
                        generator=torch.Generator().manual_seed(1)).to(dev)
    names = [n for n, _ in field.named_parameters()]
    g = torch.Generator().manual_seed(14)
    xyz = (torch.rand(K6_POINTS, 3, generator=g) - 0.5).to(dev)
    dirs = torch.nn.functional.normalize(
        torch.randn(K6_POINTS, 3, generator=g)).to(dev)
    cot_p = torch.randn(K6_POINTS, 8, generator=g).to(dev)

    def k9(fn, view_dir, cot, **kw):
        out = fn(field, xyz, view_dir, **kw)
        total = (out["rgb"] * cot[:, 0:3]).sum() + (out["sigma"] * cot[:, 3]).sum()
        gr = torch.autograd.grad(total, list(field.parameters()),
                                 allow_unused=True)
        return {k: v.detach() for k, v in out.items()}, dict(zip(names, gr))

    for case, (n_rays, n_s, with_noise) in enumerate(NERF_CASES):
        o, d, _, _, z = _inputs(n_rays, 13, dev, n_s)
        gt = torch.rand(n_rays, 3, generator=g).to(dev)
        noise = (torch.randn(n_rays, n_s, generator=g).to(dev)
                 if with_noise else None)
        with_weights = case != 1
        view_dir = dirs if case != 1 else None
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            kw = dict(layers=LAYERS, feat=NERF_FEAT, skip=4, dtype=dtype)
            tag = (f"nerf R={n_rays} S={n_s} noise "
                   f"{'on' if with_noise else 'off'} {dname}")
            chk = NerfCheck(dtype)
            packed = FN.pack_params(field, skip=4, dtype=dtype)
            rays8 = FN.pack_rays(o, d)
            skw = dict(skip=4, n_freq=NERF_FREQ, rgb_padding=0.001)

            # ---- K8: products and weights, then every launch of its chain
            with torch.inference_mode():
                out = FN.fused_nerf_render_rays(
                    field, o, d, z, return_weights=with_weights, **kw)
                ref = FN.fused_nerf_render_rays_reference(
                    field, o, d, z, return_weights=with_weights, **kw)
                FN._render_staged(packed, rays8, z, return_weights=True,
                                  ops=chk, **skw)
                k8_ms = _cuda_ms(lambda: FN.fused_nerf_render_rays(
                    field, o, d, z, return_weights=with_weights, **kw))
                k8_plain = _cuda_ms(lambda: FN.fused_nerf_render_rays_reference(
                    field, o, d, z, return_weights=with_weights, **kw))
            torch.cuda.synchronize()
            if set(out) != set(ref) or ("weights" in out) != with_weights:
                failures.append(f"K8 {tag}: products {sorted(out)}")
            prod_err = {k: (out[k] - ref[k]).abs().max().item() for k in ref}
            for k, e in prod_err.items():
                lim = K2_TOL[dname] * (DEPTH_RANGE if k == "depth" else 1.0)
                if not e <= lim:
                    failures.append(f"K8 {tag} {k}: {e:.3g} > {lim}")

            # ---- K7: the loss and every gradient, then every launch
            args = (field, o, d, z, noise, gt)
            mse, grads = FN.fused_nerf_train_loss_grads(*args, **kw)
            r_mse, r_grads = FN.fused_nerf_train_loss_grads_reference(*args, **kw)
            torch.cuda.synchronize()
            e_mse = abs(mse.item() - r_mse.item()) / max(abs(r_mse.item()), 1e-6)
            if not e_mse <= K1_PART_TOL[dname]:
                failures.append(f"K7 {tag} mse: {e_mse:.3g}")
            worst7 = _hold_grads(failures, f"K7 {tag}", grads, r_grads,
                                 NERF_GRAD_TOL[dname])
            with torch.no_grad():
                FN._train_staged(packed, rays8, z, noise, gt, ops=chk, **skw)
            k7_ms = _cuda_ms(lambda: FN.fused_nerf_train_loss_grads(*args, **kw))
            k7_plain = _cuda_ms(
                lambda: FN.fused_nerf_train_loss_grads_reference(*args, **kw))

            # ---- K9 on points: outputs, every gradient, every launch
            got9 = k9(FN.fused_nerf_apply, view_dir, cot_p, **kw)
            ref9 = k9(FN.fused_nerf_apply_reference, view_dir, cot_p, **kw)
            torch.cuda.synchronize()
            out9 = 0.0
            for k, r in ref9[0].items():
                e = (got9[0][k] - r).abs().max().item()
                out9 = max(out9, e)
                lim = K2_TOL[dname] * max(1.0, r.abs().max().item())
                if got9[0][k].shape != r.shape or not e <= lim:
                    failures.append(f"K9 {tag} {k}: {e:.3g} > {lim:.3g}")
            worst9 = _hold_grads(failures, f"K9 {tag}", got9[1], ref9[1],
                                 NERF_GRAD_TOL[dname])
            with torch.no_grad():
                rays_p = FN.pack_rays(xyz, dirs if view_dir is not None
                                      else torch.zeros_like(xyz))
                z1 = torch.zeros((K6_POINTS, 1), device=dev)
                a = FN._chain_forward(packed, rays_p, z1, skip=4,
                                      n_freq=NERF_FREQ, keep=True, ops=chk)
                nargs = (a["hs"][-1], a["r"], packed["wn"], packed["bn"])
                chk.field_heads(*nargs)
                c = chk.field_heads_bwd(*nargs, cot_p)
                FN._chain_backward(packed, a, c, rays_p, z1, skip=4,
                                   n_freq=NERF_FREQ, ops=chk)
                del a, c, nargs
                # under no_grad the wrapper keeps nothing and has no grad_fn
                if FN.fused_nerf_apply(field, xyz, view_dir, **kw)[
                        "rgb"].grad_fn is not None:
                    failures.append(f"K9 {tag}: a graph under no_grad")
            torch.cuda.synchronize()
            k9_ms = _cuda_ms(lambda: k9(FN.fused_nerf_apply, view_dir, cot_p, **kw))
            k9_plain = _cuda_ms(lambda: k9(FN.fused_nerf_apply_reference,
                                           view_dir, cot_p, **kw))
            failures += [f"{tag}: {b}" for b in chk.bad]
            for k, e in chk.err.items():
                key = (k, dname)
                results["err"][key] = max(results["err"].get(key, 0.0), e)
            log(f"phase 2e: {tag}: K8 kernels {k8_ms:.2f} ms, plain "
                f"{k8_plain:.2f} ms, products max {max(prod_err.values()):.1e}. "
                f"K7 kernels {k7_ms:.2f} ms, plain {k7_plain:.2f} ms, mse "
                f"{e_mse:.1e}, worst gradient {worst7[0]} {worst7[1]:.1e}. K9 at "
                f"{K6_POINTS} points (view_dir "
                f"{'given' if view_dir is not None else 'None'}) forward + "
                f"backward kernels {k9_ms:.2f} ms, plain {k9_plain:.2f} ms, "
                f"outputs max {out9:.1e}, worst gradient {worst9[0]} "
                f"{worst9[1]:.1e}; per launch "
                + ", ".join(f"{k} {e:.1e}" for k, e in chk.err.items()))
            results["k789"][(n_rays, n_s, dname)] = (
                k7_ms, k7_plain, k8_ms, k8_plain, k9_ms, k9_plain)
            del out, ref, got9, ref9

    # past 256 samples a ray: every launch of K7's chain alone,
    # nerf_composite_loss_bwd at the long run's length and at one whose walk
    # needs the opt-in past 48 KB
    for n_rays, n_s in NERF_LONG_CASES:
        o, d, _, _, z = _inputs(n_rays, 17, dev, n_s)
        gt = torch.rand(n_rays, 3, generator=g).to(dev)
        noise = torch.randn(n_rays, n_s, generator=g).to(dev)
        rays8 = FN.pack_rays(o, d)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            tag = f"K7 nerf R={n_rays} S={n_s} {dname}"
            chk = NerfCheck(dtype)
            packed = FN.pack_params(field, skip=4, dtype=dtype)
            with torch.no_grad():
                FN._train_staged(packed, rays8, z, noise, gt, skip=4,
                                 n_freq=NERF_FREQ, rgb_padding=0.001, ops=chk)
            torch.cuda.synchronize()
            _record(results, failures, tag, chk)
            log(f"phase 2e: {tag}: per launch " + ", ".join(
                f"{k} {e:.1e}" for k, e in chk.err.items()))
            del packed
    grown = {k: FM.LAUNCHES[k] - before[k] for k in NERF_KERNELS}
    if not all(v > 0 for v in grown.values()):
        failures.append(f"launch counters did not grow: {grown}")
    times = _time_nerf_kernels(field, dev, failures)
    for name, e in times.items():
        lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.3f} ms"
        if "library_xe_ms" in e:
            lib += f", [h | enc].t() @ G {e['library_xe_ms']:.3f} ms"
        loops = (f" ({e['mainloop']}; wgmma {e['wgmma_ms']:.3f} ms, wmma "
                 f"{e['wmma_ms']:.3f} ms)" if "mainloop" in e else "")
        log(f"phase 2e: {name} bf16 at its main-path shape: kernel "
            f"{e['ms']:.3f} ms{loops}, plain {e['plain_ms']:.3f} ms, library "
            f"call {lib}, bound {e['bound_ms']:.3f} ms ({e['bound_by']})")
        if "long_ms" in e:
            log(f"phase 2e: {name} bf16 at {NERF_SCAN_CASE[0]} rays x "
                f"{NERF_SCAN_CASE[1]} with sigma noise: kernel {e['long_ms']:.3f} ms, "
                f"plain {e['long_plain_ms']:.3f} ms, bound {e['long_bound_ms']:.3f} ms "
                f"({e['long_bound_by']}); both shapes vs plain max err "
                f"{e['held_err']:.2e}")
        if "held_err_bfloat16" in e:
            log(f"phase 2e: {name} vs plain at (points, F) {NERF_POINT_CASES}: max "
                f"err bf16 {e['held_err_bfloat16']:.2e}, fp32 {e['held_err_float32']:.2e}")
    log("phase 2e: nerf_dense_wgrad skip layer, of each tensor's largest "
        "entry: " + ", ".join(f"{k} {v:.2e}" for k, v in
                              times["nerf_dense_wgrad"]["rel_err"].items()))
    e = times["nerf_dense_wgrad"]["rel_err"]
    if not max(e.values()) <= K1_STAGE_TOL:
        failures.append(f"nerf_dense_wgrad at its main-path shape: {e}")
    e = times["nerf_dense"]
    log(f"phase 2e: nerf_dense bf16 at a training batch ({BATCH} rays x "
        f"{SAMPLES}): kernel {e['train_ms']:.3f} ms ({e['train_mainloop']}; "
        f"wgmma {e['train_wgmma_ms']:.3f} ms, wmma {e['train_wmma_ms']:.3f} ms), "
        f"plain {e['train_plain_ms']:.3f} ms, library call "
        f"{e['train_library_ms']:.3f} ms, bound {e['train_bound_ms']:.3f} ms")
    for what, ce in e["chunk_err"].items():
        log(f"phase 2e: nerf_dense {what} at a serving chunk ({CHUNK} rays x "
            f"{SAMPLES}) on {ce['mainloop']}: vs wmma {ce['vs_wmma']:.2e}, vs "
            f"plain {ce['vs_plain']:.2e}")
        if not ce["ok"]:
            failures.append(f"nerf_dense {what} at a serving chunk: {ce}")
    results.setdefault("times", {}).update(times)
    if failures:
        raise SystemExit("phase 2e failed:\n  " + "\n  ".join(failures))


def phase3(results: dict, card: str):
    import torch

    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.eval import read_geotiff
    from satnerf_tpu_torch.eval.loader import load_run_config
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.train.checkpoints import (checkpoint_path,
                                                     save_checkpoint)
    from satnerf_tpu_torch.train.system import NeRFSystem

    shutil.rmtree(WORK, ignore_errors=True)
    aoi = os.path.join(WORK, "aoi")
    t0 = time.perf_counter()
    from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi

    make_synthetic_aoi(aoi, size=128)
    log(f"phase 3: synthetic 128 x 128 AOI in {time.perf_counter() - t0:.1f} s")

    run_id, logs, ckpts = "smoke", os.path.join(WORK, "logs"), os.path.join(WORK, "ckpts")
    os.makedirs(os.path.join(logs, run_id))
    opts = {"model": "sat-nerf", "fc_layers": LAYERS, "fc_units": FEAT,
            "n_samples": SAMPLES, "chunk": CHUNK, "exp_name": run_id,
            "root_dir": os.path.join(aoi, "data"), "gt_dir": os.path.join(aoi, "gt"),
            "logs_dir": logs, "ckpts_dir": ckpts}
    with open(os.path.join(logs, run_id, "opts.json"), "w") as f:
        json.dump(opts, f)
    cfg = load_run_config(logs, run_id)
    system = NeRFSystem(cfg, device="cuda")
    params = system.init_params(0)
    save_checkpoint(checkpoint_path(ckpts, run_id, 1), params)

    out_dir = os.path.join(WORK, "out")
    _reset_launches()
    t0 = time.perf_counter()
    mae = create_pretty_dsm(run_id, logs, out_dir, 1, device="cuda")
    dsm_s = time.perf_counter() - t0
    launches = {k: _counts()[k] for k in ("siren_dense", "siren_dense_k0",
                                          "heads_composite")}
    dsm_path = glob.glob(os.path.join(out_dir, run_id, "*_dsm_epoch1.tif"))[0]
    dsm = read_geotiff(dsm_path).data[0]
    finite = float(np.isfinite(dsm).mean())
    log(f"phase 3: create_pretty_dsm in {dsm_s:.2f} s: DSM {dsm.shape} "
        f"{finite:.3f} finite, MAE {mae:.3f} m, launches {launches}")
    if not (mae is not None and np.isfinite(mae)):
        raise SystemExit(f"phase 3 failed: MAE {mae}")
    # random weights scatter the depths, so the raster over their bounding
    # box is sparse; the chain must still place a good share of cells
    if finite < 0.05:
        raise SystemExit(f"phase 3 failed: DSM only {finite:.3f} finite")
    if not all(v > 0 for v in launches.values()):
        raise SystemExit(f"phase 3 failed: a kernel was not launched: {launches}")
    results["launches_serving"] = launches

    # a 512 x 512 view worth of rays, made like bench.py:91-97
    rng = np.random.RandomState(0)
    n = 1 << 18
    rays = rng.rand(n, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    ts = rng.randint(0, 30, n).astype(np.int32)
    res = system.render_image(params, rays, ts)  # warm up
    reps, t0 = 1, time.perf_counter()
    for _ in range(reps):
        res = system.render_image(params, rays, ts)
    dt = (time.perf_counter() - t0) / reps
    for k, v in res.items():
        if v.shape[0] != n or not np.isfinite(v).all():
            raise SystemExit(f"phase 3 failed: render_image {k} {v.shape}")
    log(f"phase 3: render_image {n} rays (chunk {cfg.chunk}, "
        f"{str(system.compute_dtype).split('.')[-1]}): "
        f"{dt:.3f} s, {n / dt:.1f} rays/s on {card}")

    # the system's products against the plain version on the first rays of
    # the first chunk and on the last rays of that chunk (the highest point
    # indices a launch addresses)
    from satnerf_tpu_torch.render.sampling import stratified_zvals

    m = 4096
    keys = ("rgb", "depth", "sun", "sky", "albedo", "beta", "opacity")
    errs = dict.fromkeys(keys, 0.0)
    for lo in (0, cfg.chunk - m):
        sl = slice(lo, lo + m)
        with torch.inference_mode():
            r = torch.from_numpy(rays[sl]).to("cuda")
            t_e = params["embedding_t"](torch.from_numpy(ts[sl]).long().to("cuda"))
            z = stratified_zvals(None, r[:, 6:7], r[:, 7:8], SAMPLES, perturb=0.0)
            ref = FM.fused_render_rays_reference(
                params["nerf_coarse"], r[:, 0:3], r[:, 3:6], r[:, 8:11], t_e, z,
                layers=LAYERS, feat=FEAT, tau=TAU, dtype=system.compute_dtype)
        for k in keys:
            e = np.abs(res[f"{k}_coarse"][sl].reshape(m, -1)
                       - ref[k].float().cpu().numpy().reshape(m, -1)).max()
            errs[k] = max(errs[k], float(e))
    log(f"phase 3: render_image vs plain version on rays [0, {m}) and "
        f"[{cfg.chunk - m}, {cfg.chunk}): "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    lim = K2_TOL["bfloat16"]
    if not all(e <= lim * (DEPTH_RANGE if k == "depth" else 1.0)
               for k, e in errs.items()):
        raise SystemExit(f"phase 3 failed: render_image disagrees: {errs}")


TRAIN_STEPS, RESUME_STEPS, LOG_EVERY = 120, 144, 8


def _train_rows(logs: str, exp_name: str) -> list:
    with open(os.path.join(logs, exp_name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "train/loss" in r]


def _steady(rows: list, spe: int) -> list:
    """The log rows whose interval holds no validation. The loop validates
    after the step that ends an epoch, once that step is logged, and its
    rays/s clock runs on through it (as the JAX loop's does): the row at step
    s covers the time from the log at s - LOG_EVERY, so it holds a validation
    when an epoch ends at a step in [s - LOG_EVERY, s). (The sanity
    validation runs before the clock starts.)"""
    return [r for r in rows if not any(
        c > 0 and c % spe == 0 for c in range(r["step"] - LOG_EVERY, r["step"]))]


def phase4(results: dict, card: str):
    """The trainer through its entry point, then resume, then serve."""
    import torch

    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi
    from satnerf_tpu_torch.ops import fused_mlp as FM

    aoi = os.path.join(WORK, "aoi")
    if not os.path.isdir(os.path.join(aoi, "data")):
        make_synthetic_aoi(aoi, size=128)
    logs, ckpts = os.path.join(WORK, "train_logs"), os.path.join(WORK, "train_ckpts")
    for d in (logs, ckpts):
        shutil.rmtree(d, ignore_errors=True)

    def argv(steps, name, extra=()):
        return ["--root_dir", os.path.join(aoi, "data"),
                "--gt_dir", os.path.join(aoi, "gt"), "--model", "sat-nerf",
                "--exp_name", name, "--fc_layers", str(LAYERS),
                "--fc_units", str(FEAT), "--n_samples", str(SAMPLES),
                "--batch_size", str(BATCH), "--chunk", str(CHUNK),
                "--max_train_steps", str(steps), "--first_beta_epoch", "1",
                "--save_every_n_epochs", "1", "--num_sanity_val_steps", "1",
                "--log_every_n_steps", str(LOG_EVERY), "--logs_dir", logs,
                "--ckpts_dir", ckpts, *extra]

    _reset_launches()
    t0 = time.perf_counter()
    first = _train_one(argv(TRAIN_STEPS, "smoke_train"))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _counts()
    cfg, system, state = first["cfg"], first["system"], first["state"]
    spe = system.spe
    if system.device.type != "cuda" or system.compute_dtype != torch.bfloat16:
        raise SystemExit(f"phase 4 failed: trained on {system.device} in "
                         f"{system.compute_dtype}, not on the card in bf16")
    if not TRAIN_STEPS > 2 * spe:
        raise SystemExit(f"phase 4 failed: {TRAIN_STEPS} steps do not pass two "
                         f"epoch boundaries of {spe} steps")
    # every step goes through the K1 chain: 1 composite_loss_bwd, 13 dgrad
    # and 13 wgrad launches a step (dC of sun_v_0, beta_0 and the skip layer
    # folded into their wgmma epilogues), 2 narrow_grads launches (layer 0's
    # db and dC; sky_0's db and dC joined with beta_0's t_grad) and no column
    # walk; validation launches none of these
    per_step = {"composite_loss_bwd": 1, "siren_dense_dgrad": 13,
                "siren_dense_wgrad": 13, "narrow_grads": 2, "small_grads": 0}
    for k, n in per_step.items():
        if launches[k] != n * TRAIN_STEPS:
            raise SystemExit(f"phase 4 failed: {k} launched {launches[k]} times "
                             f"in {TRAIN_STEPS} steps, expected {n} a step")
    if not all(launches[k] > 0 for k in TRAIN_KERNELS + ("heads_composite",
                                                         "siren_dense_k0")):
        raise SystemExit(f"phase 4 failed: a kernel was not launched: {launches}")
    # the draws: the batch's indices (randint) and its depths' jitter
    # (uniform) a step; validation draws nothing
    if launches[DRAW_KERNEL] != 2 * TRAIN_STEPS:
        raise SystemExit(f"phase 4 failed: {DRAW_KERNEL} launched "
                         f"{launches[DRAW_KERNEL]} times in {TRAIN_STEPS} "
                         f"steps, expected 2 a step")
    results["launches"] = launches
    # every bf16 launch with K > 0 of the three kernels with a wgmma mainloop
    # went through it (the rest of siren_dense's: K = 0, layer 0 and sky_0,
    # on the K = 0 kernel, none on k0_v1; the wgrad has no launch at K = 0)
    loops = {k: dict(n for n in FM.MAINLOOP_LAUNCHES.items() if n[0][0] == k)
             for k in ("siren_dense", "siren_dense_dgrad", "siren_dense_wgrad")}
    for k, by in loops.items():
        wg, k0 = by.get((k, "wgmma"), 0), by.get((k, "k0"), 0)
        if wg == 0 or wg + k0 != launches[k]:
            raise SystemExit(f"phase 4 failed: {k} launched {launches[k]} times, "
                             f"by mainloop {by}: not every one with K > 0 on wgmma")
    results["mainloop_launches"] = {k: {m: n for (_, m), n in by.items()}
                                    for k, by in loops.items()}
    log(f"phase 4: launches by mainloop {results['mainloop_launches']}")
    results["body_launches"] = _on_block("phase 4", launches, ("composite_loss_bwd",))
    log(f"phase 4: launches by body {results['body_launches']}")

    rows = _train_rows(logs, cfg.exp_name)
    gate_on = [r for r in rows if system.beta_gate(r["step"] - 1) == 1.0]
    gate_off = [r for r in rows if system.beta_gate(r["step"] - 1) == 0.0]
    if not gate_on or not gate_off:
        raise SystemExit("phase 4 failed: the run did not cross the beta switch-on")
    if not all(np.isfinite(r["train/loss"]) for r in rows):
        raise SystemExit("phase 4 failed: a logged loss is not finite")
    # the loss changes its definition at the switch-on (MSE, then the
    # uncertainty loss), so it must fall within each stretch; the PSNR, which
    # is of the MSE throughout, must rise over the whole run
    falls = (gate_off[-1]["train/loss"] < gate_off[0]["train/loss"]
             and gate_on[-1]["train/loss"] < gate_on[0]["train/loss"]
             and rows[-1]["train/psnr"] > rows[0]["train/psnr"])
    log(f"phase 4: cli.train {TRAIN_STEPS} steps ({spe} an epoch) in "
        f"{train_s:.1f} s with validation; loss {gate_off[0]['train/loss']:.4f}"
        f" -> {gate_off[-1]['train/loss']:.4f} (MSE, steps <= {gate_off[-1]['step']}), "
        f"{gate_on[0]['train/loss']:.4f} -> {gate_on[-1]['train/loss']:.4f} "
        f"(beta loss on); psnr {rows[0]['train/psnr']:.2f} -> "
        f"{rows[-1]['train/psnr']:.2f}; launches {launches}")
    if not falls:
        raise SystemExit("phase 4 failed: the loss did not fall")
    val = first["metrics"]
    if set(val) != {"val/psnr", "val/ssim", "val/mae"} or not all(
            np.isfinite(v) for v in val.values()):
        raise SystemExit(f"phase 4 failed: validation metrics {val}")
    log("phase 4: " + ", ".join(f"{k} {v:.4f}" for k, v in val.items()))
    # steady-state rate: the log intervals after the first (which holds the
    # first launches) and without validation (the loop's clock runs on
    # through it)
    rates = sorted(r["train/rays_per_sec"] for r in _steady(rows[1:], spe))
    rps = rates[len(rates) // 2]
    results["train_rate"] = (rps / BATCH, rps)
    log(f"phase 4: training rate (median of {len(rates)} log intervals of "
        f"{LOG_EVERY} steps): {rps / BATCH:.2f} steps/s, {rps:.1f} rays/s, "
        f"{1e3 * BATCH / rps:.2f} ms a step on {card}")

    epoch = TRAIN_STEPS // spe
    ckpt = os.path.join(ckpts, cfg.exp_name, f"epoch={epoch}.ckpt")
    saved = torch.load(ckpt, weights_only=True)
    if saved["global_step"] != TRAIN_STEPS or not saved["optimizer_states"]:
        raise SystemExit(f"phase 4 failed: {ckpt} holds step "
                         f"{saved.get('global_step')} / no optimizer state")
    second = _train_one(argv(RESUME_STEPS, "smoke_resume",
                                 ["--ckpt_path", ckpt]))
    rows2 = _train_rows(logs, second["cfg"].exp_name)
    # "at the trained level": within a quarter of the way from the loss the
    # first run ended at back to the loss it had when the beta term came on
    trained, untrained = rows[-1]["train/loss"], gate_on[0]["train/loss"]
    adam_steps = {float(st["step"])
                  for st in second["state"].optimizer.state.values()}
    ok = (second["state"].step == RESUME_STEPS
          and rows2[0]["step"] == TRAIN_STEPS + LOG_EVERY
          and adam_steps == {float(RESUME_STEPS)}
          and abs(rows2[0]["train/loss"] - trained) <= 0.25 * (untrained - trained))
    log(f"phase 4: resumed from step {saved['global_step']} to "
        f"{second['state'].step}; first logged loss {rows2[0]['train/loss']:.4f} "
        f"psnr {rows2[0]['train/psnr']:.2f} (the first run ended at "
        f"{rows[-1]['train/loss']:.4f}, {rows[-1]['train/psnr']:.2f})")
    if not ok:
        raise SystemExit("phase 4 failed: the resumed run did not continue the "
                         "first (step count, Adam state or loss level)")

    exp2 = second["cfg"].exp_name
    out_dir = os.path.join(WORK, "train_out")
    mae = create_pretty_dsm(exp2, logs, out_dir, RESUME_STEPS // spe,
                            device="cuda")
    if not (mae is not None and np.isfinite(mae)):
        raise SystemExit(f"phase 4 failed: serving the trained checkpoint, MAE {mae}")
    log(f"phase 4: create_pretty_dsm on the trained checkpoint: MAE {mae:.3f} m")


FULL_STEPS, FULL_DROP, SHORT_STEPS = 96, 0.75, 8


def phase5(results: dict, card: str):
    """The full recipe through the trainer's entry point: solar correction
    and depth supervision, then grad_accum and shuffle."""
    import torch

    from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi

    aoi = os.path.join(WORK, "aoi_kp")
    t0 = time.perf_counter()
    make_synthetic_aoi(aoi, size=128, with_keypoints=True, n_kp=3000)
    log(f"phase 5: synthetic 128 x 128 AOI with 3000 tie points in "
        f"{time.perf_counter() - t0:.1f} s")
    logs, ckpts = os.path.join(WORK, "full_logs"), os.path.join(WORK, "full_ckpts")

    def argv(steps, name, extra=()):
        return ["--root_dir", os.path.join(aoi, "data"),
                "--gt_dir", os.path.join(aoi, "gt"), "--model", "sat-nerf",
                "--exp_name", name, "--fc_layers", str(LAYERS),
                "--fc_units", str(FEAT), "--n_samples", str(SAMPLES),
                "--batch_size", str(BATCH), "--chunk", str(CHUNK),
                "--max_train_steps", str(steps), "--first_beta_epoch", "1",
                "--save_every_n_epochs", "1", "--num_sanity_val_steps", "1",
                "--log_every_n_steps", str(LOG_EVERY), "--logs_dir", logs,
                "--ckpts_dir", ckpts, "--sc_lambda", "0.1", "--ds_lambda",
                "1000", "--ds_drop", str(FULL_DROP), *extra]

    def run(steps, name, extra=()):
        _reset_launches()
        t0 = time.perf_counter()
        out = _train_one(argv(steps, name, extra))
        torch.cuda.synchronize()
        return out, _counts(), time.perf_counter() - t0

    def check_counts(what, launches, micro, active):
        """micro micro-batches ran, `active` of them with the depth term on.
        A micro-batch launches siren_dense 15 (K1) + 12 (K3) + 15 (K4) times
        and a served chunk 15 times, so the serving chunks follow from
        siren_dense's count, and heads_composite must have run once a
        micro-batch (K4's forward) and once a served chunk."""
        want = {"composite_loss_bwd": micro, "sc_loss_bwd": micro,
                "composite_bwd": active,
                "siren_dense_dgrad": 13 * micro + 11 * micro + 13 * active,
                # the layers with X: K1 and K4 13 of their 15, K3 11 of 12
                "siren_dense_wgrad": 13 * micro + 11 * micro + 13 * active,
                # K1 and K4: layer 0, and sky_0 joined with beta_0's t_grad;
                # K3: layer 0 (sun_v_0 and the skip layer fold dC)
                "narrow_grads": 2 * micro + 1 * micro + 2 * active,
                "small_grads": 0}
        for k, n in want.items():
            if launches[k] != n:
                raise SystemExit(f"phase 5 failed ({what}): {k} launched "
                                 f"{launches[k]} times, expected {n}")
        served, rest = divmod(launches["siren_dense"] - 42 * micro, 15)
        if rest or served < 1 or launches["heads_composite"] != micro + served:
            raise SystemExit(f"phase 5 failed ({what}): heads_composite "
                             f"launched {launches['heads_composite']} times for "
                             f"{micro} micro-batches and {served} served chunks "
                             f"(siren_dense {launches['siren_dense']})")

    full, launches, train_s = run(FULL_STEPS, "smoke_full")
    cfg, system = full["cfg"], full["system"]
    spe, drop = system.spe, system.ds_drop_step
    if system.device.type != "cuda" or system.compute_dtype != torch.bfloat16:
        raise SystemExit(f"phase 5 failed: trained on {system.device} in "
                         f"{system.compute_dtype}, not on the card in bf16")
    if not (spe < drop < FULL_STEPS and drop == round(FULL_DROP * FULL_STEPS)):
        raise SystemExit(f"phase 5 failed: {FULL_STEPS} steps, {spe} an epoch, "
                         f"depth term dropping at {drop}: the run must cross "
                         f"an epoch boundary and then the drop")
    active = drop - 1  # steps 0 .. drop - 2: step + 1 < ds_drop_step
    check_counts("full recipe", launches, FULL_STEPS, active)
    # the draws: the color and the depth batch's indices and jitters a step
    if launches[DRAW_KERNEL] != 4 * FULL_STEPS:
        raise SystemExit(f"phase 5 failed: {DRAW_KERNEL} launched "
                         f"{launches[DRAW_KERNEL]} times in {FULL_STEPS} "
                         f"steps, expected 4 a step")
    results["launches_full"] = launches
    by_body = _on_block("phase 5", launches)
    results["body_launches"]["composite_bwd"] = by_body["composite_bwd"]
    log(f"phase 5: launches by body {by_body}")

    rows = _train_rows(logs, cfg.exp_name)
    if not all("train/loss_depth" in r and np.isfinite(r["train/loss_depth"])
               and np.isfinite(r["train/loss"]) for r in rows):
        raise SystemExit("phase 5 failed: loss or loss_depth missing or not finite")
    gate_off = [r for r in rows if system.beta_gate(r["step"] - 1) == 0.0]
    gate_on = [r for r in rows if system.beta_gate(r["step"] - 1) == 1.0]
    on_rows = [r for r in rows if r["step"] < drop]  # logged while active
    if not gate_off or not gate_on:
        raise SystemExit("phase 5 failed: the run did not cross the beta switch-on")
    falls = (gate_off[-1]["train/loss"] < gate_off[0]["train/loss"]
             and gate_on[-1]["train/loss"] < gate_on[0]["train/loss"]
             and on_rows[-1]["train/loss_depth"] < on_rows[0]["train/loss_depth"]
             and rows[-1]["train/psnr"] > rows[0]["train/psnr"])
    log(f"phase 5: cli.train --sc_lambda 0.1 --ds_lambda 1000, {FULL_STEPS} "
        f"steps ({spe} an epoch, depth term off from step {drop}) in "
        f"{train_s:.1f} s with validation; loss {gate_off[0]['train/loss']:.4f}"
        f" -> {gate_off[-1]['train/loss']:.4f} (MSE + SC), "
        f"{gate_on[0]['train/loss']:.4f} -> {gate_on[-1]['train/loss']:.4f} "
        f"(beta loss on); loss_depth {on_rows[0]['train/loss_depth']:.3f} -> "
        f"{on_rows[-1]['train/loss_depth']:.3f} while supervised, "
        f"{rows[-1]['train/loss_depth']:.3f} at the end; psnr "
        f"{rows[0]['train/psnr']:.2f} -> {rows[-1]['train/psnr']:.2f}; "
        f"launches {launches}")
    if not falls:
        raise SystemExit("phase 5 failed: a loss did not fall")
    val = full["metrics"]
    if not all(np.isfinite(v) for v in val.values()):
        raise SystemExit(f"phase 5 failed: validation metrics {val}")
    log("phase 5: " + ", ".join(f"{k} {v:.4f}" for k, v in val.items()))

    def median_rate(sel):
        rates = sorted(r["train/rays_per_sec"] for r in _steady(sel, spe))
        return rates[len(rates) // 2], len(rates)

    # the full recipe's rate: log intervals with all three passes, without
    # the first (it holds the first launches); then the rate once the depth
    # pass renders forward only
    rps, n = median_rate(on_rows[1:])
    rps_after, n_after = median_rate([r for r in rows if r["step"] >= drop + LOG_EVERY])
    results["full_rate"] = (rps / BATCH, rps)
    log(f"phase 5: full-recipe rate (median of {n} log intervals of {LOG_EVERY} "
        f"steps): {rps / BATCH:.2f} steps/s, {rps:.1f} rays/s, "
        f"{1e3 * BATCH / rps:.2f} ms a step; after the depth term dropped "
        f"(median of {n_after}): {1e3 * BATCH / rps_after:.2f} ms a step on {card}")

    # --grad_accum 2: two micro-batches a step, half as many steps an epoch;
    # with sigma noise (off by default), so that the entry point also drives
    # the noise instantiations of the per-ray kernels
    out, launches, _ = run(SHORT_STEPS, "smoke_accum",
                           ["--grad_accum", "2", "--noise_std", "1.0"])
    if out["system"].spe != spe // 2 or out["state"].step != SHORT_STEPS:
        raise SystemExit("phase 5 failed: grad_accum 2 did not halve the epoch")
    active = min(SHORT_STEPS, out["system"].ds_drop_step - 1)
    check_counts("grad_accum 2", launches, 2 * SHORT_STEPS, 2 * active)
    rows = _train_rows(logs, out["cfg"].exp_name)
    if not (rows and np.isfinite(rows[-1]["train/loss"])):
        raise SystemExit("phase 5 failed: grad_accum 2 logged no finite loss")
    log(f"phase 5: --grad_accum 2 --noise_std 1.0, {SHORT_STEPS} steps: loss "
        f"{rows[-1]['train/loss']:.4f}, launches {launches}")

    out, launches, _ = run(SHORT_STEPS, "smoke_shuffle", ["--sampling", "shuffle"])
    active = min(SHORT_STEPS, out["system"].ds_drop_step - 1)
    check_counts("shuffle", launches, SHORT_STEPS, active)
    rows = _train_rows(logs, out["cfg"].exp_name)
    if not (rows and np.isfinite(rows[-1]["train/loss"])):
        raise SystemExit("phase 5 failed: --sampling shuffle logged no finite loss")
    log(f"phase 5: --sampling shuffle, {SHORT_STEPS} steps: loss "
        f"{rows[-1]['train/loss']:.4f}, launches {launches}")


HIER_STEPS, HIER_RESUME, HIER_DROP = 72, 80, 0.75
ON_IMPORTANCE = 8  # the --fused on run's resampled depths a ray


def phase6(results: dict, card: str):
    """Hierarchical sampling through the entry points: the two-launch
    dispatch of the trainer and the server, the depth pass over K5, then
    --fused on (K6) and --fused off."""
    import torch

    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.ops import fused_mlp as FM

    aoi = os.path.join(WORK, "aoi_kp")  # phase 5's, with its tie points
    logs, ckpts = os.path.join(WORK, "hier_logs"), os.path.join(WORK, "hier_ckpts")

    def argv(steps, name, n_imp, extra=()):
        return ["--root_dir", os.path.join(aoi, "data"),
                "--gt_dir", os.path.join(aoi, "gt"), "--model", "sat-nerf",
                "--exp_name", name, "--fc_layers", str(LAYERS),
                "--fc_units", str(FEAT), "--n_samples", str(SAMPLES),
                "--n_importance", str(n_imp),
                "--batch_size", str(BATCH), "--chunk", str(CHUNK),
                "--max_train_steps", str(steps), "--first_beta_epoch", "1",
                "--save_every_n_epochs", "1", "--num_sanity_val_steps", "1",
                "--log_every_n_steps", str(LOG_EVERY), "--logs_dir", logs,
                "--ckpts_dir", ckpts, "--sc_lambda", "0.1", "--ds_lambda",
                "1000", "--ds_drop", str(HIER_DROP), *extra]

    def run(steps, name, n_imp, extra=()):
        _reset_launches()
        t0 = time.perf_counter()
        out = _train_one(argv(steps, name, n_imp, extra))
        torch.cuda.synchronize()
        return out, _counts(), time.perf_counter() - t0

    def fail(msg):
        raise SystemExit(f"phase 6 failed: {msg}")

    # ---- the main run: rays mode, 64 + 64 samples, SC and DS
    hier, launches, train_s = run(HIER_STEPS, "smoke_hier", N_IMPORTANCE)
    cfg, system = hier["cfg"], hier["system"]
    spe, drop = system.spe, system.ds_drop_step
    if (system.device.type != "cuda" or system.compute_dtype != torch.bfloat16
            or system.fused_mode != "rays"):
        fail(f"trained on {system.device} in {system.compute_dtype}, mode "
             f"{system.fused_mode}: not on the card in bf16 through the per-ray "
             f"kernels")
    if not (spe < drop < HIER_STEPS and drop == round(HIER_DROP * HIER_STEPS)):
        fail(f"{HIER_STEPS} steps, {spe} an epoch, depth term dropping at {drop}: "
             f"the run must cross an epoch boundary and then the drop")
    active = drop - 1  # steps 0 .. drop - 2: step + 1 < ds_drop_step
    # a step: the loss chain (15 forward, 13 dgrad, 13 wgrad, 2 narrow_grads
    # launches) and the solar-correction chain (12, 11, 11, 1) once a model,
    # and the depth render over the ray-mode field once a model (15 forward;
    # 13, 13 and 2 backward while the depth term is on). A served chunk: 15
    # forward launches a model.
    n = HIER_STEPS
    want = {"composite_loss_bwd": 2 * n, "sc_loss_bwd": 2 * n,
            "field_heads": 2 * n, "field_heads_bwd": 2 * active,
            "composite_bwd": 0,
            "siren_dense_dgrad": (26 + 22) * n + 26 * active,
            "siren_dense_wgrad": (26 + 22) * n + 26 * active,
            "narrow_grads": (4 + 2) * n + 4 * active, "small_grads": 0}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"{k} launched {launches[k]} times in {n} steps "
                 f"({active} with the depth term), expected {v}")
    served, rest = divmod(launches["siren_dense"] - 84 * n, 30)
    if rest or served < 1 or launches["heads_composite"] != 2 * served:
        fail(f"heads_composite launched {launches['heads_composite']} times for "
             f"{served} served chunks of two models (siren_dense "
             f"{launches['siren_dense']})")
    results["launches_hier"] = launches

    rows = _train_rows(logs, cfg.exp_name)
    if not all("train/loss_depth" in r and np.isfinite(r["train/loss_depth"])
               and np.isfinite(r["train/loss"]) for r in rows):
        fail("loss or loss_depth missing or not finite")
    gate_off = [r for r in rows if system.beta_gate(r["step"] - 1) == 0.0]
    gate_on = [r for r in rows if system.beta_gate(r["step"] - 1) == 1.0]
    on_rows = [r for r in rows if r["step"] < drop]
    if not gate_off or not gate_on:
        fail("the run did not cross the beta switch-on")
    falls = (gate_off[-1]["train/loss"] < gate_off[0]["train/loss"]
             and gate_on[-1]["train/loss"] < gate_on[0]["train/loss"]
             and on_rows[-1]["train/loss_depth"] < on_rows[0]["train/loss_depth"]
             and rows[-1]["train/psnr"] > rows[0]["train/psnr"])
    log(f"phase 6: cli.train --n_importance {N_IMPORTANCE} --sc_lambda 0.1 "
        f"--ds_lambda 1000, {n} steps ({spe} an epoch, depth term off from step "
        f"{drop}) in {train_s:.1f} s with validation; loss (coarse + fine) "
        f"{gate_off[0]['train/loss']:.4f} -> {gate_off[-1]['train/loss']:.4f} "
        f"(MSE + SC), {gate_on[0]['train/loss']:.4f} -> "
        f"{gate_on[-1]['train/loss']:.4f} (beta loss on); loss_depth "
        f"{on_rows[0]['train/loss_depth']:.3f} -> "
        f"{on_rows[-1]['train/loss_depth']:.3f} while supervised; psnr (fine) "
        f"{rows[0]['train/psnr']:.2f} -> {rows[-1]['train/psnr']:.2f}; "
        f"launches {launches}")
    if not falls:
        fail("a loss did not fall")
    val = hier["metrics"]
    if set(val) != {"val/psnr", "val/ssim", "val/mae"} or not all(
            np.isfinite(v) for v in val.values()):
        fail(f"validation metrics {val}")
    log("phase 6: " + ", ".join(f"{k} {v:.4f}" for k, v in val.items()))

    def median_ms(sel):
        rates = sorted(r["train/rays_per_sec"] for r in _steady(sel, spe))
        return 1e3 * BATCH / rates[len(rates) // 2], len(rates)

    ms_on, n_on = median_ms(on_rows[1:])
    ms_after, n_after = median_ms([r for r in rows if r["step"] >= drop + LOG_EVERY])
    results["hier_rate"] = (1e3 / ms_on, 1e3 * BATCH / ms_on)
    log(f"phase 6: hierarchical full-recipe rate (median of {n_on} log "
        f"intervals of {LOG_EVERY} steps): {1e3 / ms_on:.2f} steps/s, "
        f"{1e3 * BATCH / ms_on:.1f} rays/s, {ms_on:.2f} ms a step; after the "
        f"depth term dropped (median of {n_after}): {ms_after:.2f} ms a step "
        f"on {card}")

    # ---- resume, then serve the trained checkpoint
    epoch = HIER_STEPS // spe
    ckpt = os.path.join(ckpts, cfg.exp_name, f"epoch={epoch}.ckpt")
    saved = torch.load(ckpt, weights_only=True)
    if saved["global_step"] != HIER_STEPS or not any(
            k.startswith("nerf_fine.") for k in saved["state_dict"]):
        fail(f"{ckpt} holds step {saved.get('global_step')} or no fine model")
    second, _, _ = run(HIER_RESUME, "smoke_hier_resume", N_IMPORTANCE,
                       ["--ckpt_path", ckpt])
    rows2 = _train_rows(logs, second["cfg"].exp_name)
    trained, untrained = rows[-1]["train/loss"], gate_on[0]["train/loss"]
    adam_steps = {float(st["step"])
                  for st in second["state"].optimizer.state.values()}
    if not (second["state"].step == HIER_RESUME
            and rows2[0]["step"] == HIER_STEPS + LOG_EVERY
            and adam_steps == {float(HIER_RESUME)}
            # the loss is still falling when the first run ends: the resumed
            # run goes on from the trained level, not from a fresh model's
            and rows2[0]["train/loss"]
            <= trained + 0.25 * (untrained - trained)):
        fail("the resumed run did not continue the first (step count, Adam "
             "state or loss level)")
    log(f"phase 6: resumed from step {saved['global_step']} to "
        f"{second['state'].step}; first logged loss {rows2[0]['train/loss']:.4f} "
        f"(the first run ended at {trained:.4f})")
    mae = create_pretty_dsm(second["cfg"].exp_name, logs,
                            os.path.join(WORK, "hier_out"), HIER_RESUME // spe,
                            device="cuda")
    if not (mae is not None and np.isfinite(mae)):
        fail(f"serving the trained checkpoint, MAE {mae}")
    log(f"phase 6: create_pretty_dsm on the trained checkpoint: MAE {mae:.3f} m")

    # ---- render_image at n_importance 64: rays/s and the chunk's peak memory
    rng = np.random.RandomState(0)
    n_rays = 1 << 18
    rays = rng.rand(n_rays, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 8:11] /= np.linalg.norm(rays[:, 8:11], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    ts = rng.randint(0, 30, n_rays).astype(np.int32)
    params = second["state"].params
    system.render_image(params, rays[:CHUNK], ts[:CHUNK])  # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    res = system.render_image(params, rays, ts)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for k, v in res.items():
        if v.shape[0] != n_rays or not np.isfinite(v).all():
            fail(f"render_image {k} {v.shape}")
    chunks = n_rays // CHUNK
    pieces = -(-(SAMPLES + N_IMPORTANCE) * CHUNK // (1 << 22))
    if FM.LAUNCHES["heads_composite"] != chunks * (1 + pieces):
        fail(f"render_image launched heads_composite "
             f"{FM.LAUNCHES['heads_composite']} times for {chunks} chunks of one "
             f"coarse pass and {pieces} fine pieces")
    log(f"phase 6: render_image {n_rays} rays at --n_importance {N_IMPORTANCE} "
        f"(chunk {CHUNK}, the fine pass in {pieces} pieces): {dt:.3f} s, "
        f"{n_rays / dt:.1f} rays/s, peak device memory {peak:.2f} GiB on {card}")
    # the fine products against the plain version on the last rays of a
    # chunk, at the depths the kernels' own coarse weights resample (the plain
    # version's coarse weights differ by bf16 rounding steps, and a resampled
    # depth inside an empty stretch of the ray moves far on such a step)
    from satnerf_tpu_torch.render.render import resample_zvals
    from satnerf_tpu_torch.render.sampling import stratified_zvals

    m = 2048
    sl = slice(CHUNK - m, CHUNK)
    kw = dict(layers=LAYERS, feat=FEAT, tau=TAU, dtype=system.compute_dtype)
    with torch.inference_mode():
        r = torch.from_numpy(rays[sl]).to("cuda")
        t_e = params["embedding_t"](torch.from_numpy(ts[sl]).long().to("cuda"))
        z = stratified_zvals(None, r[:, 6:7], r[:, 7:8], SAMPLES, perturb=0.0)
        rargs = (r[:, 0:3], r[:, 3:6], r[:, 8:11], t_e)
        coarse = FM.fused_render_rays(params["nerf_coarse"], *rargs, z,
                                      return_weights=True, **kw)
        c_ref = FM.fused_render_rays_reference(params["nerf_coarse"], *rargs, z,
                                               return_weights=True, **kw)
        z_all = resample_zvals(None, z, coarse["weights"], N_IMPORTANCE, det=True)
        ref = FM.fused_render_rays_reference(params["nerf_fine"], *rargs, z_all,
                                             **kw)
    errs = {k: float(np.abs(res[f"{k}_fine"][sl].reshape(m, -1)
                            - ref[k].float().cpu().numpy().reshape(m, -1)).max())
            for k in ("rgb", "depth", "sun", "sky", "albedo", "beta", "opacity")}
    errs["coarse weights"] = (coarse["weights"] - c_ref["weights"]).abs().max().item()
    log(f"phase 6: render_image's fine products vs the plain version on rays "
        f"[{CHUNK - m}, {CHUNK}): " + ", ".join(f"{k} {e:.2e}"
                                                for k, e in errs.items()))
    if not all(e <= K2_TOL["bfloat16"] for e in errs.values()):
        fail(f"render_image's fine products disagree: {errs}")

    # ---- past 256 samples a ray: --n_importance 256 over 64, a fine pass of
    # 320 through the per-ray kernels (two samples a thread of the block
    # body), the main path's loss alone (no SC, no DS)
    out, launches, long_s = run(LONG_STEPS, "smoke_long", LONG_IMPORTANCE,
                                ["--sc_lambda", "0", "--ds_lambda", "0"])
    if out["system"].fused_mode != "rays" or out["state"].step != LONG_STEPS:
        fail("--n_importance 256 did not train through the per-ray kernels")
    want = {"composite_loss_bwd": 2 * LONG_STEPS, "sc_loss_bwd": 0,
            "composite_bwd": 0, "siren_dense_wgrad": 26 * LONG_STEPS,
            "narrow_grads": 4 * LONG_STEPS, "small_grads": 0}
    if any(launches[k] != v for k, v in want.items()):
        fail(f"--n_importance 256 launches {launches}, expected {want}")
    _on_block("phase 6 (--n_importance 256)", launches, ("composite_loss_bwd",))
    rows = _train_rows(logs, out["cfg"].exp_name)
    if not (len(rows) >= 2 and all(np.isfinite(r["train/loss"]) for r in rows)
            and rows[-1]["train/loss"] < rows[0]["train/loss"]
            and all(np.isfinite(v) for v in out["metrics"].values())):
        fail(f"--n_importance 256: the loss is not finite and falling: "
             f"{[r['train/loss'] for r in rows]}")
    log(f"phase 6: --n_importance {LONG_IMPORTANCE} (a fine pass of "
        f"{SAMPLES + LONG_IMPORTANCE} samples), {LONG_STEPS} steps in "
        f"{long_s:.1f} s with validation: loss {rows[0]['train/loss']:.4f} -> "
        f"{rows[-1]['train/loss']:.4f}, val/mae {out['metrics']['val/mae']:.3f}, "
        f"composite_loss_bwd {launches['composite_loss_bwd']} launches a block "
        f"a ray")
    results["launches_long"] = launches

    # ---- --fused on: the plain renderer over the point-mode field kernel
    steps = SHORT_STEPS
    out, launches, on_s = run(steps, "smoke_fused_on", ON_IMPORTANCE,
                              ["--fused", "on"])
    if out["system"].fused_mode != "points" or out["state"].step != steps:
        fail("--fused on did not run in points mode")
    act = min(steps, out["system"].ds_drop_step - 1)
    # a step, once a model: the color render, its sun-ray pass and the depth
    # render, each with its backward (the depth render's while the term is on);
    # a served chunk: one forward a model
    served, rest = divmod(launches["field_heads"] - 6 * steps, 2)
    want = {"field_heads_bwd": 4 * steps + 2 * act, "composite_loss_bwd": 0,
            "sc_loss_bwd": 0, "composite_bwd": 0, "heads_composite": 0}
    if rest or served < 1 or any(launches[k] != v for k, v in want.items()):
        fail(f"--fused on launches {launches}, expected {want} and field_heads "
             f"6 a step + 2 a served chunk")
    results["launches_fused_on"] = launches
    rows = _train_rows(logs, out["cfg"].exp_name)
    if not (rows and np.isfinite(rows[-1]["train/loss"])
            and all(np.isfinite(v) for v in out["metrics"].values())):
        fail("--fused on logged no finite loss or validation")
    log(f"phase 6: --fused on --n_importance {ON_IMPORTANCE}, {steps} steps in "
        f"{on_s:.1f} s with validation: loss {rows[-1]['train/loss']:.4f}, "
        f"{1e3 * BATCH / rows[-1]['train/rays_per_sec']:.1f} ms a step, val/mae "
        f"{out['metrics']['val/mae']:.3f}, launches {launches}")

    # ---- --fused off on the card: the caller's choice, no field kernel (the
    # draws stay on the card)
    out, launches, off_s = run(steps, "smoke_fused_off", ON_IMPORTANCE,
                               ["--fused", "off"])
    if (out["system"].fused_mode != "off"
            or any(_field_launches(launches).values())
            or not launches[DRAW_KERNEL]):
        fail(f"--fused off launched field kernels, or drew off the card: "
             f"{launches}")
    rows = _train_rows(logs, out["cfg"].exp_name)
    if not (rows and np.isfinite(rows[-1]["train/loss"])
            and all(np.isfinite(v) for v in out["metrics"].values())):
        fail("--fused off logged no finite loss or validation")
    log(f"phase 6: --fused off --n_importance {ON_IMPORTANCE}, {steps} steps in "
        f"{off_s:.1f} s with validation: loss {rows[-1]['train/loss']:.4f}, "
        f"{1e3 * BATCH / rows[-1]['train/rays_per_sec']:.1f} ms a step, no "
        f"kernel launched")


NERF_STEPS, NERF_RESUME = 72, 80


def phase7(results: dict, card: str):
    """The classic NeRF variant through the entry points: K7 under the
    trainer, K8 under validation and the server, K9 under the hierarchical and
    the depth-supervised trainer."""
    import torch

    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.ops import fused_nerf as FN

    aoi, aoi_kp = os.path.join(WORK, "aoi"), os.path.join(WORK, "aoi_kp")
    if not os.path.isdir(os.path.join(aoi, "data")):
        make_synthetic_aoi(aoi, size=128)
    if not os.path.isdir(os.path.join(aoi_kp, "data")):
        make_synthetic_aoi(aoi_kp, size=128, with_keypoints=True, n_kp=3000)
    logs, ckpts = os.path.join(WORK, "nerf_logs"), os.path.join(WORK, "nerf_ckpts")
    for d in (logs, ckpts):
        shutil.rmtree(d, ignore_errors=True)
    siren = TRAIN_KERNELS + AUX_KERNELS + FIELD_KERNELS + ("heads_composite",)

    def argv(root, steps, name, extra=()):
        return ["--root_dir", os.path.join(root, "data"),
                "--gt_dir", os.path.join(root, "gt"), "--model", "nerf",
                "--exp_name", name, "--fc_layers", str(LAYERS),
                "--fc_units", str(NERF_FEAT), "--n_samples", str(SAMPLES),
                "--batch_size", str(BATCH), "--chunk", str(CHUNK),
                "--max_train_steps", str(steps), "--save_every_n_epochs", "1",
                "--num_sanity_val_steps", "1", "--log_every_n_steps",
                str(LOG_EVERY), "--logs_dir", logs, "--ckpts_dir", ckpts, *extra]

    def run(root, steps, name, extra=()):
        _reset_launches()
        t0 = time.perf_counter()
        out = _train_one(argv(root, steps, name, extra))
        torch.cuda.synchronize()
        return out, _counts(), time.perf_counter() - t0

    def fail(msg):
        raise SystemExit(f"phase 7 failed: {msg}")

    def hold(what, launches, want):
        """The launch counts of a run; every bf16 forward, dgrad and wgrad
        launch on the mainloop the rule gives the 8 x 256 chain (wgmma), so
        nerf_bias_grad never runs."""
        for k, v in {**want, "nerf_bias_grad": 0}.items():
            if launches[k] != v:
                fail(f"{what}: {k} launched {launches[k]} times, expected {v}")
        if any(launches[k] for k in siren):
            fail(f"{what}: a SIREN kernel was launched: {launches}")
        by = {k: {m: n for (kk, m), n in FM.MAINLOOP_LAUNCHES.items() if kk == k}
              for k in ("nerf_dense", "nerf_dense_dgrad", "nerf_dense_wgrad")}
        for k, loops in by.items():
            if loops != {"wgmma": launches[k]}:
                fail(f"{what}: {k} launched {launches[k]} times, by mainloop "
                     f"{loops}: not every one on wgmma")
        return by

    # ---- the main run: K7 a step, K8 under validation
    first, launches, train_s = run(aoi, NERF_STEPS, "smoke_nerf")
    cfg, system = first["cfg"], first["system"]
    spe, n = system.spe, NERF_STEPS
    if (system.device.type != "cuda" or system.compute_dtype != torch.bfloat16
            or system.fused_mode != "points"):
        fail(f"trained on {system.device} in {system.compute_dtype}, mode "
             f"{system.fused_mode}: not on the card in bf16 through the kernels")
    if not spe < n:
        fail(f"{n} steps do not pass an epoch boundary of {spe} steps")
    # a step: 10 dense forward, the per-ray loss kernel, 9 dgrad, 10 wgrad; a
    # served chunk: 10 dense forward and the per-ray compositor
    served, rest = divmod(launches["nerf_dense"] - 10 * n, 10)
    if rest or served < 1:
        fail(f"nerf_dense launched {launches['nerf_dense']} times in {n} steps")
    by_loop = hold("cli.train --model nerf", launches,
                   {"nerf_composite_loss_bwd": n, "nerf_dense_dgrad": 9 * n,
                    "nerf_dense_wgrad": 10 * n, "nerf_heads_composite": served,
                    "nerf_field_heads": 0, "nerf_field_heads_bwd": 0})
    results["launches_nerf"] = launches
    results.setdefault("mainloop_launches", {}).update(by_loop)
    log(f"phase 7: launches by mainloop {by_loop}, nerf_bias_grad "
        f"{launches['nerf_bias_grad']}")
    rows = _train_rows(logs, cfg.exp_name)
    if not all(np.isfinite(r["train/loss"]) for r in rows):
        fail("a logged loss is not finite")
    falls = (rows[-1]["train/loss"] < rows[0]["train/loss"]
             and rows[-1]["train/psnr"] > rows[0]["train/psnr"])
    log(f"phase 7: cli.train --model nerf --fc_units {NERF_FEAT}, {n} steps "
        f"({spe} an epoch) in {train_s:.1f} s with validation; loss (MSE) "
        f"{rows[0]['train/loss']:.4f} -> {rows[-1]['train/loss']:.4f}, psnr "
        f"{rows[0]['train/psnr']:.2f} -> {rows[-1]['train/psnr']:.2f}; "
        f"launches { {k: launches[k] for k in NERF_KERNELS} }")
    if not falls:
        fail("the loss did not fall")
    val = first["metrics"]
    if set(val) != {"val/psnr", "val/ssim", "val/mae"} or not all(
            np.isfinite(v) for v in val.values()):
        fail(f"validation metrics {val}")
    log("phase 7: " + ", ".join(f"{k} {v:.4f}" for k, v in val.items()))
    rates = sorted(r["train/rays_per_sec"] for r in _steady(rows[1:], spe))
    rps = rates[len(rates) // 2]
    results["nerf_rate"] = (rps / BATCH, rps)
    log(f"phase 7: nerf training rate (median of {len(rates)} log intervals of "
        f"{LOG_EVERY} steps): {rps / BATCH:.2f} steps/s, {rps:.1f} rays/s, "
        f"{1e3 * BATCH / rps:.2f} ms a step on {card}")

    # ---- resume, then serve the trained checkpoint
    epoch = n // spe
    ckpt = os.path.join(ckpts, cfg.exp_name, f"epoch={epoch}.ckpt")
    saved = torch.load(ckpt, weights_only=True)
    if saved["global_step"] != n or not saved["optimizer_states"]:
        fail(f"{ckpt} holds step {saved.get('global_step')} / no optimizer state")
    second, _, _ = run(aoi, NERF_RESUME, "smoke_nerf_resume", ["--ckpt_path", ckpt])
    rows2 = _train_rows(logs, second["cfg"].exp_name)
    trained, untrained = rows[-1]["train/loss"], rows[0]["train/loss"]
    adam_steps = {float(st["step"])
                  for st in second["state"].optimizer.state.values()}
    if not (second["state"].step == NERF_RESUME
            and rows2[0]["step"] == n + LOG_EVERY
            and adam_steps == {float(NERF_RESUME)}
            # the loss is still falling when the first run ends: the resumed
            # run goes on from the trained level, not from a fresh model's
            and rows2[0]["train/loss"]
            <= trained + 0.25 * (untrained - trained)):
        fail("the resumed run did not continue the first (step count, Adam "
             "state or loss level)")
    log(f"phase 7: resumed from step {saved['global_step']} to "
        f"{second['state'].step}; first logged loss {rows2[0]['train/loss']:.4f} "
        f"(the first run ended at {trained:.4f})")
    mae = create_pretty_dsm(second["cfg"].exp_name, logs,
                            os.path.join(WORK, "nerf_out"), NERF_RESUME // spe,
                            device="cuda")
    if not (mae is not None and np.isfinite(mae)):
        fail(f"serving the trained checkpoint, MAE {mae}")
    log(f"phase 7: create_pretty_dsm on the trained checkpoint: MAE {mae:.3f} m")

    # ---- render_image: rays/s, peak memory, and against the plain version
    rng = np.random.RandomState(0)
    n_rays = 1 << 18
    rays = rng.rand(n_rays, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    params = second["state"].params
    system.render_image(params, rays[:CHUNK], None)  # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    res = system.render_image(params, rays, None)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if set(res) != {"rgb_coarse", "depth_coarse", "opacity_coarse",
                    "weights_coarse"}:
        fail(f"render_image keys {sorted(res)}")
    for k, v in res.items():
        if v.shape[0] != n_rays or not np.isfinite(v).all():
            fail(f"render_image {k} {v.shape}")
    if FM.LAUNCHES["nerf_heads_composite"] != n_rays // CHUNK:
        fail(f"render_image launched nerf_heads_composite "
             f"{FM.LAUNCHES['nerf_heads_composite']} times")
    results["nerf_serve_rate"] = n_rays / dt
    log(f"phase 7: render_image {n_rays} rays (chunk {CHUNK}, bf16): {dt:.3f} s, "
        f"{n_rays / dt:.1f} rays/s, peak device memory {peak:.2f} GiB on {card}")
    from satnerf_tpu_torch.render.sampling import stratified_zvals

    m = 4096
    errs = dict.fromkeys(("rgb", "depth", "opacity"), 0.0)
    for lo in (0, CHUNK - m):
        sl = slice(lo, lo + m)
        with torch.inference_mode():
            r = torch.from_numpy(rays[sl]).to("cuda")
            z = stratified_zvals(None, r[:, 6:7], r[:, 7:8], SAMPLES, perturb=0.0)
            ref = FN.fused_nerf_render_rays_reference(
                params["nerf_coarse"], r[:, 0:3], r[:, 3:6], z, layers=LAYERS,
                feat=NERF_FEAT, dtype=system.compute_dtype)
        for k in errs:
            e = np.abs(res[f"{k}_coarse"][sl].reshape(m, -1)
                       - ref[k].float().cpu().numpy().reshape(m, -1)).max()
            errs[k] = max(errs[k], float(e))
    log(f"phase 7: render_image vs plain version on rays [0, {m}) and "
        f"[{CHUNK - m}, {CHUNK}): " + ", ".join(f"{k} {e:.2e}"
                                                for k, e in errs.items()))
    if not all(e <= K2_TOL["bfloat16"] for e in errs.values()):
        fail(f"render_image disagrees: {errs}")

    # ---- --n_importance 64: the plain renderer over K9, K8 twice a chunk
    steps = SHORT_STEPS
    out, launches, hier_s = run(aoi, steps, "smoke_nerf_hier",
                                ["--n_importance", str(N_IMPORTANCE)])
    if out["system"].fused_mode != "points" or out["state"].step != steps:
        fail("--n_importance did not run in points mode")
    # a step, once a model: K9 forward (10 dense, the per-point heads) and
    # backward (the heads' backward, 9 dgrad, 10 wgrad); a served chunk: K8
    # once a model
    served, rest = divmod(launches["nerf_heads_composite"], 2)
    if rest or served < 1:
        fail(f"nerf_heads_composite launched "
             f"{launches['nerf_heads_composite']} times for two models")
    hold("--n_importance", launches,
         {"nerf_field_heads": 2 * steps, "nerf_field_heads_bwd": 2 * steps,
          "nerf_dense": 20 * steps + 20 * served,
          "nerf_dense_dgrad": 18 * steps, "nerf_dense_wgrad": 20 * steps,
          "nerf_composite_loss_bwd": 0})
    results["launches_nerf_hier"] = launches
    rows = _train_rows(logs, out["cfg"].exp_name)
    if not (rows and np.isfinite(rows[-1]["train/loss"])
            and all(np.isfinite(v) for v in out["metrics"].values())):
        fail("--n_importance logged no finite loss or validation")
    log(f"phase 7: --n_importance {N_IMPORTANCE}, {steps} steps in {hier_s:.1f} "
        f"s with validation: loss (coarse + fine) {rows[-1]['train/loss']:.4f}, "
        f"{1e3 * BATCH / rows[-1]['train/rays_per_sec']:.1f} ms a step, val/mae "
        f"{out['metrics']['val/mae']:.3f}, launches "
        f"{ {k: launches[k] for k in NERF_KERNELS} }")

    # ---- --ds_lambda 1000: color and depth renders over K9
    out, launches, ds_s = run(aoi_kp, steps, "smoke_nerf_ds",
                              ["--ds_lambda", "1000", "--ds_drop", "0.75",
                               "--sc_lambda", "0.1"])
    act = min(steps, out["system"].ds_drop_step - 1)
    if not 0 < act < steps:
        fail(f"the depth term must drop inside the {steps} steps, not at {act}")
    served = launches["nerf_heads_composite"]
    hold("--ds_lambda", launches,
         {"nerf_field_heads": 2 * steps, "nerf_field_heads_bwd": steps + act,
          "nerf_dense": 20 * steps + 10 * served,
          "nerf_dense_dgrad": 9 * (steps + act),
          "nerf_dense_wgrad": 10 * (steps + act),
          "nerf_composite_loss_bwd": 0})
    rows = _train_rows(logs, out["cfg"].exp_name)
    if not (rows and all("train/loss_depth" in r
                         and np.isfinite(r["train/loss_depth"])
                         and np.isfinite(r["train/loss"]) for r in rows)):
        fail("--ds_lambda logged no finite loss or loss_depth")
    log(f"phase 7: --ds_lambda 1000 --sc_lambda 0.1 (which the variant "
        f"ignores), {steps} steps ({act} with the depth term) in {ds_s:.1f} s: "
        f"loss {rows[-1]['train/loss']:.4f}, loss_depth "
        f"{rows[-1]['train/loss_depth']:.3f}, launches "
        f"{ {k: launches[k] for k in NERF_KERNELS} }")

    # ---- past 256 samples a ray through K7: --n_samples 320 and 512, two
    # chunks of nerf_composite_loss_bwd's block; as many steps as the first
    # run: the variant's loss falls slowly
    for n_s in (NERF_LONG_SAMPLES, NERF_LONGER_SAMPLES):
        out, launches, long_s = run(aoi, NERF_STEPS, f"smoke_nerf_long{n_s}",
                                    ["--n_samples", str(n_s)])
        if (out["system"].fused_mode != "points"
                or out["state"].step != NERF_STEPS):
            fail(f"--n_samples {n_s} did not train through the kernels")
        hold(f"--n_samples {n_s}", launches,
             {"nerf_composite_loss_bwd": NERF_STEPS,
              "nerf_dense_dgrad": 9 * NERF_STEPS,
              "nerf_dense_wgrad": 10 * NERF_STEPS,
              "nerf_field_heads": 0, "nerf_field_heads_bwd": 0})
        rows = _train_rows(logs, out["cfg"].exp_name)
        if not (len(rows) >= 2
                and all(np.isfinite(r["train/loss"]) for r in rows)
                and rows[-1]["train/loss"] < rows[0]["train/loss"]):
            fail(f"--n_samples {n_s}: the loss is not finite and falling: "
                 f"{[r['train/loss'] for r in rows]}")
        log(f"phase 7: --n_samples {n_s}, {NERF_STEPS} steps in {long_s:.1f} s "
            f"with validation: loss {rows[0]['train/loss']:.4f} -> "
            f"{rows[-1]['train/loss']:.4f}, launches "
            f"{ {k: launches[k] for k in NERF_KERNELS} }")


WIDE_FEAT = 1024  # wider than the heads' kernels hold: --fused auto is "off"
FIXTURE = os.path.join(REPO, "tests", "data", "jax_satnerf_4x32")
FIXTURE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _device_ms(fn, reps: int = 3, name: str = "") -> float:
    """The device time of fn's kernels a call, by torch.profiler (kernels,
    copies and fills on the card; user annotations left out); with `name`,
    of the kernels whose name holds it alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from satnerf_tpu_torch.utils import device_time as DT

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return DT.device_ms(prof, name) / reps


def _kernel_device_ms(fn, name: str, reps: int = 20, tries: int = 3) -> float:
    """_device_ms of the kernels named `name`; a profile that recorded none
    of them (the tracer drops a launch now and then) is taken again, up to
    `tries` times. 0.0 when every try recorded none."""
    for _ in range(tries):
        ms = _device_ms(fn, reps=reps, name=name)
        if ms > 0:
            return ms
    return 0.0


def phase8(results: dict, card: str):
    """Q5, M5 and M2 on the card: fields wider than the kernels hold, a
    checkpoint the JAX package wrote, the capability tool's smoke run."""
    import importlib.util

    import torch

    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.data import load_dataset
    from satnerf_tpu_torch.train.checkpoints import load_checkpoint
    from satnerf_tpu_torch.train.system import NeRFSystem
    from satnerf_tpu_torch.utils import jax_prng

    def fail(msg):
        raise SystemExit(f"phase 8 failed: {msg}")

    # ---- Q5: one cli.train step of each variant at 8 x 1024 resolves to the
    # plain path at construction, says why, and launches no kernel; an
    # explicit --fused rays at that width is refused at construction
    aoi = os.path.join(WORK, "aoi")  # phase 3's
    if not os.path.isdir(os.path.join(aoi, "data")):  # run alone (--only 8)
        from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi

        make_synthetic_aoi(aoi, size=128)
    logs, ckpts = os.path.join(WORK, "logs"), os.path.join(WORK, "ckpts")
    for model in ("sat-nerf", "nerf"):
        _reset_launches()
        t0 = time.perf_counter()
        out = _train_one([
            "--root_dir", os.path.join(aoi, "data"),
            "--gt_dir", os.path.join(aoi, "gt"), "--model", model,
            "--exp_name", f"wide_{model}", "--fc_units", str(WIDE_FEAT),
            "--fc_layers", str(LAYERS), "--n_samples", str(SAMPLES),
            "--batch_size", str(BATCH), "--max_train_steps", "1",
            "--log_every_n_steps", "1", "--num_sanity_val_steps", "0",
            "--chunk", str(CHUNK), "--logs_dir", logs, "--ckpts_dir", ckpts])
        step_s = time.perf_counter() - t0
        system, state, cfg = out["system"], out["state"], out["cfg"]
        launched = {k: v for k, v in _field_launches(_counts()).items() if v}
        rows = _train_rows(logs, cfg.exp_name)
        log(f"phase 8: {model} {LAYERS} x {WIDE_FEAT} --fused auto resolved to "
            f"{system.fused_mode!r} ({system.fused_reason}); one step and the "
            f"validation in {step_s:.1f} s, loss {rows[-1]['train/loss']:.4f}")
        if (system.fused_mode != "off" or system.fused_reason is None
                or str(WIDE_FEAT) not in system.fused_reason):
            fail(f"{model} at F {WIDE_FEAT}: resolved to {system.fused_mode} "
                 f"({system.fused_reason}), not off with the width named")
        if launched or not np.isfinite(rows[-1]["train/loss"]):
            fail(f"{model} at F {WIDE_FEAT}: kernels launched {launched} or "
                 f"loss not finite")
        try:
            NeRFSystem(Config(model=model, fc_units=WIDE_FEAT,
                              fc_layers=LAYERS, fused="rays"), device="cuda")
            fail(f"{model}: --fused rays at F {WIDE_FEAT} was not refused")
        except ValueError as e:
            log(f"phase 8: --fused rays refused at construction: {e}")
        # the plain path's step at this width: device time and event time
        ds = load_dataset(cfg, split="train")[0]
        data = {"rays": torch.from_numpy(np.ascontiguousarray(
                    ds.all_rays, np.float32)).cuda(),
                "rgbs": torch.from_numpy(np.ascontiguousarray(
                    ds.all_rgbs, np.float32)).cuda(),
                "ts": torch.from_numpy(np.asarray(
                    getattr(ds, "all_ids", np.zeros(len(ds))),
                    np.int64)).cuda()}
        key = jax_prng.prng_key(cfg.seed + 1)  # the run's key, as fit's
        step = lambda: system.train_step(state, data, key)  # noqa: E731
        dev_ms, ev_ms = _device_ms(step), _cuda_ms(step, reps=5)
        results.setdefault("wide", {})[model] = (dev_ms, ev_ms)
        log(f"phase 8: {model} {LAYERS} x {WIDE_FEAT} plain-path step, batch "
            f"{BATCH} x {SAMPLES} samples, bf16: {dev_ms:.2f} device-ms, "
            f"{ev_ms:.2f} event-ms a step on {card}")

    # ---- M5: the JAX package's checkpoint, rendered through the kernels in
    # fp32 and bf16, against the JAX render stored beside it
    stored = np.load(FIXTURE + "_render.npz")
    for precision, tol in FIXTURE_TOL.items():
        system = NeRFSystem(Config(model="sat-nerf", fc_layers=4, fc_units=32,
                                   n_samples=32, chunk=1024,
                                   precision=precision), device="cuda")
        params = system.init_params()
        if load_checkpoint(FIXTURE + ".ckpt", params) != int(stored["step"]):
            fail("the JAX checkpoint's step did not come back")
        _reset_launches()
        res = system.render_image(params, stored["rays"], stored["ts"])
        counts = _counts()
        w = res["weights_coarse"][..., None]
        got = {"rgb": res["rgb_coarse"], "depth": res["depth_coarse"],
               **{k: (w * res[f"{k}_coarse"]).sum(1)
                  for k in ("sun", "albedo", "beta")}}
        errs = {k: float(np.abs(got[k] - stored[k]).max()) for k in got}
        log(f"phase 8: JAX checkpoint rendered in {precision} through "
            f"siren_dense ({counts['siren_dense']}) and heads_composite "
            f"({counts['heads_composite']}): max abs err {errs} (tol {tol})")
        if (system.fused_mode != "rays" or not counts["heads_composite"]
                or not counts["siren_dense"]):
            fail(f"the JAX checkpoint's {precision} render missed the kernels")
        if not all(np.isfinite(v) and v <= tol for v in errs.values()):
            fail(f"the JAX checkpoint renders otherwise in {precision}: {errs}")

    # ---- M2: the transient experiment's smoke preset through the
    # capability tool, its phases in this process
    spec = importlib.util.spec_from_file_location(
        "capability_tool",
        os.path.join(REPO, "tools", "run_capability_experiments_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    t0 = time.perf_counter()
    report = tool.main([os.path.join(WORK, "capability"), "--preset", "smoke",
                        "--experiments", "transient", "--in_process"])
    t = report["experiments"]["transient"]
    vals = [t[run]["val"][k] for run in ("snerf", "satnerf")
            for k in ("psnr", "ssim", "mae")]
    beta = t["satnerf"].get("beta", {})
    log(f"phase 8: capability smoke (transient) in "
        f"{time.perf_counter() - t0:.1f} s: val {vals}, beta {beta}, "
        f"steps/s {[t[r]['steps_per_sec'] for r in ('snerf', 'satnerf')]}")
    if not (all(np.isfinite(vals)) and beta.get("beta_in_mask", 0) > 0
            and beta.get("beta_off_mask", 0) > 0
            and np.isfinite(beta.get("ratio", np.nan))):
        fail(f"the capability smoke run is not finite: {vals}, {beta}")


# the CPU geometry anchor (tests/test_geometry_anchor_cpu.py:55-82, and the
# port's tests/test_torch_geometry_anchor_cpu.py), with its two gates
ANCHOR_AOI = ["--n_train", "10", "--n_test", "1", "--size", "128",
              "--view_spread", "0.25", "--terrain", "smooth", "--checker", "8",
              "--alt_bounds", "terrain"]
ANCHOR_TRAIN = ["--model", "sat-nerf", "--fc_units", "64", "--fc_layers", "8",
                "--n_samples", "32", "--chunk", "16384", "--lr", "1e-3",
                "--batch_size", "512", "--max_train_steps", "800",
                "--log_every_n_steps", "400", "--save_every_n_epochs", "999",
                "--val_every_n_epochs", "999", "--seed", "0"]
ANCHOR_MAE_M, ANCHOR_PSNR = 4.0, 12.5


def phase9(results: dict, card: str):
    """M3 on the card: the CPU geometry anchor's run through the kernels,
    held to the same gates."""
    import torch

    from satnerf_tpu_torch.data import load_dataset, synthetic
    from satnerf_tpu_torch.ops import fused_mlp as FM
    from satnerf_tpu_torch.utils import jax_prng

    t_phase = time.perf_counter()
    root = os.path.join(WORK, "anchor")
    shutil.rmtree(root, ignore_errors=True)
    synthetic.main([os.path.join(root, "aoi")] + ANCHOR_AOI)
    aoi = os.path.join(root, "aoi")
    _reset_launches()
    out = _train_one([
        "--root_dir", os.path.join(aoi, "data"),
        "--gt_dir", os.path.join(aoi, "gt"),
        "--cache_dir", os.path.join(aoi, "cache"),
        "--logs_dir", os.path.join(root, "logs"),
        "--ckpts_dir", os.path.join(root, "ckpts"),
        "--exp_name", "anchor"] + ANCHOR_TRAIN)
    counts = _counts()
    loops = {k[1]: v for k, v in FM.MAINLOOP_LAUNCHES.items()
             if k[0] == "siren_dense"}
    system, state, cfg, m = out["system"], out["state"], out["cfg"], \
        out["metrics"]
    # the step's device time, on the run's own dataset and state
    ds = load_dataset(cfg, split="train")[0]
    data = {"rays": torch.from_numpy(np.ascontiguousarray(
                ds.all_rays, np.float32)).cuda(),
            "rgbs": torch.from_numpy(np.ascontiguousarray(
                ds.all_rgbs, np.float32)).cuda(),
            "ts": torch.from_numpy(np.asarray(ds.all_ids, np.int64)).cuda()}
    key = jax_prng.prng_key(cfg.seed + 1)  # the run's key, as fit's
    dev_ms = _device_ms(lambda: system.train_step(state, data, key))
    secs = time.perf_counter() - t_phase
    results["anchor"] = {"metrics": m, "device_ms": dev_ms, "seconds": secs,
                         "siren_dense_mainloops": loops}
    log(f"phase 9: geometry anchor (sat-nerf 8 x 64, 32 samples, batch 512 "
        f"x 800 steps, --fused {system.fused_mode}): val/mae "
        f"{m.get('val/mae', float('nan')):.3f} m (gate < {ANCHOR_MAE_M}), "
        f"val/psnr {m.get('val/psnr', float('nan')):.2f} (gate > "
        f"{ANCHOR_PSNR}); {dev_ms:.3f} device-ms a step; launches "
        f"composite_loss_bwd {counts['composite_loss_bwd']}, heads_composite "
        f"{counts['heads_composite']}; siren_dense by mainloop {loops} (K = 64, "
        f"N = 64 on wgmma: the trunk and feats, 8 a forward; N = 32 on wmma); "
        f"phase {secs:.1f} s on {card}")
    if system.fused_mode != "rays" or counts["composite_loss_bwd"] != 800 \
            or not counts["heads_composite"]:
        raise SystemExit(f"phase 9 failed: the anchor run missed the kernels "
                         f"({system.fused_mode}, {counts})")
    # the field's K = 64 layers on wgmma (Q6 repaired): 8 a training step
    if loops.get("wgmma", 0) < 8 * 800:
        raise SystemExit(f"phase 9 failed: siren_dense at K = 64 did not run "
                         f"on wgmma: {loops}")
    if not (m.get("val/mae", np.inf) < ANCHOR_MAE_M
            and m.get("val/psnr", -np.inf) > ANCHOR_PSNR):
        raise SystemExit(f"phase 9 failed: geometry anchor {m} (gates: mae < "
                         f"{ANCHOR_MAE_M} m, psnr > {ANCHOR_PSNR})")


# phase 10: the main path's training across devices (M7), at full width
DIST_STEPS = 5


def _dist_argv(aoi: str, root: str, name: str) -> list:
    return ["--root_dir", os.path.join(aoi, "data"),
            "--gt_dir", os.path.join(aoi, "gt"), "--model", "sat-nerf",
            "--exp_name", name, "--fc_layers", str(LAYERS),
            "--fc_units", str(FEAT), "--n_samples", str(SAMPLES),
            "--batch_size", str(BATCH), "--chunk", str(CHUNK),
            "--fused", "rays", "--precision", "bfloat16",
            "--max_train_steps", str(DIST_STEPS), "--log_every_n_steps", "1",
            "--num_sanity_val_steps", "0", "--noise_std", "1.0",
            "--logs_dir", os.path.join(root, "logs"),
            "--ckpts_dir", os.path.join(root, "ckpts")]


def _dist_rank(out_dir: str, argv: list) -> None:
    """A rank of phase 10's group (started by parallel.spawn): cli.train,
    then its parameters and the rows it rendered in validation into
    out_dir."""
    import torch

    from satnerf_tpu_torch.parallel import distributed as D
    from satnerf_tpu_torch.train.system import NeRFSystem

    rows, chunk = [], NeRFSystem.render_chunk
    NeRFSystem.render_chunk = lambda self, p, r, t: (
        rows.append(r.shape[0]), chunk(self, p, r, t))[1]
    try:
        out = _train_one(argv)
    finally:
        NeRFSystem.render_chunk = chunk
    r = int(os.environ["SATNERF_PROC_ID"])
    torch.save({"params": {k: v.cpu() for k, v in
                           out["state"].params.state_dict().items()},
                "rows": rows, "metrics": out["metrics"]},
               os.path.join(out_dir, f"rank{r}.pt"))
    assert not D.is_distributed()


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def phase10(results: dict, card: str):
    """M7 on the card: cli.train at sat-nerf 8 x 512, 64 samples, batch
    1,024, bf16, --fused rays through the distributed step on NCCL: a world
    of one via SATNERF_COORDINATOR beside the same run without a group, and
    two ranks where the machine has two cards."""
    import socket

    import torch

    from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi
    from satnerf_tpu_torch.parallel import distributed as D

    def fail(msg):
        raise SystemExit(f"phase 10 failed: {msg}")

    def port():
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return sock.getsockname()[1]

    aoi = os.path.join(WORK, "aoi")  # phase 3's
    if not os.path.isdir(os.path.join(aoi, "data")):
        make_synthetic_aoi(aoi, size=128)
    root = os.path.join(WORK, "dist")
    shutil.rmtree(root, ignore_errors=True)

    # the collective of a world of one leaves every gradient and metric as
    # it was, to the bit: held at every step
    reduce_mean, changed, reduced = D.all_reduce_mean, [], []

    def checked_reduce(tensors):
        tensors = list(tensors)
        before = [t.clone() for t in tensors]
        reduce_mean(tensors)
        reduced.append(len(tensors))
        if D.world() == 1:
            changed.extend(i for i, (a, b) in enumerate(zip(before, tensors))
                           if not torch.equal(a, b))

    # the kernels' runs (--fused rays) and runs on the path without fp32
    # atomics (--fused off: plain PyTorch on the card, its deterministic
    # algorithms), each without a group and as a world of one
    runs = {}
    for name in ("plain", "group", "plain_off", "plain_off_2", "group_off"):
        off = "_off" in name
        env = ({"SATNERF_COORDINATOR": f"localhost:{port()}",
                "SATNERF_NUM_PROCS": "1", "SATNERF_PROC_ID": "0"}
               if name.startswith("group") else {})
        argv = _dist_argv(aoi, root, name)
        if off:
            argv[argv.index("--fused") + 1] = "off"
        os.environ.update(env)
        D.all_reduce_mean = checked_reduce
        torch.use_deterministic_algorithms(off, warn_only=True)
        _reset_launches()
        t0 = time.perf_counter()
        try:
            out = _train_one(argv)
        finally:
            torch.use_deterministic_algorithms(False)
            D.all_reduce_mean = reduce_mean
            for k in env:
                os.environ.pop(k)
        torch.cuda.synchronize()
        counts = _counts()
        system = out["system"]
        runs[name] = {k: v.detach().clone() for k, v in
                      out["state"].params.state_dict().items()}
        log(f"phase 10: {name}: world {system.world} on {system.device}, "
            f"--fused {system.fused_mode}, {DIST_STEPS} steps and "
            f"validation in {time.perf_counter() - t0:.1f} s; all-reduces "
            f"{len(reduced)}; launches composite_loss_bwd "
            f"{counts['composite_loss_bwd']}, heads_composite "
            f"{counts['heads_composite']}, siren_dense "
            f"{counts['siren_dense']}; val {out['metrics']}")
        if system.compute_dtype != torch.bfloat16 or (
                system.fused_mode != "off" if off else
                system.fused_mode != "rays"
                or counts["composite_loss_bwd"] != DIST_STEPS
                or not counts["heads_composite"]):
            fail(f"{name} missed its path: {system.fused_mode}, {counts}")
        if len(reduced) != (2 * DIST_STEPS if name.startswith("group") else 0):
            fail(f"{name}: {len(reduced)} all-reduces in {DIST_STEPS} steps")
        if changed:
            fail(f"the world of one's all-reduce changed tensors {changed}")
        reduced.clear()
        if not all(np.isfinite(v) for v in out["metrics"].values()):
            fail(f"{name}: validation not finite: {out['metrics']}")
    # the kernels' runs differ by their fp32 atomics alone (their sums land
    # in another order each run; the all-reduce above left every tensor as
    # it was): reported. Without atomics a run repeats itself to the bit,
    # and the world of one is the run without a group, to the bit
    atomics = _max_diff(runs["group"], runs["plain"])
    repeat = _max_diff(runs["plain_off_2"], runs["plain_off"])
    diff = _max_diff(runs["group_off"], runs["plain_off"])
    results["dist"] = {"world_of_one_vs_plain": diff,
                       "kernels_world_of_one_vs_plain": atomics}
    log(f"phase 10: parameters after {DIST_STEPS} steps: without atomics "
        f"the world of one vs the run without a group max |diff| {diff}, "
        f"two runs without a group {repeat}; through the kernels (fp32 "
        f"atomics) {atomics:.3e}")
    if repeat != 0:
        fail(f"two runs without atomics differ by {repeat}")
    if diff != 0:
        fail(f"the world of one's parameters differ by {diff} from the run "
             f"without a group")

    if torch.cuda.device_count() >= 2:
        out_dir = os.path.join(root, "ranks")
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        D.spawn(_dist_rank, (out_dir, _dist_argv(aoi, root, "two")), 2)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=True) for r in range(2)]
        diff = _max_diff(ranks[0]["params"], ranks[1]["params"])
        rows = [rk["rows"] for rk in ranks]
        log(f"phase 10: world 2 (NCCL, {torch.cuda.device_count()} cards): "
            f"{DIST_STEPS} steps in {time.perf_counter() - t0:.1f} s; ranks' "
            f"parameters max |diff| {diff}; validation rendered "
            f"{sum(rows[0])} and {sum(rows[1])} rows in {len(rows[0])} and "
            f"{len(rows[1])} chunks on ranks 0 and 1")
        if diff != 0:
            fail(f"the two ranks' parameters differ by {diff}")
        if not rows[1] or rows[0] != rows[1]:
            fail(f"validation did not split over both ranks: {rows}")
        _hold_validation(ranks[0]["metrics"], root, fail)
    else:
        log("phase 10: one card: world 2 not run")


def _hold_validation(logged: dict, root: str, fail) -> None:
    """The two-rank run's logged validation against one card's validation
    of the checkpoint it saved: val/psnr equal."""
    from satnerf_tpu_torch.data import load_dataset
    from satnerf_tpu_torch.eval.loader import load_nerf, load_run_config
    from satnerf_tpu_torch.train.logging import RunLogger
    from satnerf_tpu_torch.train.loop import validate

    logs = os.path.join(root, "logs")
    run_id = next(d for d in os.listdir(logs) if d.endswith("_two"))
    ckpt = glob.glob(os.path.join(root, "ckpts", run_id, "epoch=*.ckpt"))[0]
    epoch = int(ckpt.rsplit("=", 1)[1].split(".")[0])
    cfg = load_run_config(logs, run_id)
    cfg.logs_dir = os.path.join(root, "one_card")
    system, params = load_nerf(run_id, logs, os.path.join(root, "ckpts"),
                               epoch, device="cuda")
    logger = RunLogger(cfg.logs_dir, run_id)
    one = validate(system, params, load_dataset(cfg, split="val")[0], cfg,
                   logger, DIST_STEPS, epoch)
    logger.close()
    log(f"phase 10: world 2 logged {logged}; one card's validation of its "
        f"checkpoint {one}")
    if logged.get("val/psnr") != one.get("val/psnr"):
        fail(f"the two ranks' val/psnr {logged.get('val/psnr')} is not one "
             f"card's {one.get('val/psnr')}")


def phase11(results: dict, card: str):
    """M8 on the card: tools/parity_report_torch.py on the committed JAX
    checkpoint, on the card and on the CPU."""
    import importlib.util

    from satnerf_tpu_torch.data import synthetic

    spec = importlib.util.spec_from_file_location(
        "parity_report_torch",
        os.path.join(REPO, "tools", "parity_report_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    root = os.path.join(WORK, "parity")
    shutil.rmtree(root, ignore_errors=True)
    aoi = os.path.join(root, "aoi")
    synthetic.main([aoi, "--size", "16", "--n_train", "3", "--n_test", "2"])
    ckpt = os.path.join(root, "in", "epoch=3.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    shutil.copyfile(FIXTURE + ".ckpt", ckpt)
    got = {}
    for device in ("cuda", "cpu"):
        _reset_launches()
        report = tool.main([
            "--ckpt", ckpt, "--root_dir", os.path.join(aoi, "data"),
            "--gt_dir", os.path.join(aoi, "gt"),
            "--output_dir", os.path.join(root, device), "--device", device,
            "--model", "sat-nerf", "--fc_layers", "4", "--fc_units", "32",
            "--n_samples", "32", "--chunk", "1024"])
        got[device] = report["ours"]
        counts = _counts()
        log(f"phase 11: parity tool on {device}: {report['ours']}; "
            f"heads_composite {counts['heads_composite']}, siren_dense "
            f"{counts['siren_dense']}")
        if device == "cuda" and not (counts["heads_composite"]
                                     and counts["siren_dense"]):
            raise SystemExit(f"phase 11 failed: the card's eval missed the "
                             f"kernels: {counts}")
    diffs = {k: abs(got["cuda"][k] - got["cpu"][k]) for k in got["cuda"]}
    results["parity"] = {"cuda": got["cuda"], "cpu": got["cpu"]}
    log(f"phase 11: card vs CPU |diff| {diffs} (within 2e-2) on {card}")
    if not all(np.isfinite(v) for d in got.values() for v in d.values()) \
            or max(diffs.values()) > 2e-2:
        raise SystemExit(f"phase 11 failed: card {got['cuda']}, CPU "
                         f"{got['cpu']}")


def phase12(results: dict, card: str):
    """The draw kernel against its plain version (utils/jax_prng.py in
    numpy) to the bit, each mode at the main path's shapes, at 65,536 x 64
    and at an odd count; its times; then two main-path steps on the card,
    whose draws (the batch's indices, its depths' jitter and the depths)
    must equal the plain draws from the same keys."""
    import torch

    from satnerf_tpu_torch.config import Config
    from satnerf_tpu_torch.ops import jax_draws as JD
    from satnerf_tpu_torch.render.sampling import stratified_zvals
    from satnerf_tpu_torch.train import system as system_mod
    from satnerf_tpu_torch.train.system import NeRFSystem
    from satnerf_tpu_torch.utils import jax_prng as P

    def fail(msg):
        raise SystemExit(f"phase 12 failed: {msg}")

    dev = torch.device("cuda")
    key = P.prng_key(12)
    n_data = 40_961  # randint's span: not a power of two
    modes = {
        "bits": (lambda shape, d: JD.bits(key, shape, d), np.int32),
        "uniform": (lambda shape, d: JD.uniform(key, shape, d), np.float32),
        "randint": (lambda shape, d: JD.randint(key, shape, 0, n_data, d),
                    np.int64),
        "normal": (lambda shape, d: JD.normal(key, shape, d), np.float32)}
    # the main path's: the batch's indices, its depths' jitter (and, with
    # sigma noise, a normal of the same shape); 65,536 x 64; an odd count
    shapes = {"bits": [(BATCH, SAMPLES)], "uniform": [(BATCH, SAMPLES)],
              "randint": [(BATCH,)], "normal": [(BATCH, SAMPLES)]}
    for mode in modes:
        shapes[mode] += [(CHUNK, SAMPLES), (1_000_003,)]
    timing, ulps = {}, {}
    for mode, (draw, dtype) in modes.items():
        for shape in shapes[mode]:
            got = draw(shape, dev).cpu().numpy()
            t0 = time.perf_counter()
            want = draw(shape, "cpu").numpy()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"{mode} {shape}: {got.dtype} {got.shape} against "
                     f"{want.dtype} {want.shape}")
            a, b = (x.view(np.int32) if x.dtype == np.float32 else x
                    for x in (got, want))
            diff = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
            ulps[(mode, shape)] = diff
            if diff:
                fail(f"{mode} at {shape}: {int((a != b).sum())} of {a.size} "
                     f"draws differ from the plain version's, by up to "
                     f"{diff} {'ulp' if dtype == np.float32 else ''}")
            ms = _cuda_ms(lambda: draw(shape, dev), reps=20)
            n = int(np.prod(shape))
            nbytes = n * np.dtype(dtype).itemsize
            ops = n * (DRAW_WORDS[mode] * THREEFRY_OPS + DRAW_EXTRA[mode])
            t_bytes = nbytes / PEAK_BYTES
            t_ops = ops / PEAK_ISSUE
            torch_call = {"bits": lambda: torch.randint(
                              0, 2 ** 31, shape, device=dev,
                              dtype=torch.int32),
                          "uniform": lambda: torch.rand(shape, device=dev),
                          "randint": lambda: torch.randint(0, n_data, shape,
                                                           device=dev),
                          "normal": lambda: torch.randn(shape, device=dev)}
            device_ms = _kernel_device_ms(lambda: draw(shape, dev),
                                          "jax_draws_kernel")
            timing[(mode, shape)] = {
                "ms": ms, "device_ms": device_ms,
                "plain_ms": plain_ms,
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "torch_rand_ms": _cuda_ms(torch_call[mode], reps=20)}
            log(f"phase 12: {mode} {shape}: bit for bit; {ms:.4f} ms (device "
                f"{timing[(mode, shape)]['device_ms']:.4f}), plain "
                f"(numpy, host) {plain_ms:.1f} ms, bound "
                f"{timing[(mode, shape)]['bound_ms']:.4f} ms "
                f"({timing[(mode, shape)]['bound_by']}), torch's own draw of "
                f"the shape {timing[(mode, shape)]['torch_rand_ms']:.4f} ms")
            if not device_ms > 0:
                fail(f"{mode} at {shape}: the profiler recorded no "
                     f"jax_draws_kernel in three tries")
            if device_ms < timing[(mode, shape)]["bound_ms"]:
                fail(f"{mode} at {shape}: {device_ms:.4f} device-ms, under "
                     f"its bound {timing[(mode, shape)]['bound_ms']:.4f}: "
                     f"the bound counts work the kernel does not do")
    perm = JD.permutation(key, 70_001, dev).cpu().numpy()
    if not np.array_equal(perm, JD.permutation(key, 70_001).numpy()):
        fail("the permutation of 70,001 (two sort rounds) differs from the "
             "plain version's")

    # ---- two main-path steps: every draw against the plain draw of its key
    cfg = Config(model="sat-nerf", fc_layers=LAYERS, fc_units=FEAT,
                 n_samples=SAMPLES, batch_size=BATCH, max_train_steps=10)
    system = NeRFSystem(cfg, dataset_len=4096)
    rng = np.random.RandomState(12)
    rays = rng.rand(4096, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0 + rng.rand(4096)
    data = {"rays": torch.from_numpy(rays).to(dev),
            "rgbs": torch.from_numpy(rng.rand(4096, 3).astype(np.float32)
                                     ).to(dev),
            "ts": torch.from_numpy(rng.randint(0, 5, 4096)).to(dev)}
    seen = []

    def spy(name, fn):
        def inner(*a, **kw):
            out = fn(*a, **kw)
            seen.append((name, a, kw, out))
            return out
        return inner

    real = {n: getattr(JD, n) for n in ("randint", "uniform")}
    real_z = system_mod.stratified_zvals
    try:
        for n, fn in real.items():
            setattr(JD, n, spy(n, fn))
        system_mod.stratified_zvals = spy("z", real_z)
        state = system.init_state(0)
        for _ in range(2):
            system.train_step(state, data, P.prng_key(7))
        torch.cuda.synchronize()
    finally:
        for n, fn in real.items():
            setattr(JD, n, fn)
        system_mod.stratified_zvals = real_z
    checked, z_err = {}, 0.0
    for name, a, kw, out in seen:
        if name == "randint":  # (key, shape, minval, maxval, device)
            want = real["randint"](*a[:4], "cpu")
        elif name == "uniform":  # (key, shape, device)
            want = real["uniform"](a[0], a[1], "cpu")
        else:  # (key, near, far, n_samples, perturb, use_disp)
            want = stratified_zvals(a[0], a[1].cpu(), a[2].cpu(), *a[3:])
        got = out.cpu()
        if name == "z":  # the bins' linspace and arithmetic: 1e-6 relative
            z_err = max(z_err, float((got - want).abs().max()))
            same = torch.allclose(got, want, rtol=1e-6, atol=0)
        else:  # the draws themselves: to the bit
            same = torch.equal(got, want)
        if not same:
            fail(f"a main-path step's {name} differs from the plain draw of "
                 f"its key")
        checked[name] = checked.get(name, 0) + 1
    if checked != {"randint": 2, "uniform": 2, "z": 2}:
        fail(f"two main-path steps drew {checked}, expected one batch's "
             f"indices, jitter and depths a step")
    main = timing[("uniform", (BATCH, SAMPLES))]
    results.setdefault("times", {})[DRAW_KERNEL] = {
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "by_mode": {f"{m} {'x'.join(map(str, sh))}": t
                    for (m, sh), t in timing.items()}}
    results.setdefault("err", {})[(DRAW_KERNEL, "float32")] = max(
        ulps.values())
    log(f"phase 12: two main-path steps' draws {checked}: indices and jitter "
        f"equal the plain draws of their keys to the bit, the depths within "
        f"{z_err:.2e} on {card}")


# phase 13: serving across the host's cards (M9), on phase 3's run
GROUP_CASES = {  # name -> overrides of phase 3's opts.json
    "sat-nerf": {},
    "hier": {"n_importance": N_IMPORTANCE},
    "nerf": {"model": "nerf", "fc_units": NERF_FEAT},
}
GROUP_KERNELS = {"sat-nerf": ("siren_dense", "siren_dense_k0", "heads_composite"),
                 "hier": ("siren_dense", "siren_dense_k0", "heads_composite"),
                 "nerf": ("nerf_dense", "nerf_heads_composite")}
GROUP_RUN = "smoke"


def _serving_run() -> tuple:
    """Phase 3's AOI, run directory and seeded 8 x 512 checkpoint (made
    again as phase 3 makes them when phase 3 did not run): (logs, ckpts)."""
    from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi
    from satnerf_tpu_torch.eval.loader import load_run_config
    from satnerf_tpu_torch.train.checkpoints import (checkpoint_path,
                                                     save_checkpoint)
    from satnerf_tpu_torch.train.system import NeRFSystem

    logs, ckpts = os.path.join(WORK, "logs"), os.path.join(WORK, "ckpts")
    if os.path.exists(checkpoint_path(ckpts, GROUP_RUN, 1)):
        return logs, ckpts
    aoi = os.path.join(WORK, "aoi")
    if not os.path.isdir(os.path.join(aoi, "data")):
        make_synthetic_aoi(aoi, size=128)
    os.makedirs(os.path.join(logs, GROUP_RUN), exist_ok=True)
    opts = {"model": "sat-nerf", "fc_layers": LAYERS, "fc_units": FEAT,
            "n_samples": SAMPLES, "chunk": CHUNK, "exp_name": GROUP_RUN,
            "root_dir": os.path.join(aoi, "data"),
            "gt_dir": os.path.join(aoi, "gt"), "logs_dir": logs,
            "ckpts_dir": ckpts}
    with open(os.path.join(logs, GROUP_RUN, "opts.json"), "w") as f:
        json.dump(opts, f)
    system = NeRFSystem(load_run_config(logs, GROUP_RUN), device="cuda")
    save_checkpoint(checkpoint_path(ckpts, GROUP_RUN, 1), system.init_params(0))
    return logs, ckpts


def _run_on(n_devices: int) -> str:
    """A copy of phase 3's run directory whose opts.json asks for
    n_devices cards (its checkpoints stay phase 3's): the logs dir."""
    logs, _ = _serving_run()
    dst = os.path.join(WORK, f"group_logs{n_devices}")
    os.makedirs(os.path.join(dst, GROUP_RUN), exist_ok=True)
    with open(os.path.join(logs, GROUP_RUN, "opts.json")) as f:
        opts = json.load(f)
    with open(os.path.join(dst, GROUP_RUN, "opts.json"), "w") as f:
        json.dump({**opts, "n_devices": n_devices}, f)
    return dst


def _group_system(case: str):
    """(system, params, rays, ts) of a phase 13 case on this rank's card:
    phase 3's checkpoint for sat-nerf, the seed-0 draw of the others, and
    phase 3's 262,144-ray view."""
    from satnerf_tpu_torch.eval.loader import load_nerf, load_run_config
    from satnerf_tpu_torch.train.system import NeRFSystem

    logs, ckpts = _serving_run()
    if case == "sat-nerf":
        system, params = load_nerf(GROUP_RUN, logs, ckpts, 1, device="cuda")
    else:
        import dataclasses

        cfg = dataclasses.replace(load_run_config(logs, GROUP_RUN),
                                  **GROUP_CASES[case])
        from satnerf_tpu_torch.parallel import distributed as D

        system = NeRFSystem(cfg, device=D.rank_device("cuda"))
        params = system.init_params(0)
    rng = np.random.RandomState(0)  # phase 3's view
    n = 1 << 18
    rays = rng.rand(n, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    ts = rng.randint(0, 30, n).astype(np.int32)
    return system, params, rays, (None if system.is_nerf else ts)


def _render_ms(system, params, rays, ts) -> tuple:
    """(products, host seconds, device-ms of the render's kernels, of its
    NCCL kernels) of one render_image, warmed up on a chunk; the device
    times from a second render under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    system.render_image(params, rays[:CHUNK], None if ts is None else ts[:CHUNK])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = system.render_image(params, rays, ts)
    dt = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        system.render_image(params, rays, ts)
        torch.cuda.synchronize()
    ms = {"compute": 0.0, "nccl": 0.0}
    for e in prof.key_averages():
        if getattr(e, "device_time_total", 0) > 0 \
                and str(getattr(e, "device_type", "")).endswith("CUDA") \
                and not getattr(e, "is_user_annotation", False):
            ms["nccl" if "nccl" in e.key.lower() else "compute"] += \
                e.device_time_total / 1e3
    return res, dt, ms["compute"], ms["nccl"]


def _digest(res: dict) -> dict:
    import hashlib

    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in res.items()}


def _group_rank(out_dir: str):
    """A rank of phase 13(b)'s group (started by parallel.spawn): each case's
    view through the collective render_image; its launches, times, the
    gathers' ms and its products' digests into out_dir. Rank 0 returns its
    products."""
    import torch

    from satnerf_tpu_torch.parallel import distributed as D

    D.maybe_init_distributed("cuda")
    r, got, products = D.rank(), {}, {}
    gather = D.all_gather_rows
    for case in GROUP_CASES:
        system, params, rays, ts = _group_system(case)
        D.barrier()
        torch.cuda.synchronize()
        _reset_launches()
        res, dt, dev_ms, nccl_ms = _render_ms(system, params, rays, ts)
        counts = {k: v for k, v in _counts().items() if v}
        gather_ms = []

        def timed(p):
            # the gather alone: every rank's block is ready first
            torch.cuda.synchronize()
            D.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gather(p)
            torch.cuda.synchronize()
            gather_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        D.all_gather_rows = timed
        try:
            system.render_image(params, rays, ts)
        finally:
            D.all_gather_rows = gather
        got[case] = {"s": dt, "device_ms": dev_ms, "nccl_ms": nccl_ms,
                     "gather_ms": sum(gather_ms), "gathers": len(gather_ms),
                     "launches": counts, "digest": _digest(res),
                     "render_world": D.render_world(),
                     "device": str(system.device)}
        if r == 0:
            products[case] = res
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(got, f)
    D.barrier()
    D.destroy()
    return products


def _row_count_stages(system, params, rays, ts, n_small: int) -> dict:
    """Where the hierarchical dispatch's products depend on how many rows a
    card renders: rows [0, n_small) of one chunk rendered within the whole
    chunk against rendered alone, stage by stage (the coarse kernels'
    weights, the resampled depths from the same weights, the fine kernels
    on the same depths). The number of entries that differ a stage."""
    import torch

    from satnerf_tpu_torch.ops.fused_mlp import fused_render_rays
    from satnerf_tpu_torch.render.render import resample_zvals
    from satnerf_tpu_torch.render.sampling import stratified_zvals
    from satnerf_tpu_torch.train.system import MAX_RENDER_POINTS

    rcfg, kw = system.eval_render_cfg, system._field_kw()
    with torch.inference_mode():
        r = torch.from_numpy(rays[:CHUNK]).to(system.device)
        t_e = system._embed_ts(params, torch.from_numpy(ts[:CHUNK]).to(
            system.device), CHUNK)
        sun = system._sun_dir(r)
        z = stratified_zvals(None, r[:, 6:7], r[:, 7:8], rcfg.n_samples,
                             rcfg.perturb, rcfg.use_disp)

        def render(field, zz, n, weights):
            return fused_render_rays(params[field], r[:n, 0:3], r[:n, 3:6],
                                     sun[:n], t_e[:n], zz[:n],
                                     return_weights=weights, **kw)

        def differ(a, b):
            return int((a != b).sum())

        big = render("nerf_coarse", z, CHUNK, True)
        small = render("nerf_coarse", z, n_small, True)
        z_big = resample_zvals(None, z, big["weights"], rcfg.n_importance,
                               det=True)
        z_small = resample_zvals(None, z[:n_small], big["weights"][:n_small],
                                 rcfg.n_importance, det=True)
        # the fine pass as _fused_product_render runs it: in pieces of
        # MAX_RENDER_POINTS points
        piece = MAX_RENDER_POINTS // z_big.shape[1]
        fine_big = render("nerf_fine", z_big, min(piece, CHUNK), False)
        fine_small = render("nerf_fine", z_big, n_small, False)
        return {"coarse weights": differ(big["weights"][:n_small],
                                         small["weights"]),
                "resampled depths": differ(z_big[:n_small], z_small),
                "fine kernels": sum(differ(fine_big[k][:n_small],
                                           fine_small[k])
                                    for k in fine_small)}


def _bf16_step_err(got: dict, want: dict) -> dict:
    """Each product's largest difference over the card tests' one-bf16-step
    rule (2^-7 of the entry plus 1e-4): at most 1 where it holds."""
    return {k: float((np.abs(got[k] - want[k])
                      / (2.0 ** -7 * np.abs(want[k]) + 1e-4)).max())
            for k in want}


def phase13(results: dict, card: str):
    """M9 on the card: the collective render_image and the eval entry points
    as a world of one (NCCL) against no group; with two cards or more, the
    same views across every card against one card."""
    import torch

    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm
    from satnerf_tpu_torch.cli.eval import eval_aoi
    from satnerf_tpu_torch.parallel import distributed as D

    def fail(msg):
        raise SystemExit(f"phase 13 failed: {msg}")

    def port():
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return sock.getsockname()[1]

    def world_of_one(fn, *args, **kw):
        env = {"SATNERF_COORDINATOR": f"localhost:{port()}",
               "SATNERF_NUM_PROCS": "1", "SATNERF_PROC_ID": "0"}
        os.environ.update(env)
        try:
            return D.run_in_group(lambda: fn(*args, **kw), (), 1, "cuda")
        finally:
            for k in env:
                os.environ.pop(k)

    logs, ckpts = _serving_run()
    # (a) one card: each view without a group, then as a world of one
    one, launches = {}, {}
    _reset_launches()
    for case in GROUP_CASES:
        system, params, rays, ts = _group_system(case)
        res, dt, dev_ms, _ = _render_ms(system, params, rays, ts)
        one[case] = {"res": res, "s": dt, "device_ms": dev_ms}
    _reset_launches()
    for case in GROUP_CASES:
        system, params, rays, ts = _group_system(case)
        before = _counts()
        res = world_of_one(system.render_image, params, rays, ts)
        after = _counts()
        launched = {k: after[k] - before.get(k, 0) for k in GROUP_KERNELS[case]}
        differ = [k for k in res if not np.array_equal(res[k], one[case]["res"][k])]
        log(f"phase 13(a): {case}: {rays.shape[0]} rays as a world of one "
            f"(NCCL) vs no group: {len(res) - len(differ)} of {len(res)} "
            f"products bit-equal; launches {launched}; no group "
            f"{rays.shape[0] / one[case]['s']:.1f} rays/s, "
            f"{one[case]['device_ms']:.2f} device-ms on {card}")
        if differ or set(res) != set(one[case]["res"]):
            fail(f"{case}: the world of one differs from no group in {differ}")
        if not all(launched.values()):
            fail(f"{case}: a serving kernel was not launched: {launched}")
    results["launches_group"] = _counts()
    system, params, rays, ts = _group_system("hier")
    stages = _row_count_stages(system, params, rays, ts, CHUNK // 4)
    log(f"phase 13(a): hier: rows [0, {CHUNK // 4}) of a chunk within "
        f"{CHUNK} rows against alone, entries that differ: {stages}")
    logs1 = _run_on(1)
    kw = dict(checkpoints_dir=ckpts, device="cuda")
    plain = eval_aoi(GROUP_RUN, logs1, os.path.join(WORK, "group_eval0"), 1, **kw)
    grouped = world_of_one(eval_aoi, GROUP_RUN, logs1,
                           os.path.join(WORK, "group_eval1"), 1, **kw)
    log(f"phase 13(a): cli.eval without a group {plain}, as a world of one "
        f"{grouped}")
    if plain != grouped or not all(np.isfinite(v) for v in plain.values()):
        fail(f"cli.eval as a world of one wrote {grouped}, without a group "
             f"{plain}")

    w = min(torch.cuda.device_count(), 4)
    if w < 2:
        log("phase 13(b): one card: the views across cards not run")
        return
    # (b) the same views across w cards, each rank's block of every chunk
    out_dir = os.path.join(WORK, "group_ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    products = D.spawn(_group_rank, (out_dir,), w)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(w):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    rates = {}
    for case in GROUP_CASES:
        want, got = one[case]["res"], products[case]
        differ = [k for k in want if not np.array_equal(want[k], got[k])]
        steps = _bf16_step_err(got, want) if differ else {}
        digests = {json.dumps(g[case]["digest"], sort_keys=True) for g in ranks}
        n = got["rgb_coarse"].shape[0]
        per = [g[case] for g in ranks]
        rates[case] = {"rays_per_s_1": n / one[case]["s"],
                       "rays_per_s_w": n / max(p["s"] for p in per),
                       "device_ms_1": one[case]["device_ms"],
                       "device_ms_w": [p["device_ms"] for p in per],
                       "nccl_ms_w": [p["nccl_ms"] for p in per],
                       "gather_ms_w": [p["gather_ms"] for p in per]}
        log(f"phase 13(b): {case} across {w} cards: products "
            f"{'bit-equal to one card' if not differ else f'differ from one card in {differ}, within {max(steps.values()):.2f} bf16 steps'}; "
            f"ranks' products {'equal' if len(digests) == 1 else 'DIFFER'}; "
            f"rays/s 1 card {rates[case]['rays_per_s_1']:.1f}, {w} cards "
            f"{rates[case]['rays_per_s_w']:.1f}; device-ms 1 card "
            f"{one[case]['device_ms']:.2f}, a card of {w} "
            + ", ".join(f"{p['device_ms']:.2f}" for p in per)
            + " (NCCL " + ", ".join(f"{p['nccl_ms']:.2f}" for p in per)
            + "); gathers " + ", ".join(f"{p['gather_ms']:.2f}" for p in per)
            + f" ms in {per[0]['gathers']} chunks; launches "
            + "; ".join(f"{p['device']} {p['launches']}" for p in per)
            + f" on {card}")
        if differ and max(steps.values()) > 1:
            fail(f"{case}: {w} cards differ from one card past a bf16 step: "
                 f"{steps}")
        if len(digests) != 1:
            fail(f"{case}: the ranks hold different products")
        for p in per:
            missing = [k for k in GROUP_KERNELS[case] if not p["launches"].get(k)]
            if missing or p["render_world"] != w:
                fail(f"{case}: {p['device']} launched no {missing} "
                     f"(render world {p['render_world']})")
    results["group"] = rates

    # create_pretty_dsm where opts.json asks for w cards: its 16,384-ray view
    # stays on one card (eval/loader.py render_ranks), in this process
    from satnerf_tpu_torch.eval.loader import load_run_config, render_ranks

    dsm, mae, secs, spawned = {}, {}, {}, []
    spawn = D.spawn
    D.spawn = lambda *a: (spawned.append(a[-1]), spawn(*a))[1]
    try:
        for n_dev in (1, w):
            out = os.path.join(WORK, f"group_dsm{n_dev}")
            shutil.rmtree(out, ignore_errors=True)
            t0 = time.perf_counter()
            mae[n_dev] = create_pretty_dsm(GROUP_RUN, _run_on(n_dev), out, 1,
                                           **kw)
            secs[n_dev] = time.perf_counter() - t0
            dsm[n_dev] = _dsm_of(out)
    finally:
        D.spawn = spawn
    log(f"phase 13(b): create_pretty_dsm with opts.json's n_devices 1 and "
        f"{w}: {secs[1]:.2f} and {secs[w]:.2f} s, ranks started "
        f"{spawned or 'none'}")
    if spawned:
        fail(f"create_pretty_dsm started ranks {spawned} for one small view")
    # the same view across the w cards, each rank joining the group
    out = os.path.join(WORK, "group_dsm_ranks")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    mae["ranks"] = D.spawn(_dsm_rank, (_run_on(1), out), w)
    start_s = time.perf_counter() - t0
    dsm["ranks"] = _dsm_of(out)
    log(f"phase 13(b): create_pretty_dsm on {w} ranks (started, each loading "
        f"the run, rendering, leaving): MAE {mae['ranks']} in {start_s:.1f} "
        f"s; on one card {mae[1]} in {secs[1]:.2f} s")
    for n_dev in (w, "ranks"):
        if mae[1] != mae[n_dev] or not np.array_equal(dsm[1], dsm[n_dev],
                                                      equal_nan=True):
            fail(f"create_pretty_dsm {n_dev}: MAE {mae[n_dev]}, on one card "
                 f"{mae[1]}")
    log(f"phase 13(b): the {w} ranks' spawn and renders took {spawn_s:.1f} s")

    # a view large enough that render_ranks starts w ranks (1.5 times the
    # smallest), on one card and on the w ranks, each wall time whole
    cfg = load_run_config(_run_on(w), GROUP_RUN)
    views = next(k for k in range(1, 1 << 12)
                 if render_ranks(cfg, k << 18, "cuda") == w)
    views = -(-3 * views // 2)
    system, params, rays, ts = _group_system("sat-nerf")
    rays, ts = np.tile(rays, (views, 1)), np.tile(ts, views)
    system.render_image(params, rays[:CHUNK], ts[:CHUNK])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = system.render_image(params, rays, ts)
    one_s = time.perf_counter() - t0
    want = _digest(res)
    del res, rays, ts
    t0 = time.perf_counter()
    got, began, ended = D.spawn(_large_rank, (views,), w)
    ranks_s, start_l = ended - t0, began - t0
    n = views << 18
    results["group"]["large"] = {"rays": n, "one_card_s": one_s,
                                 "ranks_s": ranks_s, "ranks": w,
                                 "small_view_s": secs, "start_s": start_s}
    log(f"phase 13(b): sat-nerf, {n} rays (render_ranks: {w} ranks): one "
        f"card {one_s:.1f} s ({n / one_s:.1f} rays/s); {w} ranks started "
        f"for it {ranks_s:.1f} s ({n / ranks_s:.1f} rays/s): {start_l:.1f} s "
        f"to join, load the run and lay out the view, "
        f"{ranks_s - start_l:.1f} s rendering; products "
        f"{'bit-equal' if got == want else 'DIFFER'} on {card}")
    if got != want:
        fail(f"the {n}-ray view on {w} ranks differs from one card")


# phase 14: the kernels each bench row's path must launch (the ports of the
# TPU kernels that row's JAX path runs, PERF.md section 6); the draw kernel
# runs on every train row
_K1 = TRAIN_KERNELS + ("siren_dense_k0",)
_K2 = ("siren_dense", "siren_dense_k0", "heads_composite")
BENCH_ROW_KERNELS = {
    "train_default": _K1 + (DRAW_KERNEL,),
    "train_default_b1024": _K1 + (DRAW_KERNEL,),
    "train_sc": _K1 + ("sc_loss_bwd", DRAW_KERNEL),
    "train_nimp": _K1 + (DRAW_KERNEL,),
    "train_nerf": NERF_TRAIN_KERNELS + (DRAW_KERNEL,),
    "serve_rays": _K2, "serve_nimp": _K2, "image_surface": _K2,
    "serve_points": ("siren_dense", "field_heads"),
    "serve_nerf": ("nerf_dense", "nerf_heads_composite"),
}
# the bench's device-ms against tools/profile_render_torch.py's in the same
# phase: (bench row, the tool's arguments, the label of its profiled calls)
BENCH_VS_PROFILE = (("train_default_b1024", ["--train"], "10 train steps"),
                    ("image_surface", [], "render_image"))
BENCH_VS_PROFILE_TOL = 0.10


def _profile_device_ms(argv: list, what: str) -> float:
    """tools/profile_render_torch.py's device-ms a call of `what`."""
    import re

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "profile_render_torch.py"),
         *argv], cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"phase 14 failed: profile_render_torch.py {argv} "
                         f"exited {proc.returncode}: {proc.stderr[-2000:]}")
    m = re.search(rf"^{re.escape(what)}: ([0-9.]+) device-ms a call over",
                  proc.stdout, re.M)
    if m is None:
        raise SystemExit(f"phase 14 failed: no device-ms line for {what!r} in "
                         f"{proc.stdout[-2000:]}")
    return float(m.group(1))


def phase14(results: dict, card: str):
    """The bench's ten rows on the card, each line held, two device-ms
    readings against the profile tool's."""
    import gc
    import importlib.util

    import torch

    from satnerf_tpu_torch.utils.flops import flops_per_ray

    def fail(msg):
        raise SystemExit(f"phase 14 failed: {msg}")

    gc.collect()
    torch.cuda.empty_cache()  # the rows run in processes of their own
    spec = importlib.util.spec_from_file_location(
        "bench_matrix_torch", os.path.join(REPO, "tools", "bench_matrix_torch.py"))
    matrix = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(matrix)
    out = os.path.join(WORK, "BENCH_MATRIX_torch.json")
    os.makedirs(WORK, exist_ok=True)
    env = {**os.environ, "BENCH_STEPS": "5", "BENCH_DEVICE": "cuda"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "bench_matrix_torch.py"),
         "--out", out, "--timeout", "300"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=1200)
    log(f"phase 14: the matrix's ten rows in {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        fail(f"tools/bench_matrix_torch.py exited {proc.returncode}: "
             f"{proc.stdout[-3000:]}")
    with open(out) as f:
        rows = json.load(f)["rows"]
    if set(rows) != set(matrix.ROWS):
        fail(f"rows {sorted(rows)}, not {sorted(matrix.ROWS)}")
    totals = {}
    for name, row in rows.items():
        ov = matrix.ROWS[name]
        mode = ov.get("BENCH_MODE", "train")
        fpr = flops_per_ray(
            ov.get("BENCH_MODEL", "sat-nerf"), LAYERS, FEAT, SAMPLES,
            mode="train" if mode == "train" else "render",
            sc=mode == "train" and float(ov.get("BENCH_SC", 0)) > 0,
            n_importance=int(ov.get("BENCH_NIMP", 0))) / 1e6
        problems = [what for what, ok in (
            ("value > 0", row["value"] > 0),
            ("0 < mfu < 1", 0 < row["mfu"] < 1),
            ("device_ms > 0", (row["device_ms"] or 0) > 0),
            ("0 <= idle < 1", row["idle"] is not None and 0 <= row["idle"] < 1),
            ("vs_baseline null", row["vs_baseline"] is None),
            (f"flops_per_ray {fpr}", row["flops_per_ray"] == fpr),
            (f"metric {mode}_rays_per_sec_per_chip",
             row["metric"] == f"{mode}_rays_per_sec_per_chip"),
            (f"card {card}", row["card"] == card)) if not ok]
        missing = [k for k in BENCH_ROW_KERNELS[name]
                   if not row["launches"].get(k)]
        log(f"phase 14: {name}: {row['value']:.1f} rays/s, event_ms "
            f"{[round(x, 4) for x in row['event_ms']]}, device_ms "
            f"{row['device_ms']:.4f} (profiled run {row['profiled_ms']:.4f} "
            f"ms a call), idle {row['idle']:.4f}, mfu "
            f"{row['mfu']:.4f}, peak {row['peak_gib']:.2f} GiB, batch "
            f"{row['batch']}, steps {row['steps']}, fused {row['fused']}, "
            f"{row['flops_per_ray']:.2f} MFLOP a ray, launches "
            f"{row['launches']}, {row['wall_s']:.1f} s, on {row['card']}")
        if problems or missing:
            fail(f"{name}: {problems} do not hold, no launch of {missing}")
        for k, v in row["launches"].items():
            totals[k] = totals.get(k, 0) + v
    results["launches_bench"] = totals
    for name, argv, what in BENCH_VS_PROFILE:
        t0 = time.perf_counter()
        ref = _profile_device_ms(argv, what)
        got = rows[name]["device_ms"]
        rel = abs(got - ref) / ref
        log(f"phase 14: {name} {got:.4f} device-ms a call, "
            f"profile_render_torch.py {' '.join(argv) or '(render)'} {ref:.4f}: "
            f"{100 * rel:.2f} % apart ({time.perf_counter() - t0:.1f} s) on {card}")
        if rel > BENCH_VS_PROFILE_TOL:
            fail(f"{name}'s device-ms {got} is {100 * rel:.1f} % from the "
                 f"profile tool's {ref} (at most {100 * BENCH_VS_PROFILE_TOL} %)")


def _dsm_of(out: str):
    from satnerf_tpu_torch.eval import read_geotiff

    path = glob.glob(os.path.join(out, GROUP_RUN, "*_dsm_epoch1.tif"))[0]
    return read_geotiff(path).data[0]


def _dsm_rank(logs: str, out: str):
    """A rank of phase 13(b)'s group (started by parallel.spawn):
    create_pretty_dsm as the rank SATNERF_COORDINATOR names. Rank 0's MAE."""
    from satnerf_tpu_torch.cli.create_dsm import create_pretty_dsm

    _, ckpts = _serving_run()
    return create_pretty_dsm(GROUP_RUN, logs, out, 1, checkpoints_dir=ckpts,
                             device="cuda")


def _large_rank(views: int):
    """A rank of phase 13(b)'s group: phase 3's view tiled `views` times
    through the collective render_image. Rank 0's products' digests and
    its clock (rank 0 is the caller's process) where the render began and
    ended."""
    from satnerf_tpu_torch.parallel import distributed as D

    D.maybe_init_distributed("cuda")
    system, params, rays, ts = _group_system("sat-nerf")
    rays, ts = np.tile(rays, (views, 1)), np.tile(ts, views)
    began = time.perf_counter()
    res = system.render_image(params, rays, ts)
    ended = time.perf_counter()
    out = (_digest(res), began, ended) if D.is_main() else None
    D.barrier()
    D.destroy()
    return out


def _train_one(argv: list) -> dict:
    """cli.train on one card (--n_devices 1: its default of 0 trains on every
    visible card), or as the rank SATNERF_COORDINATOR names."""
    from satnerf_tpu_torch.cli import train as cli_train

    return cli_train.main(list(argv) + ["--n_devices", "1"])


def _loaded_foreign() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                         "satnerf_tpu", "msgpack",
                                         "matplotlib"))


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after 0 and 1 (e.g. "
                         "2e,7) while working on one; prints no result lines")
    only = [k for k in ap.parse_args().only.split(",") if k]
    name, card = phase0()
    secs = phase1()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {"err": {}, "k2": {}, "k1": {}, "k34": {}, "k56": {}, "k789": {}}
    steps = (("2", lambda: phase2(results)), ("2b", lambda: phase2b(results)),
             ("2c", lambda: phase2c(results)), ("2d", lambda: phase2d(results)),
             ("2e", lambda: phase2e(results)),
             ("3", lambda: phase3(results, card)),
             ("4", lambda: phase4(results, card)),
             ("5", lambda: phase5(results, card)),
             ("6", lambda: phase6(results, card)),
             ("7", lambda: phase7(results, card)),
             ("8", lambda: phase8(results, card)),
             ("9", lambda: phase9(results, card)),
             ("10", lambda: phase10(results, card)),
             ("11", lambda: phase11(results, card)),
             ("12", lambda: phase12(results, card)),
             ("13", lambda: phase13(results, card)),
             ("14", lambda: phase14(results, card)))
    t_start = time.perf_counter()
    for key, run in steps:
        if only and key not in only:
            continue
        t0 = time.perf_counter()
        run()
        log(f"phase {key} took {time.perf_counter() - t0:.1f} s")
    if _loaded_foreign():
        raise SystemExit(f"the port loaded {_loaded_foreign()}")
    if only:
        log(f"ran phases {only} only: no result lines")
        return
    # launches: on the main path of the slice that brought the kernel, each
    # driven from counts of 0: cli.train's run of phase 4, and for the full
    # recipe's two kernels cli.train's run of phase 5, for the per-sample
    # field's two the hierarchical run of phase 6, for the nerf variant's the
    # --model nerf run of phase 7 (its per-point two: the --n_importance run);
    # the other paths' counts stand beside it
    kernels = []
    for kname, (source, replaces, *also) in KERNELS.items():
        t = results["times"][kname]
        vs_old = {"siren_dense_k0": "v1", "narrow_grads": "walk"}.get(kname)
        main_path = ("launches_full" if kname in AUX_KERNELS else
                     "launches_hier" if kname in FIELD_KERNELS else
                     "launches_nerf_hier" if kname in NERF_FIELD_KERNELS else
                     "launches_nerf" if kname in NERF_KERNELS else "launches")
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": TPU_KERNEL[replaces],
            **({"replaces_also": [TPU_KERNEL[k] for k in also]} if also else {}),
            "launches": results[main_path][kname],
            "launches_serving": results["launches_serving"].get(kname, 0),
            "launches_training": results["launches"][kname],
            "launches_full_recipe": results["launches_full"][kname],
            "launches_hier": results["launches_hier"][kname],
            "launches_fused_on": results["launches_fused_on"][kname],
            "launches_nerf": results["launches_nerf"][kname],
            "launches_nerf_hier": results["launches_nerf_hier"][kname],
            "launches_render_group": results["launches_group"].get(kname, 0),
            "launches_bench": results["launches_bench"].get(kname, 0),
            "max_abs_err": max(results["err"][(kname, "float32")],
                               results["err"][(kname, "bfloat16")]),
            **({"launches_by_mainloop": results["mainloop_launches"][kname],
                "max_abs_err_vs_wmma": results["err"][(f"{kname}_vs_wmma",
                                                       "bfloat16")]}
               if kname in results["mainloop_launches"] else {}),
            **({"launches_by_body": results["body_launches"][kname],
                "max_abs_err_vs_warp": max(results["err"][(f"{kname}_vs_warp", dn)]
                                           for dn in ("float32", "bfloat16"))}
               if kname in results["body_launches"] else {}),
            # the two redesigned beside the kernels they replaced
            **({f"max_abs_err_vs_{vs_old}": max(
                results["err"][(f"{kname}_vs_{vs_old}", dn)]
                for dn in ("float32", "bfloat16"))} if vs_old else {}),
            **({"max_abs_err_joined_vs_alone": max(
                results["err"][(JOINED_VS_ALONE, dn)]
                for dn in ("float32", "bfloat16"))}
               if kname == "narrow_grads" else {}),
            **t,
        })
    t = results["times"][DRAW_KERNEL]
    kernels.append({
        "name": DRAW_KERNEL, "route": "cuda", "source": DRAW_SOURCE,
        "replaces": DRAW_REPLACES, "replaces_also": DRAW_REPLACES_ALSO,
        "launches": results["launches"][DRAW_KERNEL],
        "launches_full_recipe": results["launches_full"][DRAW_KERNEL],
        "launches_bench": results["launches_bench"].get(DRAW_KERNEL, 0),
        "max_abs_err": results["err"][(DRAW_KERNEL, "float32")], **t})
    log(f"build {secs:.1f} s, phases {time.perf_counter() - t_start:.1f} s; "
        f"card {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
