#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and the repository's `src/` beside this file;
without a card, or run from a directory that holds nothing else of the
repository, it exits non-zero and prints no result.  It imports nothing
of JAX and nothing of the JAX package `repro`.

Phases (any failed check raises and ends the run non-zero):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the eight CUDA sources of src/repro_torch/csrc (one nvcc per
     source, all at once), with each kernel's registers and spills;
  3. each kernel at its main paths' shapes and at ragged geometries
     (S > K, S = D, ragged channels, a bias, a scale, a non-exact n_out;
     for attention `test_kernels.ATTN_SWEEP`'s ragged, non-causal, MQA
     and Sq < Sk cases, MQA at head_dim 256, Sq and Sk about the 64-row
     and 64-key tiles at every head_dim, and decode lengths 1-1025 over a
     strided cache, in fp32 and bf16, each case printed with the kernel
     form it ran on, reruns bit-identical; for the conv backwards and the
     filter gradient the plan's edges -- a position count the dW split
     does not divide, Cin = 3 at B = 16; for the two forwards and the
     implicit GEMM a split reduction and Cin 130 / Cout 37 -- every conv
     case printed with its plan's tiles and splits, or the implicit
     GEMM's tile, chunk and CTAs, reruns bit-identical): held against its
     plain PyTorch version on the card, and at the paths' shapes against
     the library call; kernel, plain and library timed with CUDA events,
     beside an empty kernel's launch (the floor under every launch); the
     phase / implicit-GEMM race: the generator's t1-t3 at batch 4 and 64
     on both kernels, the one `tiling.plan_strategy` picks and the other;
     phase 8's geometries (the atrous branches at D = 1, 2, 4 and the 1x1
     fuse conv at batch 16, 128x128, forward and backward; patchify's
     S = K = 14 conv at batch 8, 448x448, 3 -> 1024, forward and
     backward) and the paper's 14 input gradients on both kernels; the
     attention backward (csrc/flash_attention_bwd.cu) at qwen3's head_dim
     128, GQA g = 2, causal, bf16 and fp32, S = 1024, 1000 and the
     training path's 4096, and Sq 300 / Sk 1000 at q_offset 500, each on
     the form `attention.backward_plan` picks (bf16: wgmma, fp32: simt)
     and, in bf16 at S = 4096, 1024 and 1000, on the simt form as well:
     each case first holds the forward kernel's lse against the plain
     lse, then dq, dk, dv against the plain backward and, timed, SDPA's
     backward (its forward + backward less its forward), reruns
     bit-identical; zamba2's head_dim 80 in bf16 and fp32 (B 4, 32
     heads): prefill at S 1024 and 1000 on tile, a split decode over
     1025 keys, the backward at S 1024 on simt, each timed; and the six
     conv kernels' `_bf16` entries at the paths' shapes (the forwards
     and the generator's tconvs at batch 4 and 64 on both arms, the
     backwards and the filter gradient at batch 64), their ragged cases
     and the atrous branches at D = 1, 2, 4: each within one bf16 ulp of
     its plain version in bf16 (rtol 2^-7, atol 2^-7 of the output's
     largest magnitude), reruns bit-identical, printed with its plan; at
     the timed shapes held against cuDNN in bf16 at 5e-2 of the output's
     largest magnitude and timed (kernel, plain, cuDNN);
  4. serve 32 `gan_gen` and 32 `aspp` requests at the models' published
     widths through ConvServeEngine(ladder=("cuda",)): every result held
     against the same request through the plain versions, the kernels'
     launch counts against the launches the path makes, and no fault,
     fallback or NaN allowed;
  5. train: 5 `gan_sgd_step`s and 5 `sgd_step`s at the models' published
     widths on ConvDataset batches of 64, each step's loss and every
     parameter held against the same steps through the plain versions on
     the CPU, step 1 repeated on the card bit for bit, the launches of
     every step against STEP_LAUNCHES, and no NaN; then a torch.profiler
     trace of 2 more steps of each: device-busy ms per step by conv
     kernel, and the device's idle share; (b) the same models with
     every param and the batch cast to bf16: 3 `gan_sgd_step`s and 3
     `sgd_step`s, each step's loss and every param within 5e-2 of each
     leaf's largest magnitude of the same steps through the plain
     versions on the CPU in bf16, step 1 repeated bit for bit, the
     launches of every step against STEP_LAUNCHES (all on the `_bf16`
     entries), no NaN, and ms per step beside (a)'s fp32 ms;
  6. LM serving: (a) qwen3-0.6b at full width but 2 layers in fp32,
     params from a numpy seed: prefill of 4 prompts of 64-200 tokens and
     8 teacher-forced decode steps on the card, held after each call
     (logits and the whole KV cache) against the same calls through the
     plain versions on the CPU; (b) the whole qwen3-0.6b (28 layers,
     bf16) serving 12 requests (prompts of 128-1024 tokens, 8-32 new
     tokens each, so slots refill mid-flight) through
     ServeEngine(batch=4, max_len=2048): one flash-attention launch per
     layer per prefill and per decode step -- every prefill on the wgmma
     form, every decode step on the split form -- no NaN in any logits,
     every request answered, and the same tokens from a second run; then
     a torch.profiler trace of 4 decode steps: the device's busy time, the
     flash-attention kernels' part of it, against the step's wall time;
  7. the trainer: ConvTrainer (train/conv_trainer.py) for `gan`, `gan_gen`
     and `cnn` at the published widths, batch 64, 8 steps, its step
     captured once as a CUDA graph and replayed (train/step_graph.py):
     (a) the run equals 8 eager `build_step` steps on the graph's stream,
     losses and state bit for bit, with one capture and the wrappers
     called only at warm-up and capture; (b) 4 steps, then a fresh trainer
     resuming from the checkpoint to 8, equal the straight run bit for
     bit; (c) a nan_output injected at attempt 2 trips the flag on the
     card, is rolled back and retried, blames named layers and ends
     bit-equal to the straight run; (d) the run within 1e-3 of the same
     trainer on the CPU; (e) a torch.profiler trace of one replay launches
     each conv kernel as STEP_LAUNCHES says (27 / 12 / 6); (f) ms per step
     eager and replayed (batch on the card), device-busy ms and idle share
     of each, the commit copy's device ms, the trainer loop's ms per step
     and `batch_at`'s ms;
  8. vision (`vision_phase`): (a) 5 steps of `examples.segment_atrous`'s
     step (AdamW) on the ASPP head at batch 16, 128x128, and (b) patchify
     at batch 8, 448x448, d_model 1024: its embeddings and 3 AdamW steps
     on sum(out^2), each step held against the same step on the CPU, its
     launches against VISION_LAUNCHES, step 1 rerun bit for bit; (c) the
     planner autotuned into a temporary artifact at the generator's t1-t3
     (B = 4, 64) and the paper's 14 input gradients: both arms, the
     analytical pick and its misses; the artifact replayed with no
     runner call; the serving engine's warmup served from it; each
     corruption of it warned about and re-planned; (d) ms per atrous and
     patchify step, device-busy ms, idle share and ms by conv kernel;
  9. LM training (`lm_train_phase`): (a) qwen3-0.6b at its published
     widths but 2 layers, batch 2 x seq 256 with masked labels: `LM.loss`
     and every gradient (remat "full", attention forward and backward on
     the kernels) held against the CPU in fp32 and bf16; (b) the whole
     qwen3-0.6b (28 layers, bf16 compute, fp32 master weights, AdamW)
     through `Trainer.run` -- `launch/train`'s path -- at train_4k's
     seq 4096, global batch 8 (train_4k's 256 cut to one card) in 4
     microbatches, 1 warm-up and 3 timed steps with a checkpoint
     directory: every loss finite, each step 224 `flash_attention` and
     112 `flash_attention_backward` calls, all on their wgmma forms
     (`ops.FLASH_FORMS`, `ops.FLASH_BWD_FORMS`), the step-4 checkpoint on
     disk; ms per step, tokens/s, peak memory, and a torch.profiler trace
     of one more step (device ms by kernel group, busy share); then the
     same run again, its losses bit-equal;
  10. the int8 KV cache, the examples and the quickstart: (a) qwen3-0.6b
     at full width, 2 layers, fp32, `kv_quant`: phase 6 (a)'s prompts and
     8 forced decodes on the card, each call held against the same call
     on the CPU (`int8_serve_phase`); (b) the whole model in bf16 with
     `kv_quant` serving phase 6 (b)'s 12 requests through ServeEngine:
     requests/s, tokens/s, ms per prefill and decode step, peak memory,
     the cache's bytes against the bf16 cache's, the first decode's
     softmax against the bf16 cache's, the share of greedy tokens equal
     to phase 6's, a decode profile; (c) 3 steps each of the
     `train_cnn_ecoflow` and `train_gan` examples on the `cuda` backend
     against the CPU, their launches per step (EXAMPLE_LAUNCHES) and ms
     per step, and `serve_lm` at its defaults (`examples_phase`); (d) the
     quickstart: its dx and dW (the filter-gradient kernel's first
     program path) against `naive`, and its kernel / `torch_zero_free` /
     `naive` times (`quickstart_phase`);
  11. the moe, ssm and hybrid families (`families_phase`) at their
     published widths, params drawn on the card from a seed: (a)
     moonshot-v1-16b-a3b at 1 layer, rwkv6-7b at 2, zamba2-2.7b at 12
     (2 groups: the shared block used twice), fp32: phase 6 (a)'s prefill
     and 8 forced decodes, logits per call within 1e-3 of the CPU, then
     the loss and every gradient at batch 2 x seq 256 (1e-3 of each
     leaf's max); the MoE routing of both sides compared call by call
     and, past a call routed otherwise, its dispatch/combine held on the
     card's routing (`family_parity`); (b) moonshot-v1-16b-a3b (the
     deepest its bf16 params fit in FAMILY_SERVE_SHARE of the card),
     rwkv6-7b and zamba2-2.7b whole, bf16, serving phase 6 (b)'s first 6
     requests through ServeEngine: one `flash_attention` launch per
     attention layer per call (moonshot: wgmma prefills; zamba2: 9 a
     call at head_dim 80, tile prefills; split decodes; rwkv6: none),
     requests/s, tokens/s, ms per prefill and decode step, peak memory,
     a decode profile (`family_serve`); (c) moonshot-v1-16b-a3b at 2
     layers and zamba2-2.7b at 12 (2 groups) through `Trainer.run` at
     seq 4096, batch 8 in 4 microbatches, 3 steps: launches and forms per
     step (wgmma at head_dim 128; tile and simt at 80), ms per step,
     tokens/s, peak memory, the aux loss, a rerun's losses bit-equal
     (`family_train`);
  12. (a) the audio and vlm families (`embeds_phase`), inputs that are
     frame embeddings: musicgen-medium at 2 layers and internvl2-76b at 1
     in fp32 against the CPU (`family_parity` on frames: logits per call, the
     loss and every gradient, internvl2's at batch 1); musicgen-medium
     whole (48 layers) and internvl2-76b at the deepest cut whose bf16
     params take FAMILY_SERVE_SHARE of the card, served in bf16 on phase 6
     (b)'s first 6 requests with frames in place of prompts (`LM.prefill`
     on frames, greedy `decode_step`s; prefills on wgmma at head_dim 64 /
     128, decodes on split), requests/s, ms per call, a decode profile
     (`embed_serve`); musicgen-medium trained at 24 layers through
     `Trainer.run` at seq 4096, batch 8 in 4 microbatches, 4 steps, traced, a rerun
     bit-equal; (b) the conv steps on a device mesh (`mesh_phase`): MESH_RANKS
     `gloo` ranks spawned on the one card, a (2, 2) ("data", "model")
     mesh; gan_sgd_step, gen_sgd_step and sgd_step at phase 5's widths,
     batch 64, on params laid out by `tree_shardings` and batches by
     `batch_pspec`, each held against the same step on one rank (params
     rtol 2e-4 / atol 2e-5, losses 1e-5), STEP_LAUNCHES on each rank,
     every plan on the rank's block; ConvTrainer(gan) checkpointed at step
     2 on the mesh, a host of 2 ranks lost, restored onto
     `elastic_mesh(survivors(...))` (1, 2) and run to step 4, equal to one
     rank's run; ms per step sharded and alone (`gloo` ranks sharing one
     card: no multi-card speed);
  13. the dense LM on the same mesh (`lm_mesh_phase`; `lm_mesh_rank` in
     MESH_RANKS spawned `gloo` ranks sharing the card): (a) qwen3-0.6b at
     its published widths and PARITY_LAYERS layers in fp32, params from
     phase 6 (a)'s numpy seed laid out by `tree_shardings`: one
     `make_train_step` step at LM_MESH_TRAIN on a `batch_pspec` batch
     against the same step on one rank (loss LM_MESH_LOSS_RTOL relative,
     params LM_MESH_PARAM_TOL), the loss and every gradient in fp32
     (LM_MESH_GRAD_TOL of each leaf's max) and bf16 (phase 9's class),
     prefill + MESH_DECODES forced decodes in the training and serve
     layouts, logits and each rank's cache block per call at PARITY_TOL
     (the cache's second sequence block first gets a key at the third
     decode), the launches and forms per rank; (b) the whole model in
     bf16 through ServeEngine(mesh=, serve_sharding="tp") on phase 6
     (b)'s first LM_MESH_REQUESTS requests: the same tokens on every
     rank, the share equal to one rank's engine (top-2 margins at a first
     disagreement), requests/s, ms per prefill and decode step sharded
     and alone, peak memory per rank, one launch per layer per prefill
     and per decode step whose sequence block holds a key; (c)
     Trainer(mesh=) at LM_MESH_TRAIN_LAYERS layers in fp32, phase 9's
     seq and batch: step 1 checkpointed, host 1 lost, restored onto
     `elastic_mesh(survivors(...))` (1, 2) and run to
     LM_MESH_TRAIN_STEPS, held against one rank's straight run at (a)'s
     bounds, its first segment rerun bit-equal, ms per step on each mesh
     and alone; (d) `gpipe` over a 4-stage mesh against the stages in
     sequence, `compressed_psum` over a (2, 2) ("pod", "data") mesh
     against `repro`'s arithmetic reckoned here, RunSupervisor on `cnn`
     with host 1 lost at step 3 (meshes {2, 2} then {1, 2}, the final
     state at the conv mesh bound of the fault-free run);
  14. the moe, ssm, hybrid, audio and vlm families and the int8 KV cache
     on the same mesh (`families_mesh_phase`; `fm_rank` in MESH_RANKS
     spawned `gloo` ranks), each call held against one rank alone on the
     card at phase 13's bounds: (a) FM_PARITY's configs at their
     published widths in fp32 (moonshot-v1-16b-a3b at 1 layer in the
     training, serve and `moe_ffn_data` layouts; rwkv6-7b at 2,
     zamba2-2.7b at 12 (2 groups), musicgen-medium at 2 and internvl2-76b
     at 1 in the training and serve layouts): the loss, the MoE aux and
     every gradient in the training layout, prefill + MESH_DECODES
     decodes in each layout (logits and every cache entry), launches and
     forms per rank (`fm_parity`: rank 0's own run saved to a file, each
     rank holding its blocks); (b) moonshot, rwkv6 and zamba2 at 4 / 4 /
     12 layers in bf16 through ServeEngine(mesh=, serve_sharding="tp") on
     phase 6 (b)'s first FM_REQUESTS requests, each call held against
     one rank's on the same inputs (its tokens, the mesh's cache) and
     the mesh's MoE routing: logits and router logits within
     FM_SERVE_TOL of their max, every greedy token equal to one rank's
     but at a bf16 tie (`fm_serve`, `_routes`, `_serve_agreement`); (c)
     LM_ARCH at 2 layers with `kv_quant` in both layouts, each decode
     held against one rank's from the mesh's codes, the mesh's codes
     against one rank's own run (one apart only at a rounding tie,
     KV_TIE_TOL) and its logits too (within the int8 cache's own drift
     from an unquantized one); (d) Trainer(mesh=) on moonshot at FM_TRAINER's size,
     its losses and aux against one rank's (`fm_trainer`);
  15. the dry-run (`dryrun_phase`; three spawned processes at once, as
     the fake process group is process-global): (a) each form of the
     attention kernels (tile, wgmma and split forward, simt and wgmma
     backward) at one shape, launched on the card and run as its fake
     form (`launch/dryrun.py`'s trace runs those in place of launches):
     the fake outputs' shapes, dtypes and strides equal the launch's, and
     the bytes the fake form allocates (rounded as the allocator rounds)
     equal the allocator's peak during the launch; (b) DRYRUN_TRACED's
     production cells traced as rank 0 of the 16 x 16 mesh (a fake world
     of 256 ranks) on fake tensors, each printed beside
     `benchmarks/roofline.py`'s analytic terms under the H100; (c)
     DRYRUN_REAL's cell traced so, then its rank 0 run for real on the
     card in the fake world from zeros: the arguments' bytes on the card
     equal to the trace's, the allocator's rise from a reset to
     `torch.cuda.max_memory_allocated()` equal to the trace's temp, that
     peak within DRYRUN_MEM_TOL of the trace's arguments plus temp, the
     launches of each kernel form equal to the trace's fake forms'.
     Each phase prints its seconds.

Tolerance: atol = rtol = 1e-4 for each kernel against its plain version
and the library.  Kernel, plain version and library all compute in fp32;
they differ only in the order of their sums, which moves fp32 results by
a few ulps of the largest partial sum.  Flash attention in bf16: kernel
and plain version compute the same fp32 values from the same bf16
inputs and round once, so they may differ by one bf16 ulp: rtol = 2^-7,
atol = 1e-4 (the wgmma form keeps P to ~16 bits as two bf16 terms, so
its P.V stays in that class).  The library rounds its probabilities to
bf16 as well, so it is held at atol = rtol = 5e-2.  A backward case
draws its cotangent at scale 1/sqrt(B*Oh*Ow), so each filter-gradient
sum over B*Oh*Ow products is of order 1, as it is in training;
unscaled, a sum of 16384 unit products would put its rounding near the
tolerance itself.
The attention backward is held to its plain version as the forward
is (fp32 1e-4; bf16 one ulp: both round fp32 sums once), the lse at
1e-4, SDPA's gradients at the forward's library tolerance.  LM training
parity (phase 9 (a)): each gradient leaf within 1e-3 (fp32) or 5e-2
(bf16) of its largest magnitude, absolute and relative: gradients near
zero carry the rounding of the largest terms of their sums.
Training: atol = rtol = 1e-3 after every step -- dW sums up to 16384 fp32
products in another order than the plain matmul, and five steps carry
the difference on; the trainer's 8 steps are held to the same 1e-3.
Replayed against eager steps, resumed and rolled-back runs against the
straight run: bit for bit (the kernels use no atomics and split their
sums in a fixed order).  LM parity: atol = rtol = 1e-3 on logits and cache
after every call (fp32 matmuls over d_model 1024 and d_ff 3072 in
another order than the CPU's, carried through 2 layers and 8 steps).
Phase 10: int8 KV parity as the fp32 LM's (1e-3) per call on the same
codes, codes 1 apart at most (a tie of the fp32 quotient rounds either
way), scales 1e-4 relative; the int8 serving's first decode against the
bf16 cache's at 0.05 (`tests/test_models_smoke.py:164`'s bound for
`repro`); the example steps' losses at the training 1e-3; the quickstart
at 1e-4 (fp32 against fp32, cuDNN for `naive`).
TF32 is turned off for cuDNN and for torch.matmul, so no side rounds its
inputs to 10 bits.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 peak outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
SLOT_BATCH = 4
N_REQUESTS = 32
TRAIN_TOL = 1e-3
TRAIN_BATCH = 64
TRAIN_STEPS = 5
LR = 0.05
# Phase 3's conv kernels in bf16: one bf16 ulp of the plain version, and
# cuDNN in bf16 (atol relative to the output's largest magnitude).
BF16_TOL = (2.0 ** -7, 2.0 ** -7, "of max")
BF16_LIB_TOL = (5e-2, 5e-2, "of max")
PHASE3_ITERS = 10         # timed calls a case (20 before phase 14 came)
TRAIN_STEPS_BF16 = 3      # phase 5 (b)
TRAIN_TOL_BF16 = 5e-2     # phase 5 (b): of each leaf's largest magnitude
# (atol, rtol) of flash attention against its plain version and against
# the library, by dtype.
ATTN_TOL = {torch.float32: (TOL, TOL), torch.bfloat16: (1e-4, 2.0 ** -7)}
ATTN_LIB_TOL = {torch.float32: (TOL, TOL), torch.bfloat16: (5e-2, 5e-2)}
LM_ARCH = "qwen3-0.6b"
LM_BATCH = 4
LM_MAX_LEN = 2048
LM_REQUESTS = 12
PARITY_LAYERS = 2
PARITY_DECODES = 8
# Phases 13 (a) and 14 (a): forced decodes per layout on the mesh (8, as
# PARITY_DECODES, before phase 15 came).
MESH_DECODES = 4
PARITY_TOL = 1e-3
PROFILE_CACHED = 512      # positions in the cache when decode is traced
PROFILE_STEPS = 4
PROFILE_TRAIN_STEPS = 2   # training steps traced per model
# Phase 9, LM training: (a) PARITY_LAYERS layers at the published widths,
# batch 2 x seq 256, loss and gradients against the CPU; (b) the whole
# model through Trainer.run at train_4k's length, batch cut to one card.
LM_TRAIN_PARITY = (2, 256)        # (batch, seq) of (a)
LM_TRAIN_TOL = {"float32": 1e-3, "bfloat16": 5e-2}   # of each leaf's max
LM_TRAIN_SEQ = 4096               # SHAPES["train_4k"].seq_len
LM_TRAIN_BATCH = 8                # train_4k's 256, cut to one card
LM_TRAIN_STEPS = 4                # 1 warm-up + 3 timed
# The attention backward's kernels (csrc/flash_attention_bwd.cu), three
# launches per wrapper call: delta, then dk/dv and dq of the simt or the
# wgmma form.
ATTN_BWD_SYMBOLS = ("attn_bwd_delta_kernel", "attn_bwd_dkdv_kernel",
                    "attn_bwd_dq_kernel", "attn_bwd_dkdv_wgmma_kernel",
                    "attn_bwd_dq_wgmma_kernel")
# The conv wrappers' kernel symbols (csrc/*.cu), to sort a trace by.
CONV_SYMBOLS = {"dconv_forward": "dconv_forward_kernel",
                "tconv_phase": "tconv_phase_kernel",
                "tconv_implicit_gemm": "tconv_implicit_gemm_kernel",
                "conv_backward": "conv_backward_kernel",
                "tconv_backward": "tconv_backward_kernel",
                "dconv_filter_grad": "dconv_filter_grad_kernel"}
ATTN_FORMS = ("tile", "wgmma", "split")   # csrc/flash_attention.cu's kernels

# Kernel launches of one training step, by wrapper of
# repro_torch.kernels.ops: the kernels `repro`'s same step runs as
# pallas_calls (tests/test_torch_train.py pins both).  The GAN step runs
# the generator twice (G loss and D loss) and the discriminator three
# times (fake in both losses, real in the D loss); the D loss takes no
# generator gradient.
STEP_LAUNCHES = {
    "gan_sgd_step": {"tconv_implicit_gemm": 6, "dconv_forward": 9,
                     "conv_backward": 9, "tconv_backward": 3},
    "gen_sgd_step": {"tconv_implicit_gemm": 3, "dconv_forward": 3,
                     "conv_backward": 3, "tconv_backward": 3},
    "sgd_step": {"dconv_forward": 3, "conv_backward": 3},
}
# Phase 8's launches.  The atrous loss and its gradients: the three
# dilated branches (relu in the epilogue) forward and backward, and the
# 1x1 fuse conv's backward (its plain forward is a torch.matmul); the
# example's step adds the post-update forward.  `repro` counts the same
# pallas_calls (7, 10).  Patchify's plain S = 14 forward takes the
# dconv_forward kernel, where `repro` sends a plain D = 1 forward to XLA:
# 2 launches against its 1 pallas_call (ROADMAP C; tests/test_torch_train.py
# pins all three).
VISION_LAUNCHES = {
    "atrous_seg_loss": {"dconv_forward": 3, "conv_backward": 4},
    "segment_atrous_step": {"dconv_forward": 6, "conv_backward": 4},
    "patchify": {"dconv_forward": 1, "conv_backward": 1},
}


# Phase 7: ConvTrainer at the published widths, each workload with the
# model step it runs (STEP_LAUNCHES' key) and its geometry.
TRAINER_MODELS = {
    "gan": ("gan_sgd_step", dict(z_dim=64, base=64)),
    "gan_gen": ("gen_sgd_step", dict(z_dim=64, base=64)),
    "cnn": ("sgd_step", dict(widths=(32, 64, 128), image=32, n_classes=10)),
}
TRAINER_STEPS = 8
TRAINER_CKPT_EVERY = 4
TRAINER_NAN_AT = 2        # the step attempt the injected nan_output poisons
TRAINER_TIMED = 20        # steps per timing of eager steps and replays
TRAINER_PROFILED = 5      # replays (eager steps) per timing trace
PROFILE_PAD_S = 0.05      # idle host time on each side of a traced window
PROFILE_LEAD_IN = 32      # spin kernels that open a traced window

# Phase 8: the atrous head at the serving slice's widths trained as
# `repro_torch.examples.segment_atrous` trains it, and patchify at
# `repro`'s default width.
ATROUS_BATCH = 16
ATROUS_SIZE = 128
ATROUS_STEPS = 5
ATROUS_OPT = dict(lr=3e-3, warmup_steps=10, total_steps=120,
                  weight_decay=0.01)      # examples/segment_atrous.py:62-63
PATCH = 14
PATCH_BATCH = 8
PATCH_SIZE = 448
PATCH_D_MODEL = 1024
PATCH_STEPS = 3
VISION_TIMED = 10         # eager steps per timing
MISS_RATIO = 1.1          # an analytical pick this much slower is a miss
KV_SCALE_RTOL = 1e-4      # phase 10 (a): the int8 cache's scales
SOFTMAX_TOL = 0.05        # phase 10 (b): tests/test_models_smoke.py:164's
EXAMPLE_STEPS = 3         # phase 10 (c): steps held against the CPU
EXAMPLE_TIMED = 10        # phase 10 (c): steps per timing
# Wrapper calls per step of the two training examples (phase 10 (c)) on the
# `cuda` backend, the transposed convs' two kernels merged as "tconv" (the
# planner picks between them).  CNN: 3 forwards for the loss, 3 fused
# backwards, 3 forwards of the updated model for the accuracy.  GAN: the
# discriminator's update (3 tconv + 6 forwards, 6 backwards of its two
# branches) then the generator's (3 tconv + 6 forwards, 3 backwards of
# the fake branch, 3 tconv backwards).
EXAMPLE_LAUNCHES = {
    "train_cnn_ecoflow": {"dconv_forward": 6, "conv_backward": 3},
    "train_gan": {"tconv": 6, "dconv_forward": 12, "conv_backward": 9,
                  "tconv_backward": 3}}
PAPER_BATCH = 4           # dataflow_sim.ConvLayer's batch
# The generator's transposed convs as (name, dy side, n_out, Cin, Cout,
# activation): K = 4, S = 2, P = 1.
GEN_TCONVS = [("gan_t1", (4, 4), (8, 8), 64, 128, "relu"),
              ("gan_t2", (8, 8), (16, 16), 32, 64, "relu"),
              ("gan_t3", (16, 16), (32, 32), 3, 32, "tanh")]
TCONV_KERNELS = {"phase": "tconv_phase", "implicit_gemm": "tconv_implicit_gemm"}
# Phase 11: the moe, ssm and hybrid families at their published widths.
# (a) parity against the CPU in fp32 at these depths (zamba2: 12 Mamba
# blocks = 2 groups, so the shared block is used twice).
# moonshot-v1-16b-a3b at 1 layer since phase 12 came (its 2 layers took
# ~52 s, most of it the CPU's side).
FAMILY_PARITY = {"moonshot-v1-16b-a3b": 1, "rwkv6-7b": 2, "zamba2-2.7b": 12}
# (b) serving in bf16: the whole model, or for moonshot the deepest that
# keeps its bf16 params within this share of the card's memory.
FAMILY_SERVE = ("moonshot-v1-16b-a3b", "rwkv6-7b", "zamba2-2.7b")
# (b) and phase 12 (a)'s serving: the first FAMILY_REQUESTS of phase 6
# (b)'s requests (all LM_REQUESTS before phase 14 came, 8 before phase 15:
# 6 still refill a slot of the batch of 4 mid-flight).
FAMILY_REQUESTS = 6
FAMILY_SERVE_SHARE = 0.75
# (c) training at train_4k's seq through Trainer.run: layers (None: the
# deepest whole groups whose training state -- FAMILY_TRAIN_BYTES a param:
# fp32 params, gradients, the microbatch accumulator, Adam's m and v, the
# update's new copies and the bf16 precast -- takes at most
# FAMILY_TRAIN_SHARE of the card's memory; moonshot-v1-16b-a3b at 2
# layers peaked at 73.8 GB for 1.85 B params on an H100 80GB), and
# whether one more step is traced: zamba2's step makes ~300 K device
# events, whose trace took ~140 s to read back on that machine (PERF.md
# section 5 holds one).  zamba2 trains at 12 layers (2 groups: the shared
# block used twice) since phase 12 came: its 30 layers took ~60 s.
FAMILY_TRAIN = {"moonshot-v1-16b-a3b": (2, True),
                "zamba2-2.7b": (12, False)}
FAMILY_TRAIN_BYTES = 40
FAMILY_TRAIN_SHARE = 0.7
FAMILY_TRAIN_STEPS = 3
FAMILY_SEED = 41          # the card generator's seed of phase 11's params
# Phase 12 (a): the audio and vlm families, whose inputs are embeddings.
# Parity at EMBED_PARITY's depths; musicgen-medium served whole and
# trained at EMBED_TRAIN's;
# internvl2-76b served at the deepest cut whose bf16 params take
# FAMILY_SERVE_SHARE of the card (its training state would not fit).
# (layers, the gradients' (batch, seq)): internvl2-76b's at batch 1, as
# its CPU side (3.8 B fp32 params) takes ~1.5 min at phase 11's (2, 256).
# internvl2-76b at 1 layer since phase 14 came (its 2 layers took ~66 s,
# most of it the CPU's side).
EMBED_PARITY = {"musicgen-medium": (2, LM_TRAIN_PARITY),
                "internvl2-76b": (1, (1, 256))}
EMBED_SERVE = ("musicgen-medium", "internvl2-76b")
EMBED_TRAIN = {"musicgen-medium": 24}   # 48 before phase 14 came (46 s)
EMBED_TRAIN_STEPS = 4
# Phase 12 (b): the conv steps on a (2, 2) ("data", "model") mesh of
# MESH_RANKS `gloo` ranks that share the one card, at phase 5's widths and
# batch; `repro`'s bounds (tests/test_multidevice.py:418-420).
MESH_SHAPE = (2, 2)
MESH_RANKS = 4
MESH_RTOL, MESH_ATOL, MESH_LOSS_TOL = 2e-4, 2e-5, 1e-5
MESH_TIMED = 5            # steps per timing, sharded and single-rank
MESH_TRAINER_STEPS = 4    # the elastic run: checkpoint at 2, a host lost
# Phase 13: the dense LM (LM_ARCH) on the same (2, 2) mesh of MESH_RANKS
# `gloo` ranks sharing the card.  (a) parity at PARITY_LAYERS layers, fp32:
# one train step at LM_MESH_TRAIN (batch, seq) against one rank (loss
# relative, each gradient of its leaf's max, params after AdamW with
# `repro`'s tests/test_multidevice.py:101-107 bound), the bf16 gradients
# at phase 9's bf16 class, prefill + MESH_DECODES decodes per call in
# both layouts at PARITY_TOL; (b) the whole model in bf16 serving the first
# LM_MESH_REQUESTS of phase 6 (b)'s requests in the serve layout; (c)
# Trainer(mesh=) at LM_MESH_TRAIN_LAYERS layers, phase 9's seq and batch,
# a host lost at step 2; (d) gpipe over GPIPE (stages, microbatches,
# microbatch, width), compressed_psum over a (2, 2) ("pod", "data") mesh
# on COMPRESS_N values a pod, RunSupervisor on `cnn` for SUPERVISOR_STEPS
# steps with host 1 lost at step 3.
LM_MESH_TRAIN = (8, 256)
LM_MESH_LOSS_RTOL, LM_MESH_GRAD_TOL, LM_MESH_PARAM_TOL = 1e-5, 1e-3, 2e-2
LM_MESH_REQUESTS = 5       # 12 before phase 14, 6 before phase 15 (5 refill)
LM_MESH_MAX_LEN = 1280    # (b)'s cache: the longest history (1026) crosses
                          # the sequence blocks' boundary at 640
LM_MESH_TRAIN_LAYERS = 2   # 4 before phase 14 came (74-82 s of (c))
LM_MESH_TRAIN_STEPS = 2   # 4 before phase 15 came: one step a segment
LM_MESH_SEED = 7          # the card generator's seed of (b)'s and (c)'s params
GPIPE = (4, 8, 2, 64)
COMPRESS_N = 4096
SUPERVISOR_STEPS = 6
# Phase 14: the moe, ssm, hybrid, audio and vlm families and the int8 KV
# cache on the same (2, 2) mesh of MESH_RANKS `gloo` ranks, every bound
# phase 13's, held against one rank alone on the card.  (a) parity in
# fp32 at published widths: (layers, layouts); the loss and gradients at
# LM_TRAIN_PARITY (internvl2-76b at batch 1, 1 layer: 2 layers' fp32
# params are 15.2 GB, and four ranks drawing them beside one rank's
# reference and its gradients would not fit the card's 80 GB);
# prefill + MESH_DECODES decodes in each layout.
FM_PARITY = {"moonshot-v1-16b-a3b": (1, ("train", "tp", "ffn")),
             "rwkv6-7b": (2, ("train", "tp")),
             "zamba2-2.7b": (12, ("train", "tp")),
             "musicgen-medium": (2, ("train", "tp")),
             "internvl2-76b": (1, ("train", "tp"))}
FM_TRAIN = {"internvl2-76b": (1, 256)}
FM_LAYOUTS = {"train": {}, "tp": {"serve": True},
              "ffn": {"moe_ffn_data": True}}
# (b) ServeEngine(mesh=, serve_sharding="tp") in bf16 at these depths on
# phase 6 (b)'s first FM_REQUESTS requests, the cache LM_MESH_MAX_LEN.
# After each call one rank makes it alone on the same inputs (the tokens,
# the mesh's cache gathered whole) with the mesh's MoE routing: each
# call's logits, and each MoE call's router logits, within FM_SERVE_TOL
# of its largest |logit| of one rank's (BF16_LIB_TOL's bound, that of
# bf16 math summed in another order, here over 4-12 layers); each argmax
# equal but at a tie: on each side the two picks are its top two, within
# 2 eps of the top logit.  Two eps, not one: eps |top| is 1-2 bf16 ulps
# of it, and each side's logit is rounded once from a differently
# ordered fp32 sum; one eps failed a flip two ulps apart (0.03125 at
# 3.71875) on an H100, two eps takes 2-4 ulps.  (Expert choices held at
# 2 eps of the k-th router logit failed on an H100 at 2.19 eps: the
# router logits carry the noise of every layer below them, so they are
# held as the logits are, and the choices follow from them.  One rank's
# engine run whole, teacher-forced on the mesh's tokens, drifted from
# the mesh on zamba2 over 28 bf16 decodes, 4.4e-3 to 7.6e-2 of the max,
# in rows still serving: its recurrent state carries each call's
# rounding into the next, so each call is held from the mesh's own
# cache.)
FM_SERVE = {"moonshot-v1-16b-a3b": 4, "rwkv6-7b": 4, "zamba2-2.7b": 12}
FM_REQUESTS = 4
FM_SERVE_TOL = BF16_LIB_TOL[0]
# (c) LM_ARCH with `kv_quant` at FM_KVQ_LAYERS layers, fp32, both layouts.
# An int8 code of the mesh may be one apart from one rank's own run only
# where one rank's unrounded code k / scale lies within KV_TIE_TOL of a
# half: the two sides' unrounded codes (at most 127 in size) differ by
# 127 times the relative differences of the value and of its scale, each
# within KV_SCALE_RTOL.
FM_KVQ_LAYERS = 2
KV_TIE_TOL = 2 * 127 * KV_SCALE_RTOL
# (d) Trainer(mesh=) on moonshot-v1-16b-a3b: (layers, seq, global batch,
# steps), fp32, one microbatch (so the step carries the aux loss).
FM_TRAINER = (1, 256, 4, 2)
FM_SEED = 43              # the card generator's seed of phase 14's params
# Phase 15, the dry-run.  (b) production cells traced as rank 0 of the
# 16 x 16 mesh, each in a process of its own; (c) the cell whose rank 0
# also runs for real on the card: a decode (its per-rank cache is 1.9 GB
# of bf16).  The fake group moves no data, so a gathered buffer holds
# whatever the allocator left there: this cell gathers one integer tensor,
# its token ids over "data", which `models/layers.py::embed_mesh` clamps
# into the rank's vocab rows before the lookup, so every index stays in
# range; no other integer is gathered.
DRYRUN_TRACED = (("qwen3-0.6b", "train_4k"),
                 ("qwen3-moe-235b-a22b", "decode_32k"))
DRYRUN_REAL = ("qwen3-0.6b", "decode_32k")
DRYRUN_MEM_TOL = 0.10
# (a) one shape per form of rows 7-8, every tensor under 1 MB (the
# allocator's small pool splits its blocks to the 512-byte granule):
# (form, dtype, B, Sq, Sk, Hq, Hk, D, q_offset, the forward's lse).
DRYRUN_FORMS = (("tile", torch.float32, 2, 256, 256, 4, 4, 64, 0, True),
                ("wgmma", torch.bfloat16, 1, 256, 256, 8, 2, 128, 0, True),
                ("split", torch.bfloat16, 4, 1, 1025, 16, 8, 128, 1024,
                 False),
                ("simt", torch.float32, 1, 256, 256, 4, 2, 64, 0, None),
                ("wgmma", torch.bfloat16, 1, 256, 256, 8, 2, 128, 0, None))


def paper_layers() -> list:
    """The paper's layers whose input gradients the planner races (Table
    5, Table 7 and the two DeepLab ASPP layers of `core/dataflow_sim.py`):
    (name, Cin, N in, N out, K, M = Cout, S, D), at PAPER_BATCH."""
    from repro_torch.core import dataflow_sim as ds

    return [(l.name, l.c_in, l.n_in, l.n_out, l.k, l.m, l.stride, l.dilation)
            for l in (ds.TABLE5_LAYERS + ds.TABLE7_GAN_LAYERS
                      + ds.DILATED_LAYERS)]


def paper_spec(n_in, n_out, k, s, d):
    """`dataflow_sim.ConvLayer.padding`'s P, in a ConvSpec."""
    from repro_torch.core.spec import ConvSpec

    p = max(0, ((n_out - 1) * s + d * (k - 1) + 1 - n_in + 1) // 2)
    return ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

class DeviceTimer:
    """Device time of a call with CUDA events.  A spin kernel queued ahead
    of the timed launches holds the stream until the host has queued them
    all, so the events measure the card and not the host's launch rate."""

    def __init__(self):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        self.ms_per_cycle = start.elapsed_time(end) / 10_000_000

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / warmup
        cycles = int((2.0 * iters * host_ms + 1.0) / self.ms_per_cycle)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(min(cycles, 4_000_000_000))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters


# -- work counts for the bound -----------------------------------------------

def _taps_in_range(o, n, k, s, p, d) -> int:
    """(output position, tap) pairs of one axis whose input index lies in
    the image: the products these inputs need (padding zeros excluded).
    The count is the same for a conv and its transposed conv."""
    return sum(1 for i in range(o) for t in range(k)
               if 0 <= i * s + t * d - p < n)


def useful_macs(spec, batch, small_hw, large_hw, cin, cout) -> int:
    """small_hw: the conv output (= tconv input) size, large_hw: the conv
    input (= tconv output) size."""
    return batch * cin * cout * math.prod(
        _taps_in_range(small_hw[a], large_hw[a], spec.filter_shape[a],
                       spec.stride[a], spec.padding[a], spec.dilation[a])
        for a in range(2))


def bound_ms(nbytes: int, macs: int,
             flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def visible_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes for one head: with the causal
    mask bottom-right aligned, query i sees min(Sk, Sk - Sq + i + 1)
    keys."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, Sk - Sq + i + 1) for i in range(Sq))


def ptxas_usage(log: str) -> list[tuple[str, str, str]]:
    """(kernel<template arguments>, registers, spills) of every entry
    function in an `nvcc -Xptxas=-v` log."""
    rows, label, spills = [], "?", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '_ZN?(\w+)'", line)
        if entry:
            rest, name = entry.group(1), "?"
            while rest[:1].isdigit():     # <length><name> ... of the path
                n = re.match(r"\d+", rest).group()
                name, rest = rest[len(n):len(n) + int(n)], rest[len(n)
                                                               + int(n):]
            args = re.match(r"I(\w*?)E+v", rest)
            args = args.group(1) if args else ""
            if "Tile" in args:    # Tile<BM, BN, TM, TN> of each role
                nums = re.findall(r"Li(\d+)E", args)
                args = ",".join("x".join(nums[i:i + 2])
                                for i in range(0, len(nums), 4))
            args = args.replace("13__nv_bfloat16", "bf16,")
            args = re.sub(r"^f", "fp32,", args)
            args = re.sub(r"Li(\d+)E?", r"\1,", args).strip(",")
            label, spills = f"{name}<{args}>", ""
        elif "spill stores" in line:
            spills = line.strip()
        used = re.search(r"Used (\d+) registers", line)
        if used:
            rows.append((label, used.group(1), spills))
    return rows


def lm_parity_inputs(plm):
    """Phase 6 (a)'s params and inputs for `plm` (a config at full width
    with PARITY_LAYERS layers), drawn from numpy seed 13: (CPU params,
    prompt lengths, right-aligned prompts (LM_BATCH, max) int32, the
    PARITY_DECODES forced tokens, the cache's max_len)."""
    from repro_torch.models.layers import tree_map

    pcfg = plm.cfg
    rng = np.random.default_rng(13)

    def draw(t):
        """N(0, 1) scaled as LM.init scales it (the embedding by 1, a
        stacked (layer, fan-in, fan-out) weight by 1/sqrt(fan-in)); the
        norm scales by 0.1, so that 1 + scale is not 1."""
        if t.shape == (pcfg.vocab, pcfg.d_model):
            scale = 1.0
        elif t.dim() == 3:
            scale = 1.0 / math.sqrt(t.shape[1])
        else:
            scale = 0.1
        return torch.from_numpy(
            (scale * rng.standard_normal(t.shape)).astype(np.float32))

    cpu_params = tree_map(draw, plm.init(torch.Generator().manual_seed(0),
                                         device="cpu"))
    lens = rng.integers(64, 201, LM_BATCH)
    toks = np.zeros((LM_BATCH, int(lens.max())), np.int32)
    for i, n in enumerate(lens):
        toks[i, toks.shape[1] - n:] = rng.integers(1, pcfg.vocab, n)
    forced = rng.integers(1, pcfg.vocab, (PARITY_DECODES, LM_BATCH, 1))
    return cpu_params, lens, toks, forced, toks.shape[1] + PARITY_DECODES


def lm_requests(vocab: int) -> list:
    """Phase 6 (b)'s LM_REQUESTS requests: prompts of 128-1024 tokens,
    8-32 new tokens each, from numpy seed 0."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(0)
    return [Request(uid=i,
                    prompt=rng.integers(1, vocab, rng.integers(128, 1025)
                                        ).astype(np.int32),
                    max_new_tokens=int(rng.integers(8, 33)))
            for i in range(LM_REQUESTS)]


def instrumented_engine(cfg, params):
    """A fresh ServeEngine(batch=LM_BATCH, max_len=LM_MAX_LEN) on the card
    whose prefill and decode calls record CUDA events and a finiteness
    flag of their logits in `eng.calls`."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, batch=LM_BATCH, max_len=LM_MAX_LEN,
                      device=torch.device("cuda"))
    eng.calls = []

    def wrap(kind, fn):
        def call(*args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            logits, cache = fn(*args)
            end.record()
            eng.calls.append((kind, start, end,
                              torch.isfinite(logits).all()))
            return logits, cache
        return call

    eng._prefill = wrap("prefill", eng._prefill)
    eng._decode = wrap("decode", eng._decode)
    return eng


def decode_profile(lm, params, dev) -> dict:
    """Where a decode step's time goes: a torch.profiler trace of
    PROFILE_STEPS decode steps at slot batch LM_BATCH over PROFILE_CACHED
    cached positions.  Per step: the device's busy time (all kernels), of
    which the flash-attention kernel's (this repo's own symbol), against
    the step's wall time under the profiler, which adds host time of its
    own; "not measured" if the trace holds no kernel.  Attention is every
    kernel of `csrc/flash_attention.cu` (one symbol per form), summed and
    by form."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        1, lm.cfg.vocab, (LM_BATCH, PROFILE_CACHED)).astype(np.int32))
    if lm.cfg.embed_input:   # frames in place of the prompt's tokens
        prompt = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (LM_BATCH, PROFILE_CACHED, lm.cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        logits, cache = lm.prefill(params, prompt.to(dev), LM_MAX_LEN)
        logits, cache = lm.decode_step(
            params, cache, torch.argmax(logits[:, 0], dim=-1)[:, None])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                logits, cache = lm.decode_step(
                    params, cache, torch.argmax(logits[:, 0], dim=-1)[:, None])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"steps": PROFILE_STEPS, "batch": LM_BATCH,
           "cached_positions": PROFILE_CACHED,
           "wall_ms_per_step_under_profiler": wall_ms}
    if not kernels:
        return out | {"device_busy_ms_per_step": "not measured"}

    def ms_per_step(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 \
            / PROFILE_STEPS

    busy = ms_per_step(kernels)
    by_form = {form: ms_per_step(e for e in kernels
                                 if f"flash_attention_{form}_kernel<" in e.name)
               for form in ATTN_FORMS}
    attention = sum(by_form.values())
    return out | {"device_busy_ms_per_step": busy,
                  "attention_ms_per_step": attention,
                  "attention_ms_per_step_by_form": by_form,
                  "other_device_ms_per_step": busy - attention,
                  "device_idle_share": 1.0 - busy / wall_ms,
                  "kernels_per_step": len(kernels) / PROFILE_STEPS}


def train_profile(step, state, batches) -> dict:
    """Where a training step's time goes: a torch.profiler trace of
    len(batches) steps from `state`.  Per step: the device's busy time
    (all kernels), by conv kernel (CONV_SYMBOLS) and the rest (autograd's
    elementwise ops, the loss, the SGD update), the device's idle share
    against the step's wall time under the profiler, which adds host time
    of its own; "not measured" if the trace holds no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"steps": len(batches), "wall_ms_per_step_under_profiler": wall_ms}
    if not kernels:
        return out | {"device_busy_ms_per_step": "not measured"}

    def ms_per_step(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 \
            / len(batches)

    busy = ms_per_step(kernels)
    by_kernel = {name: ms_per_step(
        e for e in kernels if re.search(rf"(?<![A-Za-z_]){sym}\b", e.name))
        for name, sym in CONV_SYMBOLS.items()}
    by_kernel = {k: v for k, v in by_kernel.items() if v}
    return out | {"device_busy_ms_per_step": busy,
                  "conv_kernel_ms_per_step": by_kernel,
                  "other_device_ms_per_step": busy - sum(by_kernel.values()),
                  "device_idle_share": 1.0 - busy / wall_ms,
                  "kernels_per_step": len(kernels) / len(batches)}


def calls_profile(call, n: int) -> dict:
    """A torch.profiler trace of `n` calls of `call`.  Per call: the
    device's busy time (every kernel and copy), the conv kernels' launches
    and ms by wrapper (CONV_SYMBOLS), all kernels, and the device's idle
    share against the wall time under the profiler.  Raises if the trace
    holds no kernel: the launch pin reads it.

    Late in a long process (after phase 6) every trace on the card lost
    its first two device events -- a one-replay trace showed 2 of the
    CNN step's 3 `dconv_forward` launches -- and an unpadded one-replay
    trace sometimes came back empty.  So each window opens with
    PROFILE_LEAD_IN spin kernels and a synchronize (the events lost are
    theirs; they are left out of every number here) and PROFILE_PAD_S of
    idle host time on each side of the timed calls.  A trace of the
    commit's few copies still came back empty once (with 8 spin
    kernels), so an empty trace is taken once more before it fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD_IN):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
            time.sleep(PROFILE_PAD_S)
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "spin_kernel" not in e.name]
        if kernels:
            break
        print(f"profile: trace {attempt + 1} holds no device event")
    if not kernels:
        raise AssertionError("the profiler's trace holds no device event")

    def conv(sym):
        return [e for e in kernels
                if re.search(rf"(?<![A-Za-z_]){sym}\b", e.name)]

    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    launches = {name: len(conv(sym)) / n for name, sym in CONV_SYMBOLS.items()}
    return {"calls": n, "wall_ms_per_call_under_profiler": wall_ms,
            "device_busy_ms_per_call": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "device_events_per_call": len(kernels) / n,
            "conv_launches_per_call": {k: v for k, v in launches.items()
                                       if v},
            "conv_kernel_ms_per_call": {
                name: sum(e.time_range.elapsed_us() for e in conv(sym))
                / 1e3 / n for name, sym in CONV_SYMBOLS.items()
                if launches[name]}}


def trainer_phase(card: str) -> dict:
    """Phase 7: ConvTrainer on the card, each workload of TRAINER_MODELS
    at the published widths, batch TRAIN_BATCH, TRAINER_STEPS steps:
    (a) a trainer's run (one capture, every step a replay) equals the
    eager `build_step` steps on the graph's stream, losses and state bit
    for bit; (b) TRAINER_CKPT_EVERY steps, then a fresh trainer resuming
    from the checkpoint, equal the straight run bit for bit; (c) a
    nan_output at attempt TRAINER_NAN_AT trips the flag on the device,
    is rolled back and retried, ends bit-equal to the straight run and
    blames named layers; (d) the straight run within TRAIN_TOL of the
    same trainer on the CPU; (e) one replay's trace launches each conv
    kernel as STEP_LAUNCHES says; (f) timings.  Returns the wrappers'
    launches counted over the (a) runs (warm-up and capture: a replay
    calls no wrapper)."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import tree_leaves, tree_paths
    from repro_torch.serve.faults import (FaultEvent, FaultInjector,
                                          FaultSchedule, train_site)
    from repro_torch.train.conv_trainer import (_BATCH_KEYS, ConvTrainer,
                                                ConvTrainerConfig)
    from repro_torch.train.step_graph import WARMUP_STEPS

    dev = torch.device("cuda")
    launches = {}

    def same(a, b) -> bool:
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))

    def losses(out):
        return [h["loss"] for h in out["history"]]

    with tempfile.TemporaryDirectory() as tmp:
        for workload, (step_name, widths) in TRAINER_MODELS.items():
            def cfg(**kw):
                return ConvTrainerConfig(**(dict(
                    workload=workload, total_steps=TRAINER_STEPS,
                    batch=TRAIN_BATCH, backend="cuda", lr=LR,
                    ckpt_every=TRAINER_CKPT_EVERY, seed=0) | widths | kw))

            def on_device(tr, i):
                b = tr.data.batch_at(i)
                return tuple(torch.from_numpy(b[k]).to(dev)
                             for k in _BATCH_KEYS[workload])

            # (a) the trainer against its eager steps.
            tr = ConvTrainer(cfg(), device=dev)
            ops.reset_launches()
            straight = tr.run()
            torch.cuda.synchronize()
            counted = {k: v for k, v in ops.LAUNCHES.items() if v}
            traced_steps = {k: (WARMUP_STEPS + 1) * v
                            for k, v in STEP_LAUNCHES[step_name].items()}
            if counted != traced_steps or tr.captures != 1:
                raise AssertionError(
                    f"trainer {workload}: {tr.captures} captures, wrapper "
                    f"launches {counted}, expected {traced_steps} (warm-up "
                    f"and one capture)")
            for k, v in counted.items():
                launches[k] = launches.get(k, 0) + v
            if [h["step"] for h in straight["history"]] != \
                    list(range(1, TRAINER_STEPS + 1)):
                raise AssertionError(f"trainer {workload}: history "
                                     f"{straight['history']}")
            step_fn = tr.build_step(guarded=True)
            lr = torch.tensor(LR, dtype=torch.float32, device=dev)
            state, eager_losses = tr.init_state(), []
            side = tr.graph.stream
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for i in range(TRAINER_STEPS):
                    state, metrics, finite = step_fn(state, on_device(tr, i),
                                                     lr)
                    eager_losses.append(metrics["loss"])
            torch.cuda.current_stream().wait_stream(side)
            eager_losses = [float(v) for v in eager_losses]
            if not same(straight["state"], state) or \
                    losses(straight) != eager_losses:
                raise AssertionError(
                    f"trainer {workload}: the replayed run is not bit-equal "
                    f"to the eager steps (losses {losses(straight)} vs "
                    f"{eager_losses})")

            # (b) resume from a checkpoint.
            d = os.path.join(tmp, workload)
            ConvTrainer(cfg(ckpt_dir=d, total_steps=TRAINER_CKPT_EVERY),
                        device=dev).run()
            resumed = ConvTrainer(cfg(ckpt_dir=d), device=dev).run()
            if resumed["start_step"] != TRAINER_CKPT_EVERY or not same(
                    resumed["state"], straight["state"]) or \
                    losses(resumed) != losses(straight)[TRAINER_CKPT_EVERY:]:
                raise AssertionError(f"trainer {workload}: the resumed run "
                                     f"is not bit-equal to the straight run")

            # (c) a NaN in the batch of attempt TRAINER_NAN_AT.
            inj = FaultInjector(FaultSchedule([FaultEvent(
                train_site(workload), TRAINER_NAN_AT, "nan_output")]))
            faulted_tr = ConvTrainer(cfg(), injector=inj, device=dev)
            faulted = faulted_tr.run()
            stats, blames = faulted["guard_stats"], faulted["blames"]
            leaf_names = {p for p, _ in tree_paths(straight["state"])}
            if stats["nonfinite_steps"] != 1 or stats["retries"] != 1 or \
                    faulted_tr.captures != 1 or len(blames) != 1 or \
                    blames[0]["step"] != TRAINER_NAN_AT or \
                    not blames[0]["grads"] or \
                    not set(blames[0]["grads"]) <= leaf_names or \
                    not same(faulted["state"], straight["state"]) or \
                    losses(faulted) != losses(straight):
                raise AssertionError(
                    f"trainer {workload}: NaN rollback: stats {stats}, "
                    f"blames {blames}, {faulted_tr.captures} captures")

            # (d) the same run on the CPU.
            on_cpu = ConvTrainer(cfg(), device="cpu").run()
            worst = 0.0
            for (path, a), (_, b) in zip(tree_paths(straight["state"]),
                                         tree_paths(on_cpu["state"])):
                a = a.cpu()
                if a.shape != b.shape or not torch.allclose(
                        a, b, atol=TRAIN_TOL, rtol=TRAIN_TOL):
                    raise AssertionError(
                        f"trainer {workload} {path}: max |err| "
                        f"{(a - b).abs().max().item():.3e} against the CPU")
                worst = max(worst, (a - b).abs().max().item())
            if not np.allclose(losses(straight), losses(on_cpu),
                               atol=TRAIN_TOL, rtol=TRAIN_TOL):
                raise AssertionError(f"trainer {workload}: losses "
                                     f"{losses(straight)} against the CPU's "
                                     f"{losses(on_cpu)}")

            # (e) one replay's conv launches, by kernel symbol.
            graph = tr.graph

            def replay():
                graph.run(LR)

            one = calls_profile(replay, 1)
            if one["conv_launches_per_call"] != STEP_LAUNCHES[step_name]:
                raise AssertionError(
                    f"trainer {workload}: one replay launched "
                    f"{one['conv_launches_per_call']}, expected "
                    f"{STEP_LAUNCHES[step_name]}")
            print("trainer " + json.dumps({
                "workload": workload, "step": step_name,
                "batch": TRAIN_BATCH, "steps": TRAINER_STEPS,
                "captures": tr.captures, "wrapper_launches": counted,
                "launches_per_replay": one["conv_launches_per_call"],
                "losses": losses(straight),
                "replay_equals_eager": True, "resume_equals_straight": True,
                "nan_rollback": {"guard": stats, "blame": blames[0]["grads"]},
                "max_abs_err_vs_cpu": worst, "tol": TRAIN_TOL,
                "card": card}))

            # (f) timings: eager steps and replays with the batch on the
            # card (host clock to a synchronize), their traces, and the
            # loop with batch_at on the host.
            data, state = on_device(tr, 0), graph.state

            def eager():
                step_fn(state, data, lr)

            timing = {"workload": workload, "batch": TRAIN_BATCH}
            for name, call in (("eager", eager), ("replay", replay)):
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(TRAINER_TIMED):
                    call()
                torch.cuda.synchronize()
                timing[f"{name}_ms_per_step"] = \
                    (time.perf_counter() - t0) * 1e3 / TRAINER_TIMED
                prof = calls_profile(call, TRAINER_PROFILED)
                timing[f"{name}_profile"] = {
                    k: prof[k] for k in ("wall_ms_per_call_under_profiler",
                                         "device_busy_ms_per_call",
                                         "device_idle_share",
                                         "device_events_per_call")}
            timing["commit_device_ms"] = calls_profile(
                lambda: graph.commit(graph.outputs[0]),
                TRAINER_PROFILED)["device_busy_ms_per_call"]
            for name in ("eager", "replay"):   # against the unprofiled ms
                busy = timing[f"{name}_profile"]["device_busy_ms_per_call"]
                timing[f"{name}_device_busy_ms"] = busy
                timing[f"{name}_idle_share"] = \
                    1.0 - busy / timing[f"{name}_ms_per_step"]
            starts, batch_ms = [], []
            batch_at = tr.data.batch_at

            def timed_batch_at(step):
                t0 = time.perf_counter()
                starts.append(t0)
                out = batch_at(step)
                batch_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            tr.data.batch_at = timed_batch_at
            loop = tr.run()       # the same trainer: a restore, no capture
            loop_end = time.perf_counter()
            del tr.data.batch_at
            if tr.captures != 1 or not same(loop["state"], straight["state"]):
                raise AssertionError(f"trainer {workload}: a second run of "
                                     f"the trainer captured again or "
                                     f"changed its result")
            timing["loop_ms_per_step"] = \
                (loop_end - starts[0]) * 1e3 / TRAINER_STEPS
            timing["batch_at_ms"] = sum(batch_ms) / len(batch_ms)
            timing["captures"] = tr.captures
            print("trainer timing " + json.dumps(timing | {"card": card}))
    print(f"trainer: {', '.join(TRAINER_MODELS)} at batch {TRAIN_BATCH}: "
          f"{TRAINER_STEPS} replayed steps equal the eager steps bit for "
          f"bit, resume and NaN rollback equal the straight run bit for bit, "
          f"the CPU within {TRAIN_TOL:g}, one capture per trainer, "
          f"{'/'.join(str(sum(STEP_LAUNCHES[s].values())) for s, _ in TRAINER_MODELS.values())} "
          f"conv launches per replay")
    return launches


def vision_phase(card: str) -> dict:
    """Phase 8, in fp32 at full width: (a) ATROUS_STEPS steps of
    `examples.segment_atrous`'s step (the atrous loss's gradients, AdamW,
    the post-update logits' pixel accuracy) on the serving slice's head
    at batch ATROUS_BATCH, ATROUS_SIZE^2; (b) patchify (S = K = PATCH,
    PATCH_SIZE^2 RGB, d_model PATCH_D_MODEL, batch PATCH_BATCH): the
    embeddings, then PATCH_STEPS steps of sum(out^2)'s gradient and
    AdamW.  Each step: launches as VISION_LAUNCHES says, loss and every
    param, moment and gradient within TRAIN_TOL of the same step on the
    CPU, no NaN (a patchify step from the card's state, its AdamW on the
    card's gradients); step 1 rerun bit for bit.  (c) The planner: autotune
    into a temporary artifact at the generator's t1-t3 (B = 4 and 64) and
    the input gradients of paper_layers(), each point's two arms beside the
    analytical pick (a miss: the pick's arm more than MISS_RATIO slower);
    a second resolution replays with zero runner calls;
    ConvServeEngine.warmup finds every serving launch in the artifact;
    each corrupt_tile_cache mode warns and re-plans.  (d) ms per step
    (host clock to a synchronize), device-busy ms, idle share and ms by
    conv kernel (a profiler trace).  Returns the wrappers' launches of
    the (a) and (b) steps on the card."""
    import shutil
    import warnings

    from repro_torch.core.spec import ConvSpec, Epilogue
    from repro_torch.examples import segment_atrous as seg
    from repro_torch.kernels import ops, tiling
    from repro_torch.models import gan, vision
    from repro_torch.models.layers import (sgd_grads, tree_leaves, tree_map,
                                           tree_paths)
    from repro_torch.optim import optimizer as optim
    from repro_torch.serve.conv_engine import ConvServeEngine
    from repro_torch.serve.faults import corrupt_tile_cache

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    launches = {}

    def counted(what, table):
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        if got != table:
            raise AssertionError(f"{what}: launches {got}, expected {table}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    def hold(what, got, want) -> float:
        worst = 0.0
        for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
            a, b = a.to(cpu).double(), b.double()
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{what} {path}: a non-finite value on "
                                     f"the card")
            if a.shape != b.shape or not torch.allclose(
                    a, b, atol=TRAIN_TOL, rtol=TRAIN_TOL):
                raise AssertionError(f"{what} {path}: max |err| "
                                     f"{(a - b).abs().max().item():.3e} "
                                     f"against the CPU")
            worst = max(worst, (a - b).abs().max().item())
        return worst

    def rerun_equal(what, first, again):
        if not all(torch.equal(a, b) for a, b in zip(tree_leaves(first),
                                                     tree_leaves(again))):
            raise AssertionError(f"{what}: step 1 rerun on the card is not "
                                 f"bit-identical")

    # (a) the atrous head, trained as the example trains it.
    ocfg = optim.AdamWConfig(**ATROUS_OPT)
    step = seg.make_step(ocfg)
    head = vision.atrous_head_init(torch.Generator().manual_seed(8),
                                   device=cpu)   # 3 -> 16 x (1, 2, 4) -> 4
    on_cpu = (head, optim.adamw_init(head, ocfg))
    on_card = tree_map(lambda t: t.to(dev), on_cpu)
    worst = 0.0
    for i in range(ATROUS_STEPS):
        x, y = seg.synth_batch(i, batch=ATROUS_BATCH, size=ATROUS_SIZE)
        xd, yd = x.to(dev), y.to(dev)
        ops.reset_launches()
        out = step(*on_card, xd, yd)
        torch.cuda.synchronize()
        counted(f"atrous step {i + 1}", VISION_LAUNCHES["segment_atrous_step"])
        if i == 0:
            rerun_equal("atrous", out, step(*on_card, xd, yd))
        want = step(*on_cpu, x, y)
        worst = max(worst, hold(f"atrous step {i + 1}", out, want))
        on_card, on_cpu = out[:2], want[:2]
        print(f"vision atrous step {i + 1}: loss {float(out[2]):.6f}, "
              f"pixel accuracy {float(out[3]):.6f}")
    print("vision atrous " + json.dumps({
        "batch": ATROUS_BATCH, "size": ATROUS_SIZE, "steps": ATROUS_STEPS,
        "launches_per_step": VISION_LAUNCHES["segment_atrous_step"],
        "max_abs_err_vs_cpu": worst, "tol": TRAIN_TOL, "card": card}))
    atrous_state, atrous_batch = on_card, (xd, yd)

    # (b) patchify: the embeddings, then sum(out^2)'s gradient and AdamW.
    pcpu = vision.patchify_init(torch.Generator().manual_seed(9),
                                patch=PATCH, d_model=PATCH_D_MODEL,
                                device=cpu)
    img = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (PATCH_BATCH, PATCH_SIZE, PATCH_SIZE, 3)).astype(np.float32))
    imgd = img.to(dev)

    def patch_grads(params, images):
        return sgd_grads(lambda q: torch.sum(vision.patchify_apply(
            q, images, patch=PATCH, backend="cuda") ** 2), params)

    def patch_step(params, opt_state, images):
        loss, grads = patch_grads(params, images)
        params, opt_state, _ = optim.adamw_update(grads, opt_state, params,
                                                  ocfg)
        return params, opt_state, loss, grads

    with torch.no_grad():
        ops.reset_launches()
        emb = vision.patchify_apply(tree_map(lambda t: t.to(dev), pcpu),
                                    imgd, patch=PATCH, backend="cuda")
        torch.cuda.synchronize()
        counted("patchify forward", {"dconv_forward": 1})
        want = vision.patchify_apply(pcpu, img, patch=PATCH, backend="cuda")
    tokens = (PATCH_SIZE // PATCH) ** 2
    if tuple(emb.shape) != (PATCH_BATCH, tokens, PATCH_D_MODEL):
        raise AssertionError(f"patchify: embeddings {tuple(emb.shape)}")
    pworst = hold("patchify forward", emb, want)
    # Each step starts the CPU from the card's state, and the CPU's AdamW
    # takes the card's gradients: AdamW's first steps move every weight by
    # about +-lr, the sign of its gradient, so a gradient entry within
    # rounding of zero (of 600k) would flip a whole +-lr step between the
    # two sides, and the flip would carry on.
    on_card = tree_map(lambda t: t.to(dev), (pcpu,
                                             optim.adamw_init(pcpu, ocfg)))
    for i in range(PATCH_STEPS):
        ops.reset_launches()
        out = patch_step(*on_card, imgd)
        torch.cuda.synchronize()
        counted(f"patchify step {i + 1}", VISION_LAUNCHES["patchify"])
        if i == 0:
            rerun_equal("patchify", out, patch_step(*on_card, imgd))
        params, opt_state = tree_map(lambda t: t.to(cpu), on_card)
        loss, grads = patch_grads(params, img)
        pworst = max(pworst, hold(f"patchify step {i + 1} gradients",
                                  out[2:], (loss, grads)))
        want = optim.adamw_update(tree_map(lambda t: t.to(cpu), out[3]),
                                  opt_state, params, ocfg)[:2]
        pworst = max(pworst, hold(f"patchify step {i + 1} AdamW", out[:2],
                                  want))
        on_card = out[:2]
        print(f"vision patchify step {i + 1}: loss {float(out[2]):.6e}")
    print("vision patchify " + json.dumps({
        "batch": PATCH_BATCH, "size": PATCH_SIZE, "patch": PATCH,
        "d_model": PATCH_D_MODEL, "tokens": tokens, "steps": PATCH_STEPS,
        "launches_per_step": VISION_LAUNCHES["patchify"],
        "max_abs_err_vs_cpu": pworst, "tol": TRAIN_TOL, "card": card}))
    patch_state = on_card

    # (c) the planner.
    gen_spec = ConvSpec.make(stride=2, padding=1, filter_shape=4)
    points = [(f"{name}_B{b}", gen_spec, (b, *n_out, cin), (b, *in_hw, cout),
               Epilogue(activation=act))
              for b in (SLOT_BATCH, TRAIN_BATCH)
              for name, in_hw, n_out, cin, cout, act in GEN_TCONVS]
    points += [(name, paper_spec(n, o, k, s, d), (PAPER_BATCH, n, n, cin),
                (PAPER_BATCH, o, o, m), None)
               for name, cin, n, o, k, m, s, d in paper_layers()]
    runner_calls = [0]
    runners = dict(tiling._RUNNERS)

    def counting(factory):
        def make(*args, **kw):
            run = factory(*args, **kw)

            def call(plan):
                runner_calls[0] += 1
                return run(plan)
            return call
        return make

    def forget():
        tiling._MEM_CACHE.clear()
        tiling._MEM_STRATEGY.clear()

    tiling._RUNNERS.update({k: counting(f) for k, f in runners.items()})
    try:
        with tempfile.TemporaryDirectory() as tmp:
            art = Path(tmp) / "tiles.json"
            t0 = time.perf_counter()
            tuned, misses = {}, []
            for name, spec, xs, ds, ep in points:
                kw = dict(x_shape=xs, dy_shape=ds, epilogue=ep)
                tuned[name] = tiling.plan_strategy(
                    "input_grad", spec, mode="autotune",
                    tile_cache_path=art, **kw)
                pick = tiling.plan_strategy("input_grad", spec,
                                            mode="analytical", **kw)[0]
                row = json.loads(art.read_text())[tiling._cache_key(
                    "input_grad", spec, xs, ds, ep, "auto")]
                arms = row["arms_us"]
                other = "phase" if pick == "implicit_gemm" else \
                    "implicit_gemm"
                miss = pick in arms and other in arms and \
                    arms[pick] > MISS_RATIO * arms[other]
                if miss:
                    misses.append(name)
                print("planner race " + json.dumps({
                    "point": name, "x_shape": xs, "dy_shape": ds,
                    "stride": spec.stride, "dilation": spec.dilation,
                    "arms_us": arms, "autotune_pick": tuned[name][0],
                    "analytical_pick": pick,
                    "model_us": tiling.race_costs_us(spec, xs, ds, ep),
                    "miss": miss, "card": card}))
            sweep_s = time.perf_counter() - t0
            forget()
            runner_calls[0] = 0
            for name, spec, xs, ds, ep in points:
                again = tiling.plan_strategy(
                    "input_grad", spec, x_shape=xs, dy_shape=ds, epilogue=ep,
                    mode="autotune", tile_cache_path=art)
                if again != tuned[name]:
                    raise AssertionError(f"planner: {name} replayed as "
                                         f"{again}, tuned {tuned[name]}")
            if runner_calls[0]:
                raise AssertionError(f"planner: the replay made "
                                     f"{runner_calls[0]} runner calls")

            # The serving buckets: the generator's launches are tuned
            # above; the atrous head's forwards are tuned here.
            gp = gan.generator_init(torch.Generator().manual_seed(1234),
                                    device=dev)
            ap = vision.atrous_head_init(torch.Generator().manual_seed(1234),
                                         device=dev)
            aspp = vision.atrous_plan_requests(
                ap, (SLOT_BATCH, ATROUS_SIZE, ATROUS_SIZE, 3))
            for op, spec, xs, ds, ep in aspp:
                tiling.plan_tiles(op, spec, x_shape=xs, dy_shape=ds,
                                  epilogue=ep, mode="autotune",
                                  tile_cache_path=art)
            forget()
            eng = ConvServeEngine(gan_params=gp, aspp_params=ap,
                                  slot_batch=SLOT_BATCH, device=dev,
                                  tile_cache_path=art)
            summary = eng.warmup([("gan_gen", (64,)),
                                  ("aspp", (ATROUS_SIZE, ATROUS_SIZE, 3))])
            if summary["artifact"] != summary["plans"] or \
                    summary["analytical"]:
                raise AssertionError(f"engine warmup: {summary}")

            # Each corruption of the artifact warns and re-plans.
            entries = [("input_grad", spec, xs, ds, ep)
                       for _, spec, xs, ds, ep in points] + aspp
            by_key = {tiling._cache_key(op, spec, xs, ds, ep, st): (
                op, spec, xs, ds, ep) for op, spec, xs, ds, ep in entries
                for st in ("auto", "phase")}
            corrupted = {}
            for mode in ("truncate", "garbage", "torn_row"):
                bad = Path(tmp) / f"{mode}.json"
                shutil.copy(art, bad)
                corrupt_tile_cache(bad, mode, seed=0)
                forget()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    plans = tiling.warmup_plans(entries,
                                                tile_cache_path=bad)
                    if mode == "torn_row":
                        torn = [k for k, v in json.loads(
                            bad.read_text()).items()
                            if v == {"cin_tile": "not-an-int"}]
                        op, spec, xs, ds, ep = by_key[torn[0]]
                    else:
                        op, spec, xs, ds, ep = entries[2]   # gan_t3_B4
                    tiling.plan_strategy(op, spec, x_shape=xs, dy_shape=ds,
                                         epilogue=ep, mode="autotune",
                                         tile_cache_path=bad)
                if not any(issubclass(w.category, RuntimeWarning)
                           for w in caught):
                    raise AssertionError(f"corrupt_tile_cache {mode}: no "
                                         f"warning")
                json.loads(bad.read_text())        # re-planned and rewritten
                corrupted[mode] = {
                    "warnings": len(caught),
                    "analytical": sum(v["source"] == "analytical"
                                      for v in plans.values()),
                    "artifact": sum(v["source"] == "artifact"
                                    for v in plans.values())}
    finally:
        tiling._RUNNERS.update(runners)
        forget()
    print("planner " + json.dumps({
        "points": len(points), "sweep_s": sweep_s, "misses": misses,
        "replay_runner_calls": 0, "engine_warmup": summary,
        "corrupt": corrupted, "card": card}))

    # (d) timings, eager, batch on the card.
    def atrous_call():
        step(*atrous_state, *atrous_batch)

    def patch_call():
        patch_step(*patch_state, imgd)

    for name, call, batch in (("atrous", atrous_call, ATROUS_BATCH),
                              ("patchify", patch_call, PATCH_BATCH)):
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VISION_TIMED):
            call()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / VISION_TIMED
        prof = calls_profile(call, 3)
        print("vision timing " + json.dumps({
            "workload": name, "batch": batch, "ms_per_step": ms,
            "device_busy_ms": prof["device_busy_ms_per_call"],
            "idle_share": 1.0 - prof["device_busy_ms_per_call"] / ms,
            "conv_kernel_ms": prof["conv_kernel_ms_per_call"],
            "conv_launches": prof["conv_launches_per_call"],
            "device_events": prof["device_events_per_call"],
            "card": card}))
    print(f"vision: {ATROUS_STEPS} atrous steps at batch {ATROUS_BATCH} and "
          f"{PATCH_STEPS} patchify steps at batch {PATCH_BATCH} equal the "
          f"CPU within {TRAIN_TOL:g}, step 1 bit for bit; the planner "
          f"replayed {len(points)} points with no runner call, the engine "
          f"warmed up from the artifact, every corruption re-planned")
    return launches


def lm_step_profile(call) -> dict:
    """Where one LM training step's device time goes: a torch.profiler
    trace of one `call()` (opened as `calls_profile` opens its windows).
    Device ms by group -- the attention forward by form, the attention
    backward's three kernels, cuBLAS / CUTLASS matrix products, the rest
    -- the ten costliest kernel names, and the device's busy share of
    the step's wall time under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD_IN):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.name]
    if not kernels:
        raise AssertionError("the profiler's trace holds no device event")
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3

    def group(name):
        for form in ATTN_FORMS:
            if f"flash_attention_{form}_kernel<" in name:
                return f"attention_forward_{form}"
        for sym in ATTN_BWD_SYMBOLS:
            if sym in name:
                return sym
        if re.search(r"gemm|nvjet|xmma|cutlass|sm90_", name):
            return "matmul"
        return "other"

    groups: dict = {}
    for name, ms in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms_under_profiler": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "device_idle_share": 1.0 - busy / wall_ms,
            "device_events": len(kernels), "ms_by_group": groups,
            "top_kernels_ms": [[n[:120], ms] for n, ms in top]}


def hold_grads(what, loss, want_loss, grads, want, tol) -> float:
    """The loss within `tol` (relative) of `want_loss` and every gradient
    leaf finite and within `tol` of the CPU's leaf's largest magnitude
    (atol; rtol the same).  Returns the worst error as a share of that
    magnitude.  Each CPU leaf is copied to the gradient's device and held
    there: on the host of an H100 machine these passes took 6.8-33.0 s a
    model at phases 11 and 12's sizes (PERF.md)."""
    from repro_torch.models.layers import tree_paths

    worst = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    if worst > tol:
        raise AssertionError(f"{what}: loss {loss.item()} vs "
                             f"{want_loss.item()}")
    for (path, g), (_, w) in zip(tree_paths(grads), tree_paths(want)):
        w = w.to(g.device)
        big = w.abs().max().item()
        if not bool(torch.isfinite(g).all()) or not torch.allclose(
                g, w, rtol=tol, atol=tol * big):
            raise AssertionError(
                f"{what}: gradient {path}: max |err| "
                f"{(g - w).abs().max().item():.3e}, largest |grad| "
                f"{big:.3e}")
        worst = max(worst, (g - w).abs().max().item() / max(big, 1e-30))
    return worst


def train_run(what, cfg, steps: int, seed: int, traced: bool,
              checkpoint: bool = False) -> dict:
    """`launch/train`'s path: `Trainer.run` on the card at seq
    LM_TRAIN_SEQ, global batch LM_TRAIN_BATCH in the config's
    microbatches, `steps` steps (the first a warm-up), with `checkpoint` a
    checkpoint directory that must hold the last step.  Every loss
    finite; every step 2 x attention layers x microbatches
    `flash_attention` launches and attention layers x microbatches
    `flash_attention_backward` calls, all on the forms `attention.plan`
    and `backward_plan` give the microbatch's shape; with `traced` one
    more step traced (`lm_step_profile`); the MoE aux loss of the final
    params on one microbatch; a rerun (no checkpoint directory) whose
    losses must be bit-equal.  Returns the run's numbers, launches and
    profile."""
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.kernels import ops
    from repro_torch.kernels.attention import backward_plan, plan
    from repro_torch.launch.steps import precast
    from repro_torch.models.lm import LM
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    ds = TokenDataset(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                      global_batch=LM_TRAIN_BATCH, seed=0,
                      embed_dim=cfg.d_model if cfg.embed_input else None)

    def trainer(ckpt_dir=None):
        return Trainer(cfg, ds, AdamWConfig(
            lr=3e-4, warmup_steps=1, total_steps=steps), TrainerConfig(
            total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=10 * steps,
            log_every=1, keep_last=1, seed=seed), device=dev)

    timed_steps = []
    counts = (ops.LAUNCHES, ops.FLASH_FORMS, ops.FLASH_BWD_FORMS)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tr = trainer(ckpt_dir if checkpoint else None)
        n_micro, step_fn = tr.n_micro, tr.step_fn

        def timed_step(params, opt, b):
            torch.cuda.synchronize()
            before = [dict(c) for c in counts]
            t0 = time.perf_counter()
            out = step_fn(params, opt, b)
            torch.cuda.synchronize()
            timed_steps.append({"ms": (time.perf_counter() - t0) * 1e3} | dict(
                zip(("launches", "forms", "backward_forms"),
                    ({k: c[k] - was[k] for k in was if c[k] - was[k]}
                     for c, was in zip(counts, before)))))
            return out

        tr.step_fn = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        saved = sorted(os.listdir(ckpt_dir))
    if checkpoint and f"step_{steps}" not in saved:
        raise AssertionError(f"{what}: checkpoint directory holds {saved}")
    n_attn = attention_layers(cfg)
    per_step = {"flash_attention": 2 * n_attn * n_micro,
                "flash_attention_backward": n_attn * n_micro}
    shape = (cfg.compute_dtype, LM_TRAIN_BATCH // n_micro, LM_TRAIN_SEQ,
             LM_TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    forms = ({plan(*shape).form: per_step["flash_attention"]},
             {backward_plan(*shape): per_step["flash_attention_backward"]})
    for i, st in enumerate(timed_steps):
        if st["launches"] != per_step or \
                (st["forms"], st["backward_forms"]) != forms:
            raise AssertionError(
                f"{what} step {i + 1}: launches {st['launches']}, forms "
                f"{st['forms']} / {st['backward_forms']}, expected "
                f"{per_step}, {forms}")
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses {losses}")
    prof = None
    if traced:
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in ds.batch(steps).items()}
        prof = lm_step_profile(lambda: step_fn(out["params"], out["opt"], b))
    aux = None
    if cfg.n_experts:
        b = ds.batch(0)
        mb = LM_TRAIN_BATCH // n_micro
        with torch.no_grad():
            _, parts = LM(cfg).loss(
                precast(out["params"], cfg.compute_dtype),
                torch.from_numpy(b["inputs"][:mb]).to(dev),
                torch.from_numpy(b["labels"][:mb]).to(dev))
        aux = float(parts["aux"])
    del out, tr
    gc.collect()
    torch.cuda.empty_cache()
    rerun = [h["loss"] for h in trainer().run()["history"]]
    gc.collect()
    torch.cuda.empty_cache()
    if rerun != losses:
        raise AssertionError(f"{what}: a rerun's losses {rerun} differ "
                             f"from {losses}")
    timed = [st["ms"] for st in timed_steps[1:]]
    ms = sum(timed) / len(timed)
    return {"row": {
        "n_layers": cfg.n_layers, "dtype": cfg.dtype, "seq": LM_TRAIN_SEQ,
        "global_batch": LM_TRAIN_BATCH, "microbatches": n_micro,
        "remat": cfg.remat, "steps": steps, "losses": losses,
        "rerun_losses": rerun, "ms_per_step_warmup": timed_steps[0]["ms"],
        "ms_per_step_timed": timed, "ms_per_step": ms,
        "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / ms * 1e3,
        "peak_memory_gb": peak / 1e9, "aux_loss": aux,
        "launches_per_step": per_step, "forms_per_step": forms[0],
        "backward_forms_per_step": forms[1], "run_s": run_s,
        "checkpoint_and_loop_s": run_s - sum(
            st["ms"] for st in timed_steps) / 1e3},
        "launches": launches, "profile": prof}


def lm_train_phase(card: str) -> dict:
    """Phase 9: LM training on the card.  (a) LM_ARCH at its published
    widths but PARITY_LAYERS layers, params from a numpy seed, batch x seq
    LM_TRAIN_PARITY: `LM.loss` and every gradient (`launch.steps.
    loss_and_grads`, remat "full") on the card against the CPU's, in fp32
    and in bf16, each leaf within LM_TRAIN_TOL of its largest |gradient|
    (atol; rtol the same); the attention forward launched twice per layer
    (the remat recompute) and its backward once.  (b) `launch/train`'s
    path (`train_run`): the whole LM_ARCH (28 layers, bf16 compute, fp32
    master), LM_TRAIN_STEPS steps with a checkpoint directory, in the
    config's 4 microbatches: every step 2 x 28 x 4 `flash_attention`
    launches and 28 x 4 `flash_attention_backward` calls, all on the
    wgmma forms; ms per step, tokens/s, peak memory, one more step traced
    (ms by kernel group, device-busy share), and a rerun whose losses must
    be bit-equal.  Returns (b)'s launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.layers import tree_map, tree_paths
    from repro_torch.models.lm import LM

    dev = torch.device("cuda")
    full = get_config(LM_ARCH)

    # (a) parity of the loss and every gradient, fp32 and bf16.
    B, S = LM_TRAIN_PARITY
    batch = TokenDataset(vocab=full.vocab, seq_len=S, global_batch=B,
                         seed=21).batch(0)
    labels = batch["labels"].copy()
    labels[0, :7] = -1                     # masked positions
    rng = np.random.default_rng(22)
    pcfg = full.scaled(n_layers=PARITY_LAYERS)
    with torch.device("meta"):
        shapes = LM(pcfg).init_tree(torch.Generator())

    def draw(t):
        scale = (1.0 if t.shape == (pcfg.vocab, pcfg.d_model) else
                 1.0 / math.sqrt(t.shape[1]) if t.dim() == 3 else 0.1)
        return torch.from_numpy(
            (scale * rng.standard_normal(t.shape)).astype(np.float32))

    cpu_params = tree_map(draw, shapes)
    dev_params = tree_map(lambda t: t.to(dev), cpu_params)
    parity = {}
    for dtype in ("float32", "bfloat16"):
        lm = LM(pcfg.scaled(dtype=dtype))
        ops.reset_launches()
        (loss, _), grads = loss_and_grads(
            lm, dev_params, torch.from_numpy(batch["inputs"]).to(dev),
            torch.from_numpy(labels).to(dev))
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        want_l = {"flash_attention": 2 * PARITY_LAYERS,
                  "flash_attention_backward": PARITY_LAYERS}
        if launches != want_l:
            raise AssertionError(f"lm train parity {dtype}: launches "
                                 f"{launches}, expected {want_l}")
        (want_loss, _), want = loss_and_grads(
            lm, cpu_params, torch.from_numpy(batch["inputs"]),
            torch.from_numpy(labels))
        tol = LM_TRAIN_TOL[dtype]
        worst = hold_grads(f"lm train parity {dtype}", loss, want_loss,
                           grads, want, tol)
        parity[dtype] = {"loss": loss.item(), "cpu_loss": want_loss.item(),
                         "max_err_of_leaf_max": worst, "tol": tol,
                         "launches": launches}
    print("lm train parity " + json.dumps({
        "arch": LM_ARCH, "n_layers": PARITY_LAYERS, "batch": B, "seq": S,
        "leaves": len(tree_paths(cpu_params))} | parity))
    del cpu_params, dev_params, grads, want

    # (b) launch/train's path: the whole model through Trainer.run.
    run = train_run("lm train", full, LM_TRAIN_STEPS, 0, True,
                    checkpoint=True)
    row, per_step = run["row"], run["row"]["launches_per_step"]
    if row["microbatches"] != 4 or set(row["forms_per_step"]) != {"wgmma"} \
            or set(row["backward_forms_per_step"]) != {"wgmma"}:
        raise AssertionError(f"lm train: {row['microbatches']} microbatches "
                             f"at global batch {LM_TRAIN_BATCH}, forms "
                             f"{row['forms_per_step']} / "
                             f"{row['backward_forms_per_step']}, expected 4, "
                             f"all on wgmma")
    print("lm train " + json.dumps({"arch": LM_ARCH} | row | {"card": card}))
    print("lm train profile " + json.dumps(run["profile"] | {"card": card}))
    print(f"lm train: {PARITY_LAYERS}-layer {LM_ARCH} loss and every "
          f"gradient equal the CPU (fp32 {LM_TRAIN_TOL['float32']:g}, bf16 "
          f"{LM_TRAIN_TOL['bfloat16']:g} of each leaf's max); the whole "
          f"model trained {LM_TRAIN_STEPS} steps at seq {LM_TRAIN_SEQ}, "
          f"batch {LM_TRAIN_BATCH}, {per_step['flash_attention']} "
          f"flash_attention and {per_step['flash_attention_backward']} "
          f"backward launches per step, all on wgmma, losses finite and "
          f"bit-equal in a rerun")
    return run["launches"]


def cache_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for k, t in cache.items()
               if k != "len")


def int8_serve_phase(card: str, params=None, bf16_run=None) -> dict:
    """Phase 10 (a) and (b): the int8 KV cache.  (a) qwen3-0.6b at full
    width, PARITY_LAYERS layers, fp32, `kv_quant`: phase 6 (a)'s prompts
    and forced tokens on the card against the CPU.  Each call's logits
    within PARITY_TOL of the same call on the CPU from a copy of the
    card's cache; the cache against the CPU's own run: codes at most 1
    apart (the count that differ printed), scales within KV_SCALE_RTOL.
    (A value at a rounding tie quantizes one way on the card and the
    other on the CPU, and later calls read the codes, so the CPU's own
    run is held by its cache and its logits' distance only printed.)
    One launch per layer per call, the prefill on `tile` and every
    decode on `split`.  (b) the
    whole model in bf16 on `params` (phase 6's): the first decode's
    softmax after a prefill of the first LM_BATCH requests against the
    bf16 cache's (max abs within SOFTMAX_TOL), both caches' bytes, then
    phase 6 (b)'s requests through ServeEngine: the serving numbers, the
    share of greedy tokens equal to `bf16_run`'s (phase 6's first run),
    the decode profile.  Returns (b)'s serving launches.  Alone (no
    `params`), it draws phase 6's params and makes the bf16 run itself."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.layers import tree_map
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Request

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    full = get_config(LM_ARCH)
    if params is None:
        params = LM(full).init(torch.Generator().manual_seed(1), device=dev)
        instrumented_engine(full, params).generate([Request(
            uid=0, prompt=np.arange(1, 200, dtype=np.int32),
            max_new_tokens=3)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = instrumented_engine(full, params).generate(
            lm_requests(full.vocab))
        bf16_run = {"res": res, "peak": torch.cuda.max_memory_allocated()}

    # (a) 2 layers at full width in fp32: the card against the CPU.
    plm = LM(full.scaled(n_layers=PARITY_LAYERS, dtype="float32",
                         kv_quant=True))
    cpu_params, lens, toks, forced, max_len = lm_parity_inputs(plm)
    dev_params = tree_map(lambda t: t.to(dev), cpu_params)
    worst = {"logits": 0.0, "logits_own_cache": 0.0, "scale_rel": 0.0}
    ops.reset_launches()
    with torch.no_grad():
        out = plm.prefill(dev_params, torch.from_numpy(toks).to(dev), max_len)
        want = plm.prefill(cpu_params, torch.from_numpy(toks), max_len)
        same = want
        for step in range(PARITY_DECODES + 1):
            what = "prefill" if step == 0 else f"decode {step}"
            got = out[0].to(cpu)
            if not bool(torch.isfinite(got).all()) or not torch.allclose(
                    got, same[0], atol=PARITY_TOL, rtol=PARITY_TOL):
                raise AssertionError(
                    f"kv parity {what}: logits max |err| "
                    f"{(got - same[0]).abs().max().item():.3e} against "
                    f"the same call on the CPU")
            worst["logits"] = max(worst["logits"],
                                  (got - same[0]).abs().max().item())
            worst["logits_own_cache"] = max(
                worst["logits_own_cache"], (got - want[0]).abs().max().item())
            for k in ("k", "v"):
                d = (out[1][k].to(cpu).int() - want[1][k].int()).abs()
                if out[1][k].dtype != torch.int8 or d.max().item() > 1:
                    raise AssertionError(f"kv parity {what}: cache {k} is "
                                         f"{out[1][k].dtype}, codes up to "
                                         f"{d.max().item()} apart")
            for k in ("k_scale", "v_scale"):
                g, w = out[1][k].to(cpu), want[1][k]
                rel = ((g - w).abs() / w.abs().clamp_min(1e-30)).max().item()
                if rel > KV_SCALE_RTOL:
                    raise AssertionError(f"kv parity {what}: {k} relative "
                                         f"err {rel:.3e}")
                worst["scale_rel"] = max(worst["scale_rel"], rel)
            if out[1]["len"] != want[1]["len"]:
                raise AssertionError(f"kv parity {what}: cache len")
            if step < PARITY_DECODES:
                tok = torch.from_numpy(forced[step].astype(np.int32))
                held = {k: v.to(cpu) if torch.is_tensor(v) else v
                        for k, v in out[1].items()}
                out = plm.decode_step(dev_params, out[1], tok.to(dev))
                same = plm.decode_step(cpu_params, held, tok)
                want = plm.decode_step(cpu_params, want[1], tok)
    differ = sum(int((out[1][k].to(cpu) != want[1][k]).sum())
                 for k in ("k", "v"))
    live = 2 * PARITY_LAYERS * LM_BATCH * out[1]["len"] * \
        full.n_kv_heads * full.head_dim
    if ops.LAUNCHES["flash_attention"] != PARITY_LAYERS * (
            1 + PARITY_DECODES):
        raise AssertionError(f"kv parity: {ops.LAUNCHES['flash_attention']} "
                             f"flash_attention launches, expected one per "
                             f"layer per call")
    forms = {"tile": PARITY_LAYERS, "wgmma": 0,
             "split": PARITY_LAYERS * PARITY_DECODES}
    if ops.FLASH_FORMS != forms:
        raise AssertionError(f"kv parity: flash_attention forms "
                             f"{ops.FLASH_FORMS}, expected {forms}")
    print("kv parity " + json.dumps({
        "arch": LM_ARCH, "n_layers": PARITY_LAYERS, "dtype": "float32",
        "kv_quant": True, "prompt_lens": lens.tolist(),
        "decode_steps": PARITY_DECODES,
        "logits_max_abs_err_vs_cpu": worst["logits"], "tol": PARITY_TOL,
        "logits_max_abs_err_vs_cpu_own_cache": worst["logits_own_cache"],
        "scale_max_rel_err_vs_cpu": worst["scale_rel"],
        "scale_rtol": KV_SCALE_RTOL, "codes_differing_by_1": differ,
        "live_codes": live, "forms": dict(ops.FLASH_FORMS)}))
    del cpu_params, dev_params, out, want

    # (b) the whole model in bf16: the first decode against the bf16
    # cache's, then the serving engine.
    qlm, lm = LM(full.scaled(kv_quant=True)), LM(full)
    first = lm_requests(full.vocab)[:LM_BATCH]
    ptoks = np.zeros((LM_BATCH, max(len(r.prompt) for r in first)), np.int32)
    for i, r in enumerate(first):
        ptoks[i, ptoks.shape[1] - len(r.prompt):] = r.prompt
    with torch.no_grad():
        t = torch.from_numpy(ptoks).to(dev)
        logits, cache = lm.prefill(params, t, LM_MAX_LEN)
        nxt = torch.argmax(logits[:, 0], dim=-1)[:, None]
        ref, cache = lm.decode_step(params, cache, nxt)
        bf16_bytes = cache_bytes(cache)
        del cache
        _, cache = qlm.prefill(params, t, LM_MAX_LEN)
        dec, cache = qlm.decode_step(params, cache, nxt)
        int8_bytes = cache_bytes(cache)
        if cache["k"].dtype != torch.int8:
            raise AssertionError(f"kv serve: cache k is {cache['k'].dtype}")
        del cache
    drift = (torch.softmax(dec[:, 0].float(), -1)
             - torch.softmax(ref[:, 0].float(), -1)).abs().max().item()
    # LM.init's unit-scale embedding saturates the softmax at full width,
    # so the logits' own distance is printed beside it.
    logit_drift = (dec - ref).abs().max().item()
    logit_max = ref.abs().max().item()
    if not drift < SOFTMAX_TOL:
        raise AssertionError(f"kv serve: the first decode's softmax is "
                             f"{drift:.3e} from the bf16 cache's")

    warm = instrumented_engine(qlm.cfg, params)   # one-time costs
    warm.generate([Request(uid=0, prompt=np.arange(1, 200, dtype=np.int32),
                           max_new_tokens=3)])
    eng, reqs = instrumented_engine(qlm.cfg, params), lm_requests(full.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    prefills, decodes = eng.stats["prefills"], eng.stats["decode_steps"]
    if launches != {"flash_attention": full.n_layers * (prefills + decodes)}:
        raise AssertionError(f"kv serve: launches {launches}, expected "
                             f"{full.n_layers} per prefill and decode step")
    forms = {"tile": 0, "wgmma": full.n_layers * prefills,
             "split": full.n_layers * decodes}
    if ops.FLASH_FORMS != forms:
        raise AssertionError(f"kv serve: flash_attention forms "
                             f"{ops.FLASH_FORMS}, expected {forms}")
    if not all(bool(ok) for *_, ok in eng.calls):
        raise AssertionError("kv serve: NaN or inf in the logits")
    if sorted(res) != list(range(LM_REQUESTS)) or any(
            len(res[r.uid]) != r.max_new_tokens for r in reqs):
        raise AssertionError("kv serve: not every request was answered")
    generated = sum(len(v) for v in res.values())
    same = sum(a == b for uid, toks in res.items()
               for a, b in zip(toks, bf16_run["res"][uid]))
    ms = {kind: [s.elapsed_time(e) for k, s, e, _ in eng.calls
                 if k == kind] for kind in ("prefill", "decode")}
    print("kv serve " + json.dumps({
        "arch": LM_ARCH, "n_layers": full.n_layers, "dtype": full.dtype,
        "kv_quant": True, "batch": LM_BATCH, "max_len": LM_MAX_LEN,
        "requests": LM_REQUESTS, "generated_tokens": generated,
        "stats": eng.stats, "launches": launches,
        "flash_attention_forms": dict(ops.FLASH_FORMS), "wall_s": wall,
        "requests_per_s": LM_REQUESTS / wall,
        "generated_tokens_per_s": generated / wall,
        "ms_per_prefill": sum(ms["prefill"]) / len(ms["prefill"]),
        "ms_per_decode_step": sum(ms["decode"]) / len(ms["decode"]),
        "peak_memory_gb": peak / 1e9,
        "bf16_cache_peak_memory_gb": bf16_run["peak"] / 1e9,
        "cache_bytes": int8_bytes, "bf16_cache_bytes": bf16_bytes,
        "first_decode_softmax_max_abs_diff": drift,
        "softmax_tol": SOFTMAX_TOL,
        "first_decode_logits_max_abs_diff": logit_drift,
        "first_decode_logits_max_abs": logit_max,
        "greedy_tokens_equal_to_bf16_cache": same / generated,
        "card": card}))
    print("kv decode profile " + json.dumps(
        decode_profile(qlm, params, dev) | {"card": card}))
    print(f"kv: {PARITY_LAYERS}-layer int8-KV {LM_ARCH} fp32 equals the CPU "
          f"within {PARITY_TOL:g} ({differ} of {live} codes 1 apart); "
          f"{LM_REQUESTS} requests served on a {int8_bytes / 1e6:.1f} MB "
          f"cache ({bf16_bytes / 1e6:.1f} MB in bf16), first-decode softmax "
          f"{drift:.2e} from the bf16 cache's")
    return launches


def examples_phase(card: str) -> dict:
    """Phase 10 (c): `examples/train_cnn_ecoflow` and `examples/train_gan`
    (the port's) on the `cuda` backend at their own sizes: the first
    EXAMPLE_STEPS steps' losses within TRAIN_TOL of the same steps on the
    CPU (plain versions), each step's launches against EXAMPLE_LAUNCHES,
    then ms per step over EXAMPLE_TIMED more (host clock to a
    synchronize, batches on the card); then `serve_lm` at its defaults.
    Returns the launches of all of it (the CPU steps launch nothing)."""
    from repro_torch.examples import serve_lm
    from repro_torch.examples import train_cnn_ecoflow as cnn_ex
    from repro_torch.examples import train_gan as gan_ex
    from repro_torch.kernels import ops
    from repro_torch.models import cnn, gan
    from repro_torch.models.layers import tree_map
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    ops.reset_launches()

    def drive(name, state, step, batch_at, n_losses):
        """`step(*state, *batch) -> (*state, *metrics)`, the losses first
        among the metrics."""
        n = len(state)
        on_card = tuple(tree_map(lambda t: t.to(dev), s) for s in state)
        on_cpu, losses, worst, per_step = state, [], 0.0, []
        for i in range(EXAMPLE_STEPS):
            batch = batch_at(i)
            before = dict(ops.LAUNCHES)
            out = step(*on_card, *(t.to(dev) for t in batch))
            torch.cuda.synchronize()
            want = step(*on_cpu, *batch)
            on_card, on_cpu = out[:n], want[:n]
            for got, w in zip(out[n:n + n_losses], want[n:n + n_losses]):
                got = got.cpu()
                if not torch.allclose(got, w, atol=TRAIN_TOL,
                                      rtol=TRAIN_TOL):
                    raise AssertionError(f"{name} step {i}: loss {got} "
                                         f"against {w} on the CPU")
                worst = max(worst, (got - w).abs().item())
            losses.append([float(v) for v in out[n:n + n_losses]])
            launches = {}
            for k, v in ops.LAUNCHES.items():
                key = "tconv" if k.startswith("tconv_") and \
                    k != "tconv_backward" else k
                if v - before[k]:
                    launches[key] = launches.get(key, 0) + v - before[k]
            if launches != EXAMPLE_LAUNCHES[name]:
                raise AssertionError(f"{name} step {i}: launches {launches}"
                                     f", expected {EXAMPLE_LAUNCHES[name]}")
            per_step.append(launches)
        batches = [[t.to(dev) for t in batch_at(EXAMPLE_STEPS + i)]
                   for i in range(EXAMPLE_TIMED)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            on_card = step(*on_card, *batch)[:n]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / EXAMPLE_TIMED
        print("example " + json.dumps({
            "name": name, "backend": "cuda", "steps_vs_cpu": EXAMPLE_STEPS,
            "losses": losses, "max_abs_err_vs_cpu": worst, "tol": TRAIN_TOL,
            "launches_per_step": per_step[0], "ms_per_step": ms,
            "timed_steps": EXAMPLE_TIMED, "card": card}))

    ocfg = AdamWConfig(lr=2e-3, warmup_steps=20, total_steps=300,
                       weight_decay=0.01)     # the example's defaults
    params = cnn.simple_cnn_init(torch.Generator().manual_seed(0),
                                 widths=cnn_ex.WIDTHS,
                                 n_classes=cnn_ex.N_CLASSES, device="cpu")
    drive("train_cnn_ecoflow", (params, adamw_init(params, ocfg)),
          cnn_ex.make_step(ocfg, backend="cuda"), cnn_ex.synth_batch, 1)

    gcfg, dcfg = gan_ex.adamw_configs(120)    # the example's default steps
    gp = gan.generator_init(torch.Generator().manual_seed(0), z_dim=gan_ex.Z,
                            base=gan_ex.BASE, device="cpu")
    dp = gan.discriminator_init(torch.Generator().manual_seed(1),
                                base=gan_ex.BASE, device="cpu")
    drive("train_gan", (gp, dp, adamw_init(gp, gcfg), adamw_init(dp, dcfg)),
          gan_ex.make_step(gcfg, dcfg, backend="cuda"),
          lambda i: (gan_ex.noise(i), gan_ex.real_batch(i)), 2)

    before = ops.LAUNCHES["flash_attention"]
    t0 = time.perf_counter()
    res = serve_lm.main([])
    torch.cuda.synchronize()
    if sorted(res) != list(range(10)) or any(len(v) != 12
                                             for v in res.values()):
        raise AssertionError("serve_lm: not every request was answered")
    print("example " + json.dumps({
        "name": "serve_lm", "arch": "qwen2-1.5b (smoke)",
        "wall_s": time.perf_counter() - t0,
        "flash_attention_launches": ops.LAUNCHES["flash_attention"] - before,
        "card": card}))
    return dict(ops.LAUNCHES)


def quickstart_phase(card: str) -> dict:
    """Phase 10 (d): the port's quickstart on the card.  Its dx (the
    `cuda` backend's input_grad slot) and dW (filter_grad: the standalone
    zero-free dW kernel, which must launch) against `naive` within TOL,
    and its section 4: the kernel, `torch_zero_free` and `naive` timed
    with CUDA events.  Returns its launches."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops

    ops.reset_launches()
    res = quickstart.main([])
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    if not launches.get("dconv_filter_grad"):
        raise AssertionError(f"quickstart: no dconv_filter_grad launch "
                             f"({launches})")
    g = res["grads"]
    for name in ("dx", "dw"):
        for other in ("_naive", "_ref"):
            if not torch.allclose(g[name], g[name + other], atol=TOL,
                                  rtol=TOL):
                raise AssertionError(
                    f"quickstart: {name} against {name + other}: max |err| "
                    f"{(g[name] - g[name + other]).abs().max().item():.3e}")
    if not (res["mapping_ok"] and res["drop_in"]["finite"]):
        raise AssertionError("quickstart: the mapping or the drop-in conv")
    print("quickstart " + json.dumps({
        "layer": {"B": quickstart.B, "N": quickstart.N, "K": quickstart.K,
                  "S": quickstart.S, "P": quickstart.P, "Ci": quickstart.Ci,
                  "Co": quickstart.Co},
        "zero_mac_fraction": res["zero_mac_fraction"],
        "max_abs_err": res["max_abs_err"], "tol": TOL, "ms": res["ms"],
        "iters": quickstart.ITERS, "launches": launches, "card": card}))
    return launches


def family_params(cfg, seed: int, dtype=None, device: str = "cuda"):
    """LM(cfg)'s params drawn on `device` (the card) by a generator there
    seeded `seed`: `LM.init_tree`'s shapes and scales, every norm scale
    plus 0.1 N(0, 1) (so that 1 + scale is not 1), a group of layers at a
    time (one; a hybrid group of attn_every).  With `dtype`, every leaf
    of ndim >= 2 is cast as soon as it is drawn (`launch.steps.precast`),
    so the fp32 copy of the whole model never exists."""
    from repro_torch.launch.steps import precast
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.lm import LM

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    step = cfg.attn_every if cfg.family == "hybrid" else 1

    def noisy(tree):
        return {k: noisy(v) if isinstance(v, dict) else
                v + 0.1 * torch.randn(v.shape, generator=gen, device=dev)
                if k.endswith("scale") else v for k, v in tree.items()}

    with torch.device("meta"):
        shapes = LM(cfg).init_tree(torch.Generator())
    params = None
    for i in range(0, cfg.n_layers, step):
        # Only the first part's embeddings are kept: the later parts draw
        # a table of 8 rows (a layer's params do not depend on the vocab).
        sub = cfg.scaled(n_layers=step) if params is None else \
            cfg.scaled(n_layers=step, vocab=8)
        with torch.device(dev):
            part = noisy(LM(sub).init_tree(gen))
        if dtype is not None:
            part = precast(part, dtype)
        if params is None:
            params = dict(part, blocks=tree_map(
                lambda s_, p_: torch.empty(s_.shape, dtype=p_.dtype,
                                           device=dev),
                shapes["blocks"], part["blocks"]))
        for dst, src in zip(tree_leaves(params["blocks"]),
                            tree_leaves(part["blocks"])):
            dst[i:i + step].copy_(src)
        del part
    return params


class RouteLog:
    """Within `with`, every `models.moe.route` call is recorded as (moe
    params, x, probs, gate values, indices): the card's and the CPU's runs
    of one call then compare routing layer by layer."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        self._route = moe.route

        def route(params, x, cfg):
            out = self._route(params, x, cfg)
            self.calls.append((params, x.detach(),
                               *(t.detach() for t in out)))
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route
        return False


def routing_check(card_log, cpu_log, cfg, what) -> tuple:
    """(choices routed otherwise by the card than by `route` on the CPU
    at the same params and x, choices that differ between the card's run
    and the CPU's own run, max |err| of dispatch/combine).  Every card
    call's probs are held within PARITY_TOL of the CPU's on its x; a
    choice the card routes otherwise must be a near-tie: the CPU's probs
    of the two experts involved within PARITY_TOL of each other.  Where
    a call's routing differs, the card's `dispatch_combine` on its own
    routing is held within PARITY_TOL of the same call on the CPU."""
    from repro_torch.models import moe
    from repro_torch.models.layers import tree_map

    cpu = torch.device("cpu")
    if len(card_log.calls) != len(cpu_log.calls):
        raise AssertionError(f"{what}: {len(card_log.calls)} route calls on "
                             f"the card, {len(cpu_log.calls)} on the CPU")
    flips, apart, worst = 0, 0, 0.0
    for (p, x, probs, vals, idx), (*_, cidx) in zip(card_log.calls,
                                                    cpu_log.calls):
        cx, idx_h = x.to(cpu), idx.to(cpu)
        with torch.no_grad():       # `route` reads the router alone
            want_probs, _, want_idx = moe.route(
                {"router": p["router"].to(cpu)}, cx, cfg)
        if not torch.allclose(probs.to(cpu), want_probs, atol=PARITY_TOL,
                              rtol=PARITY_TOL):
            raise AssertionError(
                f"{what}: router probs max |err| "
                f"{(probs.to(cpu) - want_probs).abs().max().item():.3e}")
        moved = idx_h != want_idx
        gap = (want_probs.gather(-1, idx_h)
               - want_probs.gather(-1, want_idx))[moved].abs()
        if gap.numel() and gap.max().item() > PARITY_TOL:
            raise AssertionError(
                f"{what}: {int(moved.sum())} choices routed otherwise, "
                f"the CPU's probs of the two experts {gap.max().item():.3e} "
                f"apart: not a near-tie")
        flips += int(moved.sum())
        n = int((idx_h != cidx).sum())
        apart += n
        if not n and not moved.any():
            continue
        cp = tree_map(lambda t: t.to(cpu), p)
        with torch.no_grad():
            got = moe.dispatch_combine(p, x, vals, idx, cfg).to(cpu).float()
            want = moe.dispatch_combine(cp, cx, vals.to(cpu), idx_h,
                                        cfg).float()
        if not torch.allclose(got, want, atol=PARITY_TOL, rtol=PARITY_TOL):
            raise AssertionError(f"{what}: dispatch/combine on the card's "
                                 f"routing, max |err| "
                                 f"{(got - want).abs().max().item():.3e}")
        worst = max(worst, (got - want).abs().max().item())
    return flips, apart, worst


def attention_layers(cfg) -> int:
    """Attention applications per forward: one per layer, none in RWKV,
    one per group of the hybrid (the shared block)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def family_parity(card: str, arch: str, n_layers: int,
                  train_shape=LM_TRAIN_PARITY) -> dict:
    """Phase 11 (a) for one model: `arch` at its published widths and
    `n_layers` layers in fp32, params from `family_params`.  Prefill of
    LM_BATCH prompts of 64-200 tokens and PARITY_DECODES teacher-forced
    decodes, each call's logits within PARITY_TOL of the same call on the
    CPU; then LM.loss and every gradient at batch x seq `train_shape`,
    each leaf within LM_TRAIN_TOL of its largest magnitude.  For the MoE
    every route call is held against the CPU's on the card's own input
    (`routing_check`: probs within PARITY_TOL, a choice routed otherwise
    only at a near-tie); past a call whose routing differs between the two
    runs (after which the token counts differ) the logits are no longer
    comparable, and that call's dispatch/combine is held on the card's
    routing instead."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.layers import tree_map, tree_paths
    from repro_torch.models.lm import LM

    t_start = time.perf_counter()
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    cfg = get_config(arch).scaled(n_layers=n_layers, dtype="float32")
    lm = LM(cfg)
    dev_params = family_params(cfg, FAMILY_SEED)
    cpu_params = tree_map(lambda t: t.to(cpu), dev_params)
    rng = np.random.default_rng(13)
    lens = rng.integers(64, 201, LM_BATCH)
    toks = np.zeros((LM_BATCH, int(lens.max())), np.int32)
    for i, n in enumerate(lens):
        toks[i, toks.shape[1] - n:] = rng.integers(1, cfg.vocab, n)
    if cfg.embed_input:   # frames of the same lengths, zeros in front
        toks = np.zeros((*toks.shape, cfg.d_model), np.float32)
        for i, n in enumerate(lens):
            toks[i, toks.shape[1] - n:] = rng.standard_normal(
                (n, cfg.d_model))
    forced = rng.integers(1, cfg.vocab, (PARITY_DECODES, LM_BATCH, 1))
    max_len = toks.shape[1] + PARITY_DECODES

    flips, differ, dc_err, worst, held, diverged = 0, 0, 0.0, 0.0, 0, None
    cpu_s = {"prefill_and_decodes": 0.0, "loss_and_grads": 0.0}
    ops.reset_launches()
    with torch.no_grad():
        for step in range(PARITY_DECODES + 1):
            what = f"{arch} parity " + ("prefill" if step == 0
                                        else f"decode {step}")
            with RouteLog() as on_card:
                out = lm.prefill(dev_params, torch.from_numpy(toks).to(dev),
                                 max_len) if step == 0 else \
                    lm.decode_step(dev_params, out[1],
                                   torch.from_numpy(forced[step - 1]
                                                    .astype(np.int32)).to(dev))
            t_cpu = time.perf_counter()
            with RouteLog() as on_cpu:
                want = lm.prefill(cpu_params, torch.from_numpy(toks),
                                  max_len) if step == 0 else \
                    lm.decode_step(cpu_params, want[1], torch.from_numpy(
                        forced[step - 1].astype(np.int32)))
            cpu_s["prefill_and_decodes"] += time.perf_counter() - t_cpu
            n, apart, e = routing_check(on_card, on_cpu, cfg, what)
            flips, differ, dc_err = flips + n, differ + apart, max(dc_err, e)
            if apart and diverged is None:
                diverged = step
            got = out[0].to(cpu)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{what}: a non-finite logit")
            err = (got - want[0]).abs().max().item()
            if diverged is None:
                if not torch.allclose(got, want[0], atol=PARITY_TOL,
                                      rtol=PARITY_TOL):
                    raise AssertionError(f"{what}: logits max |err| {err:.3e}"
                                         f" against the CPU")
                worst, held = max(worst, err), held + 1
    serve_launches = dict(ops.LAUNCHES)
    serve_forms = dict(ops.FLASH_FORMS)
    n_attn = attention_layers(cfg)
    want_forms = {"tile": n_attn, "wgmma": 0, "split": n_attn * PARITY_DECODES}
    if serve_launches["flash_attention"] != n_attn * (1 + PARITY_DECODES) or \
            serve_forms != want_forms:
        raise AssertionError(f"{arch} parity: flash_attention launches "
                             f"{serve_launches['flash_attention']}, forms "
                             f"{serve_forms}, expected {want_forms}")

    # The loss and every gradient.
    B, S = train_shape
    batch = TokenDataset(vocab=cfg.vocab, seq_len=S, global_batch=B,
                         seed=21, embed_dim=cfg.d_model if cfg.embed_input
                         else None).batch(0)
    labels = batch["labels"].copy()
    labels[0, :7] = -1
    ops.reset_launches()
    with RouteLog() as on_card:
        (loss, aux), grads = loss_and_grads(
            lm, dev_params, torch.from_numpy(batch["inputs"]).to(dev),
            torch.from_numpy(labels).to(dev))
    torch.cuda.synchronize()
    train_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    want_l = {"flash_attention": 2 * n_attn,
              "flash_attention_backward": n_attn} if n_attn else {}
    if train_launches != want_l:
        raise AssertionError(f"{arch} train parity: launches "
                             f"{train_launches}, expected {want_l}")
    t_cpu = time.perf_counter()
    with RouteLog() as on_cpu:
        (want_loss, want_aux), want = loss_and_grads(
            lm, cpu_params, torch.from_numpy(batch["inputs"]),
            torch.from_numpy(labels))
    cpu_s["loss_and_grads"] = time.perf_counter() - t_cpu
    n, apart, e = routing_check(on_card, on_cpu, cfg, f"{arch} train parity")
    flips, differ, dc_err = flips + n, differ + apart, max(dc_err, e)
    tol = LM_TRAIN_TOL["float32"]
    # A choice routed otherwise moves its token's terms: printed, not held.
    grad_worst = None if apart else hold_grads(
        f"{arch} train parity", loss, want_loss, grads, want, tol)
    row = {"arch": arch, "n_layers": n_layers, "dtype": "float32",
           "prompt_lens": lens.tolist(), "decode_steps": PARITY_DECODES,
           "logits_max_abs_err_vs_cpu": worst, "tol": PARITY_TOL,
           "calls_held": held, "routing_differences_same_x": flips,
           "routing_differences_between_runs": differ,
           "first_call_routed_otherwise": diverged,
           "dispatch_combine_max_abs_err_on_card_routing": dc_err,
           "serve_forms": serve_forms, "train_batch": B, "train_seq": S,
           "loss": loss.item(), "cpu_loss": want_loss.item(),
           "aux": float(aux["aux"]), "cpu_aux": float(want_aux["aux"]),
           "grad_max_err_of_leaf_max": grad_worst
           if grad_worst is not None else "not held: routing differs",
           "grad_tol": tol,
           "leaves": len(tree_paths(cpu_params)),
           "train_launches": train_launches,
           "cpu_s": cpu_s,
           "phase_s": time.perf_counter() - t_start, "card": card}
    print("family parity " + json.dumps(row))
    del dev_params, cpu_params, grads, want, out
    gc.collect()
    torch.cuda.empty_cache()
    return row


def family_serve(card: str, arch: str) -> dict:
    """Phase 11 (b) for one model: bf16 params (`family_params` cast as
    drawn) at the published widths, whole or cut (FAMILY_SERVE_SHARE),
    phase 6 (b)'s first FAMILY_REQUESTS requests through
    ServeEngine(batch=LM_BATCH, max_len=LM_MAX_LEN) after a warm-up
    request: every request answered,
    no NaN, one flash_attention launch per attention layer per prefill and
    decode step -- prefills on wgmma at head_dim 128 and on tile at 80,
    decodes on split -- and none for RWKV; requests/s, tokens/s, ms per
    prefill and decode step, peak memory and a decode profile.  Returns
    the run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.attention import WGMMA_DIMS
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Request

    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    full = get_config(arch)
    cfg = full
    if arch.startswith("moonshot"):
        with torch.device("meta"):
            one = LM(full.scaled(n_layers=1)).init_tree(torch.Generator())
        layer = sum(t.numel() for t in tree_leaves(one["blocks"])) * 2
        rest = sum(t.numel() for t in tree_leaves(one)) * 2 - layer
        budget = FAMILY_SERVE_SHARE * torch.cuda.mem_get_info()[1]
        cfg = full.scaled(n_layers=int(min(full.n_layers,
                                           (budget - rest) // layer)))
    t0 = time.perf_counter()
    params = family_params(cfg, FAMILY_SEED + 1, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    instrumented_engine(cfg, params).generate([Request(
        uid=0, prompt=np.arange(1, 200, dtype=np.int32), max_new_tokens=3)])
    eng, reqs = instrumented_engine(cfg, params), \
        lm_requests(cfg.vocab)[:FAMILY_REQUESTS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    prefills, decodes = eng.stats["prefills"], eng.stats["decode_steps"]
    n_attn = attention_layers(cfg)
    want = {"flash_attention": n_attn * (prefills + decodes)} if n_attn \
        else {}
    prefill_form = "wgmma" if cfg.head_dim in WGMMA_DIMS else "tile"
    forms = {"tile": 0, "wgmma": 0, "split": n_attn * decodes}
    forms[prefill_form] += n_attn * prefills
    if launches != want or ops.FLASH_FORMS != forms:
        raise AssertionError(f"{arch} serve: launches {launches}, forms "
                             f"{ops.FLASH_FORMS}, expected {want}, {forms}")
    if not all(bool(ok) for *_, ok in eng.calls):
        raise AssertionError(f"{arch} serve: NaN or inf in the logits")
    if sorted(res) != list(range(FAMILY_REQUESTS)) or any(
            len(res[r.uid]) != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{arch} serve: not every request was answered")
    generated = sum(len(v) for v in res.values())
    ms = {kind: [s_.elapsed_time(e) for k, s_, e, _ in eng.calls
                 if k == kind] for kind in ("prefill", "decode")}
    row = {"arch": arch, "n_layers": cfg.n_layers,
           "published_layers": full.n_layers, "dtype": "bfloat16",
           "params_gb": param_bytes / 1e9, "init_s": init_s,
           "batch": LM_BATCH, "max_len": LM_MAX_LEN,
           "requests": FAMILY_REQUESTS, "generated_tokens": generated,
           "stats": eng.stats, "launches": launches,
           "flash_attention_forms": dict(ops.FLASH_FORMS), "wall_s": wall,
           "requests_per_s": FAMILY_REQUESTS / wall,
           "generated_tokens_per_s": generated / wall,
           "ms_per_prefill": sum(ms["prefill"]) / len(ms["prefill"]),
           "ms_per_decode_step": sum(ms["decode"]) / len(ms["decode"]),
           "peak_memory_gb": peak / 1e9, "card": card}
    prof = decode_profile(LM(cfg), params, dev)
    row["phase_s"] = time.perf_counter() - t_start
    print("family serve " + json.dumps(row))
    print("family decode profile " + json.dumps(
        {"arch": arch} | prof | {"card": card}))
    del params, eng          # the engine's wrapped calls make a cycle
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def family_train(card: str, arch: str, n_layers, traced: bool,
                 steps: int = FAMILY_TRAIN_STEPS) -> dict:
    """Phase 11 (c) for one model: `train_run` (launch/train's path,
    FAMILY_TRAIN_STEPS steps, params drawn on the card from FAMILY_SEED)
    at the published widths and `n_layers` layers, or (None) the deepest
    cut whose params, moments and gradients take FAMILY_TRAIN_SHARE of the
    card at FAMILY_TRAIN_BYTES a param: attention on wgmma at head_dim
    128, on tile / simt at 80.  Returns the run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.lm import LM

    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    full = get_config(arch)
    if n_layers is None:
        step = full.attn_every if full.family == "hybrid" else 1
        with torch.device("meta"):
            one = LM(full.scaled(n_layers=step)).init_tree(torch.Generator())
        per = sum(t.numel() for t in tree_leaves(one["blocks"]))
        rest = sum(t.numel() for t in tree_leaves(one)) - per
        budget = FAMILY_TRAIN_SHARE * torch.cuda.mem_get_info()[1] \
            / FAMILY_TRAIN_BYTES
        n_layers = min(full.n_layers, int((budget - rest) // per) * step)
    run = train_run(f"{arch} train", full.scaled(n_layers=n_layers),
                    steps, FAMILY_SEED, traced)
    print("family train " + json.dumps(
        {"arch": arch, "published_layers": full.n_layers} | run["row"]
        | {"phase_s": time.perf_counter() - t_start, "card": card}))
    if run["profile"] is not None:
        print("family train profile " + json.dumps(
            {"arch": arch} | run["profile"] | {"card": card}))
    return run["launches"]


def families_phase(card: str) -> dict:
    """Phase 11: the moe, ssm and hybrid LM families (moonshot-v1-16b-a3b,
    rwkv6-7b, zamba2-2.7b): (a) parity against the CPU
    (`family_parity`), (b) serving (`family_serve`), (c) training
    (`family_train`).  Returns {"launches": (b) and (c)'s launches
    summed, "d80": those of zamba2's head_dim 80 instantiations}."""
    t0 = time.perf_counter()
    for arch, n in FAMILY_PARITY.items():
        family_parity(card, arch, n)
    launches, d80 = {}, {}
    runs = [(arch, lambda a=arch: family_serve(card, a))
            for arch in FAMILY_SERVE]
    runs += [(arch, lambda a=arch, n=n: family_train(card, a, *n))
             for arch, n in FAMILY_TRAIN.items()]
    for arch, run in runs:
        got = run()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
            if arch.startswith("zamba2"):
                d80[k] = d80.get(k, 0) + v
    print(f"families: moonshot-v1-16b-a3b, rwkv6-7b and zamba2-2.7b equal "
          f"the CPU in fp32 within {PARITY_TOL:g}, served in bf16 and "
          f"trained at seq {LM_TRAIN_SEQ} ({time.perf_counter() - t0:.1f} s)")
    return {"launches": launches, "d80": d80}


def embed_serve(card: str, arch: str) -> dict:
    """Phase 12 (a), serving: bf16 params (`family_params`) at the
    published widths, whole or at the deepest cut that FAMILY_SERVE_SHARE
    of the card holds, serving phase 6 (b)'s first FAMILY_REQUESTS
    requests with
    frames in place of prompts: frame embeddings of each request's prompt
    length (drawn on the card from a seed, zeros in front of the shorter
    ones), `LM.prefill(params, frames, LM_MAX_LEN)` for each batch of
    LM_BATCH requests in order, then greedy `LM.decode_step`s on tokens
    until the batch's longest budget (`ServeEngine` takes token prompts
    only, as `repro`'s does).  Every request gets its budget of tokens, no
    NaN, one flash_attention launch per layer per call: prefills on wgmma,
    decodes on split.  Returns the run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.attention import WGMMA_DIMS
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.lm import LM

    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    full = get_config(arch)
    with torch.device("meta"):
        one = LM(full.scaled(n_layers=1)).init_tree(torch.Generator())
    layer = sum(t.numel() for t in tree_leaves(one["blocks"])) * 2
    rest = sum(t.numel() for t in tree_leaves(one)) * 2 - layer
    budget = FAMILY_SERVE_SHARE * torch.cuda.mem_get_info()[1]
    cfg = full.scaled(n_layers=int(min(full.n_layers,
                                       (budget - rest) // layer)))
    t0 = time.perf_counter()
    params = family_params(cfg, FAMILY_SEED + 2, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    lm = LM(cfg)
    gen = torch.Generator(device=dev).manual_seed(FAMILY_SEED + 3)
    reqs = lm_requests(cfg.vocab)[:FAMILY_REQUESTS]

    def frames(lens):
        x = torch.zeros((len(lens), max(lens), cfg.d_model),
                        dtype=torch.bfloat16, device=dev)
        for i, n in enumerate(lens):
            x[i, x.shape[1] - n:] = torch.randn(
                (n, cfg.d_model), generator=gen, device=dev)
        return x

    def serve(batch_reqs, calls):
        """One batch: prefill, then greedy decodes; tokens by uid."""
        out = {r.uid: [] for r in batch_reqs}
        x = frames([len(r.prompt) for r in batch_reqs])
        for step in range(max(r.max_new_tokens for r in batch_reqs) + 1):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            if step == 0:
                logits, cache = lm.prefill(params, x, LM_MAX_LEN)
            else:
                logits, cache = lm.decode_step(params, cache, tok)
            end.record()
            calls.append(("prefill" if step == 0 else "decode", start, end,
                          torch.isfinite(logits).all()))
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            for r, t in zip(batch_reqs, tok[:, 0].tolist()):
                if len(out[r.uid]) < r.max_new_tokens:
                    out[r.uid].append(t)
        return out

    with torch.no_grad():
        serve(reqs[:1], [])                      # one-time costs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        calls, res = [], {}
        t0 = time.perf_counter()
        for i in range(0, len(reqs), LM_BATCH):
            res.update(serve(reqs[i:i + LM_BATCH], calls))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    prefills = sum(k == "prefill" for k, *_ in calls)
    decodes = len(calls) - prefills
    n_attn = attention_layers(cfg)
    want = {"flash_attention": n_attn * (prefills + decodes)}
    prefill_form = "wgmma" if cfg.head_dim in WGMMA_DIMS else "tile"
    forms = {"tile": 0, "wgmma": 0, "split": n_attn * decodes}
    forms[prefill_form] += n_attn * prefills
    if launches != want or ops.FLASH_FORMS != forms:
        raise AssertionError(f"{arch} serve: launches {launches}, forms "
                             f"{ops.FLASH_FORMS}, expected {want}, {forms}")
    if not all(bool(ok) for *_, ok in calls):
        raise AssertionError(f"{arch} serve: NaN or inf in the logits")
    if sorted(res) != list(range(FAMILY_REQUESTS)) or any(
            len(res[r.uid]) != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{arch} serve: not every request was answered")
    generated = sum(len(v) for v in res.values())
    ms = {kind: [s_.elapsed_time(e) for k, s_, e, _ in calls if k == kind]
          for kind in ("prefill", "decode")}
    row = {"arch": arch, "n_layers": cfg.n_layers,
           "published_layers": full.n_layers, "dtype": "bfloat16",
           "head_dim": cfg.head_dim, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "params_gb": param_bytes / 1e9, "init_s": init_s,
           "batch": LM_BATCH, "max_len": LM_MAX_LEN,
           "requests": FAMILY_REQUESTS, "frame_positions": int(sum(
               len(r.prompt) for r in reqs)), "generated_tokens": generated,
           "prefills": prefills, "decode_steps": decodes,
           "launches": launches, "flash_attention_forms": dict(
               ops.FLASH_FORMS), "wall_s": wall,
           "requests_per_s": FAMILY_REQUESTS / wall,
           "generated_tokens_per_s": generated / wall,
           "ms_per_prefill": sum(ms["prefill"]) / len(ms["prefill"]),
           "ms_per_decode_step": sum(ms["decode"]) / len(ms["decode"]),
           "peak_memory_gb": peak / 1e9, "card": card}
    prof = decode_profile(lm, params, dev)
    row["phase_s"] = time.perf_counter() - t_start
    print("embed serve " + json.dumps(row))
    print("embed decode profile " + json.dumps(
        {"arch": arch} | prof | {"card": card}))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def embeds_phase(card: str) -> dict:
    """Phase 12 (a): the audio and vlm families (musicgen-medium,
    internvl2-76b): parity against the CPU at EMBED_PARITY's depths in fp32
    (`family_parity` on frames), serving (`embed_serve`), and
    musicgen-medium trained at EMBED_TRAIN's depth (`family_train`).
    Returns (b) and
    (c)'s launches summed."""
    t0 = time.perf_counter()
    for arch, (n, shape) in EMBED_PARITY.items():
        family_parity(card, arch, n, shape)
    launches = {}
    runs = [lambda a=arch: embed_serve(card, a) for arch in EMBED_SERVE]
    runs += [lambda a=arch, n=n: family_train(card, a, n, True,
                                              EMBED_TRAIN_STEPS)
             for arch, n in EMBED_TRAIN.items()]
    for run in runs:
        for k, v in run().items():
            launches[k] = launches.get(k, 0) + v
    print(f"embeds: musicgen-medium and internvl2-76b (at "
          f"{EMBED_PARITY['musicgen-medium'][0]} / "
          f"{EMBED_PARITY['internvl2-76b'][0]} layers) equal the CPU in fp32 "
          f"within {PARITY_TOL:g} on frames, served in bf16; musicgen-medium "
          f"trained at {EMBED_TRAIN['musicgen-medium']} layers at seq "
          f"{LM_TRAIN_SEQ} "
          f"({time.perf_counter() - t0:.1f} s)")
    return launches


def _mesh_step(name):
    """STEP_LAUNCHES' step `name` as `(state, batch) -> (state, losses)`
    on the `cuda` backend, and its ConvDataset kind."""
    from repro_torch.models import cnn, gan

    if name == "gan_sgd_step":
        def step(state, b):
            new, g_loss, d_loss = gan.gan_sgd_step(
                state, b["z"], b["real"], lr=LR, backend="cuda")
            return new, (g_loss, d_loss)
        return step, "gan"
    if name == "gen_sgd_step":
        def step(state, b):
            new, loss = gan.gen_sgd_step(state["g"], state["d"], b["z"],
                                         lr=LR, backend="cuda")
            return {"g": new, "d": state["d"]}, (loss,)
        return step, "gan_gen"

    def step(params, b):
        new, loss = cnn.sgd_step(params, b["x"], b["labels"], lr=LR,
                                 backend="cuda")
        return new, (loss,)
    return step, "cnn"


@contextlib.contextmanager
def planned_shapes():
    """Within `with`, every plan `kernels/tiling.py` makes: (op, x_shape,
    dy_shape)."""
    from repro_torch.kernels import tiling

    seen = []
    saved = tiling.plan_tiles, tiling.plan_strategy

    def spy(plan):
        def call(op, spec, **kw):
            seen.append((op, tuple(kw["x_shape"]), tuple(kw["dy_shape"])))
            return plan(op, spec, **kw)
        return call

    tiling.plan_tiles, tiling.plan_strategy = map(spy, saved)
    try:
        yield seen
    finally:
        tiling.plan_tiles, tiling.plan_strategy = saved


def mesh_checks(rank: int, tmp: str, device: str = "cuda") -> dict:
    """One rank of phase 12 (b), on the card: a (2, 2) ("data", "model")
    mesh of the MESH_RANKS ranks.  For each conv step (gan_sgd_step,
    gen_sgd_step, sgd_step at phase 5's widths, batch TRAIN_BATCH): the
    step on params laid out by `tree_shardings` and a batch laid out by
    `batch_pspec` under `use_mesh`, against the same step on this rank
    alone (no mesh): params within MESH_RTOL / MESH_ATOL, losses within
    MESH_LOSS_TOL; the sharded step's launches equal STEP_LAUNCHES; every
    plan made on the rank's block (batch / |data|; the channel the op
    produces / |model| where it divides); ms per step of both.  Then the
    elastic restore: ConvTrainer(gan) on the mesh to step 2 (checkpoint),
    host 1 (ranks 2, 3) lost, `elastic_mesh(survivors(...))` a (1, 2)
    mesh of ranks 0 and 1, restored onto it and run to
    MESH_TRAINER_STEPS; its state against the same trainer on one rank
    (no mesh: its CUDA-graph step).  Returns what it measured.
    `device="cpu"` rehearses the same checks on the plain versions."""
    from repro_torch.data.pipeline import ConvDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import cnn, gan
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import fault_tolerance as ft
    from repro_torch.train.conv_trainer import ConvTrainer, ConvTrainerConfig

    dev = torch.device(device)
    mesh = make_debug_mesh(MESH_SHAPE, ("data", "model"), device=device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    out = {"rank": rank, "coordinate": [mesh.get_local_rank(0),
                                        mesh.get_local_rank(1)],
           "steps": {}, "launches": {}}
    gen = torch.Generator().manual_seed(2024)
    states = {"gan_sgd_step": gan.gan_init(gen, z_dim=64, base=64, ch=3,
                                           device=dev)}
    states["gen_sgd_step"] = states["gan_sgd_step"]
    states["sgd_step"] = cnn.simple_cnn_init(gen, device=dev)

    def close(a, b, what):
        if a.shape != b.shape or not torch.allclose(
                a, b, rtol=MESH_RTOL, atol=MESH_ATOL):
            raise AssertionError(f"rank {rank} {what}: max |err| "
                                 f"{(a - b).abs().max().item():.3e}")
        return (a - b).abs().max().item()

    def timed(fn):
        ms = []
        for _ in range(MESH_TIMED):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return sum(ms[1:]) / (len(ms) - 1)

    for name, state in states.items():
        step, kind = _mesh_step(name)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ConvDataset(
            kind=kind, batch=TRAIN_BATCH, image=32, z_dim=64,
            seed=0).batch_at(0).items()}
        with planned_shapes() as alone_plans:
            want, want_losses = step(state, batch)
        with sh.use_mesh(mesh):
            s_state = sh.device_put(state, sh.tree_shardings(state, mesh))
            s_batch = {k: sh.device_put(v, sh.NamedSharding(
                mesh, sh.batch_pspec(mesh, v.dim(), 0, v.shape[0])))
                for k, v in batch.items()}
            sync()
            ops.reset_launches()
            with planned_shapes() as plans:
                got, losses = step(s_state, s_batch)
            sync()
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            for k, v in launches.items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            # (The CPU's plain versions count no launch.)
            if dev.type == "cuda" and launches != STEP_LAUNCHES[name]:
                raise AssertionError(f"rank {rank} {name}: launches "
                                     f"{launches}, expected "
                                     f"{STEP_LAUNCHES[name]}")
            got = tree_map(sh.full_tensor, got)
            err = max(close(a, b, f"{name} params") for a, b in zip(
                tree_leaves(got), tree_leaves(want)))
            loss_err = max(abs(float(a) - float(b))
                           for a, b in zip(losses, want_losses))
            if loss_err > MESH_LOSS_TOL:
                raise AssertionError(f"rank {rank} {name}: losses "
                                     f"{[float(v) for v in losses]} vs "
                                     f"{[float(v) for v in want_losses]}")
            ms = timed(lambda: step(s_state, s_batch))
        if len(plans) != len(alone_plans):
            raise AssertionError(f"rank {rank} {name}: {len(plans)} plans "
                                 f"on the mesh, {len(alone_plans)} alone")
        for (op, x, dy), (_, X, DY) in zip(plans, alone_plans):
            cin_op = op in ("input_grad", "ct_backward")
            want_x = (X[0] // 2, *X[1:3],
                      X[3] // 2 if cin_op and X[3] % 2 == 0 else X[3])
            want_dy = (DY[0] // 2, *DY[1:3],
                       DY[3] if cin_op else DY[3] // 2)
            if (x, dy) != (want_x, want_dy):
                raise AssertionError(f"rank {rank} {name}: {op} planned on "
                                     f"{x} / {dy}, expected {want_x} / "
                                     f"{want_dy}")
        out["steps"][name] = {
            "params_max_abs_err": err, "loss_max_abs_err": loss_err,
            "launches": launches, "plans": len(plans),
            "plan_shapes": sorted({f"{op} {x} {dy}" for op, x, dy in plans}),
            "ms_per_step_sharded": ms,
            "ms_per_step_alone": timed(lambda: step(state, batch))}

    # The elastic restore.
    cfg = dict(workload="gan", total_steps=MESH_TRAINER_STEPS,
               backend="cuda", batch=TRAIN_BATCH, z_dim=64, base=64)
    ckpt_dir = os.path.join(tmp, "ckpt")

    def lose_host(step):
        if step == MESH_TRAINER_STEPS // 2:
            raise ft.HostFailure(step, [1])

    ops.reset_launches()
    try:
        ConvTrainer(ConvTrainerConfig(**cfg, ckpt_dir=ckpt_dir,
                                      ckpt_every=MESH_TRAINER_STEPS // 2),
                    mesh=mesh, device=dev).run(fail_hook=lose_host)
        raise AssertionError("the host failure did not stop the run")
    except ft.HostFailure as e:
        lost = e.hosts
    ranks = ft.survivors(mesh, lost, devices_per_host=2)
    small = ft.elastic_mesh(ranks, model_parallel=2, device=device)
    if rank in ranks:
        res = ConvTrainer(ConvTrainerConfig(**cfg, ckpt_dir=ckpt_dir,
                                            ckpt_every=MESH_TRAINER_STEPS
                                            // 2), mesh=small,
                          device=dev).run()
        for k, v in ops.LAUNCHES.items():
            if v:
                out["launches"][k] = out["launches"].get(k, 0) + v
        alone = ConvTrainer(ConvTrainerConfig(**cfg), device=dev).run()
        got = tree_map(sh.full_tensor, res["state"])
        err = max(close(a, b, "elastic restore") for a, b in zip(
            tree_leaves(got), tree_leaves(alone["state"])))
        if res["start_step"] != MESH_TRAINER_STEPS // 2 or \
                [h["step"] for h in res["history"]] != list(
                    range(MESH_TRAINER_STEPS // 2 + 1,
                          MESH_TRAINER_STEPS + 1)):
            raise AssertionError(f"rank {rank} elastic: resumed at "
                                 f"{res['start_step']}, {res['history']}")
        out["elastic"] = {"survivors": ranks, "mesh": list(small.shape),
                          "resumed_at": res["start_step"],
                          "params_max_abs_err_vs_alone": err}
    else:
        for k, v in ops.LAUNCHES.items():
            if v:
                out["launches"][k] = out["launches"].get(k, 0) + v
        out["elastic"] = "lost with host 1"
    return out


def mesh_rank(rank: int, tmp: str, device: str = "cuda") -> None:
    """A spawned rank of phase 12 (b): joins the `gloo` group through a
    `file://` store in `tmp`, runs `mesh_checks` on the card and writes
    its results to `tmp`.  Any failure raises in the rank, and the spawn
    raises it in the parent."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=MESH_RANKS)
    try:
        res = mesh_checks(rank, tmp, device)
        with open(os.path.join(tmp, f"rank_{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def mesh_phase(card: str, device: str = "cuda") -> dict:
    """Phase 12 (b): MESH_RANKS `gloo` ranks spawned on the one card
    (`mesh_checks` in each); a rank's failure ends the phase with its
    error.  Prints each rank's results; the numbers are `gloo` ranks
    sharing one card, not a multi-card speed.  Returns the launches of
    the sharded steps and the elastic run, summed over the ranks."""
    import torch.multiprocessing as mp

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(mesh_rank, args=(tmp, device), nprocs=MESH_RANKS,
                 join=True)
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"rank_{r}.json")) as f:
                ranks.append(json.load(f))
    launches = {}
    for res in ranks:
        for k, v in res.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        print("mesh rank " + json.dumps(
            res | {"timing": f"{MESH_RANKS} gloo ranks sharing one card",
                   "card": card}))
    print(f"mesh: gan_sgd_step, gen_sgd_step and sgd_step on a "
          f"{MESH_SHAPE} mesh of {MESH_RANKS} gloo ranks on the card equal "
          f"one rank within rtol {MESH_RTOL:g} / atol {MESH_ATOL:g}, losses "
          f"{MESH_LOSS_TOL:g}; one forward and one backward launch per conv "
          f"layer per rank, planned on local shapes; the elastic restore "
          f"onto (1, 2) equals one rank ({time.perf_counter() - t0:.1f} s)")
    return launches


def _lm_mesh_configs(small: bool):
    """(the whole LM_ARCH config, its parity config): with `small` (a CPU
    rehearsal) narrow widths and 2 layers instead of the published ones."""
    from repro_torch.configs import get_config

    full = get_config(LM_ARCH)
    if small:
        full = full.scaled(n_layers=2, d_model=128, d_ff=256, vocab=1024)
    return full, full.scaled(n_layers=PARITY_LAYERS, dtype="float32")


class _Counted:
    """Every rank's launches of the main paths it drives: `run(fn)` sets
    the kernels' counts to 0 just before `fn()`, reads them just after and
    adds them to `total`, with the forms of that run; `begin` / `end`
    bracket a run that an exception stops."""

    def __init__(self, sync):
        self.sync, self.total = sync, {}

    def begin(self):
        from repro_torch.kernels import ops
        self.sync()
        ops.reset_launches()

    def end(self):
        from repro_torch.kernels import ops
        self.sync()
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        for k, v in got.items():
            self.total[k] = self.total.get(k, 0) + v
        return (got, {k: v for k, v in ops.FLASH_FORMS.items() if v},
                {k: v for k, v in ops.FLASH_BWD_FORMS.items() if v})

    def run(self, fn):
        self.begin()
        out = fn()
        return (out, *self.end())


def lm_mesh_parity(mesh, rank: int, counted, small: bool) -> dict:
    """Phase 13 (a) on one rank: LM_ARCH at its published widths and
    PARITY_LAYERS layers in fp32, phase 6 (a)'s numpy params; every call
    on params laid out by `tree_shardings` (the batch by `batch_pspec`)
    against the same call on this rank with no mesh."""
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.lm import LM
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding as sh

    full, pcfg = _lm_mesh_configs(small)
    plm = LM(pcfg)
    dev = torch.device(mesh.device_type)
    cpu_params, _, toks, forced, _ = lm_parity_inputs(plm)
    params = tree_map(lambda t: t.to(dev), cpu_params)
    L, m = pcfg.n_layers, mesh.get_local_rank("model")
    out = {}

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    def worst(got, want, what, tol, of_max=False):
        """max |got - want| over the leaves, each held at `tol` (of the
        leaf's largest |want| with `of_max`)."""
        err = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            a = sh.full_tensor(a).float()
            b = b.float()
            atol = tol * float(b.abs().max()) if of_max else tol
            d = (a - b).abs()
            if not bool(torch.isfinite(a).all()) or bool(
                    (d > atol + (0 if of_max else tol) * b.abs()).any()):
                raise AssertionError(f"rank {rank} {what} leaf {i}: max "
                                     f"|err| {d.max().item():.3e}")
            err = max(err, d.max().item() / (
                float(b.abs().max()) if of_max else 1.0))
        return err

    # -- one train step, fp32 ---------------------------------------------------
    B, S = LM_MESH_TRAIN
    b = TokenDataset(vocab=pcfg.vocab, seq_len=S, global_batch=B,
                     seed=0).batch(0)
    b["labels"] = b["labels"].copy()     # a view of the inputs' tokens
    b["labels"][0, :5] = -1
    batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    s_batch = {k: sh.device_put(v, sh.NamedSharding(
        mesh, sh.batch_pspec(mesh, v.dim(), 0, B))) for k, v in batch.items()}
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=10)
    n_micro = steps.effective_microbatches(pcfg, B, mesh)
    step = steps.make_train_step(pcfg, ocfg, n_micro)
    want_p, _, want_m = step(params, adamw_init(params, ocfg), batch)
    s_params = sh.device_put(params, sh.tree_shardings(params, mesh))
    opt = adamw_init(params, ocfg)
    s_opt = sh.device_put(opt, sh.tree_shardings(opt, mesh))
    (got_p, _, got_m), launches, forms, bwd = counted.run(
        lambda: step(s_params, s_opt, s_batch))
    want_l = {"flash_attention": 2 * L * n_micro,      # remat: twice
              "flash_attention_backward": L * n_micro}
    if dev.type == "cuda" and launches != want_l:
        raise AssertionError(f"rank {rank} lm mesh step: launches "
                             f"{launches}, expected {want_l}")
    loss_err = rel(got_m["loss"], want_m["loss"])
    if loss_err > LM_MESH_LOSS_RTOL:
        raise AssertionError(f"rank {rank} lm mesh step: loss "
                             f"{float(got_m['loss'])} vs "
                             f"{float(want_m['loss'])}")
    out["train_step"] = {
        "microbatches": n_micro, "launches": launches, "forms": forms,
        "backward_forms": bwd, "loss": float(got_m["loss"]),
        "loss_rel_err": loss_err, "loss_bound": LM_MESH_LOSS_RTOL,
        "params_max_abs_err": worst(tree_leaves(got_p), tree_leaves(want_p),
                                    "step params", LM_MESH_PARAM_TOL),
        "params_bound": LM_MESH_PARAM_TOL}
    del got_p, want_p, s_opt, opt

    # -- the loss and every gradient, fp32 and bf16 -----------------------------
    for dtype, tol in (("float32", LM_MESH_GRAD_TOL),
                       ("bfloat16", LM_TRAIN_TOL["bfloat16"])):
        lm = LM(pcfg.scaled(dtype=dtype))
        (w_loss, _), w_grads = steps.loss_and_grads(
            lm, params, batch["inputs"], batch["labels"])
        P = tree_map(lambda t: sh.as_sharded(t, mesh), s_params)
        ((g_loss, _), g_grads), launches, forms, bwd = counted.run(
            lambda: steps.loss_and_grads(lm, P, batch["inputs"],
                                         batch["labels"]))
        got = [sh.Sharded(g, mesh, p.spec) for g, p in
               zip(tree_leaves(g_grads), tree_leaves(P))]
        out[f"grads_{dtype}"] = {
            "launches": launches, "forms": forms, "backward_forms": bwd,
            "loss_rel_err": rel(g_loss, w_loss),
            "grads_max_err_of_leaf_max": worst(
                got, tree_leaves(w_grads), f"{dtype} gradients", tol,
                of_max=True), "bound": tol}
        if dtype == "float32" and out[f"grads_{dtype}"]["loss_rel_err"] > \
                LM_MESH_LOSS_RTOL:
            raise AssertionError(f"rank {rank} lm mesh loss: {g_loss} vs "
                                 f"{w_loss}")
        del w_grads, g_grads, got

    # -- prefill and decodes, both layouts ---------------------------------------
    P_len = toks.shape[1]
    max_len = 2 * (P_len + MESH_DECODES // 2)   # the last half in block 1
    for layout in ("train", "tp"):
        sp = sh.device_put(params, sh.tree_shardings(params, mesh,
                                                     serve=layout == "tp"))
        errs, calls = [], []
        with torch.no_grad():
            want = plm.prefill(params, torch.from_numpy(toks).to(dev),
                               max_len)
            got, launches, forms, _ = counted.run(lambda: plm.prefill(
                sp, torch.from_numpy(toks).to(dev), max_len))
            calls.append((launches, forms))
            for i in range(MESH_DECODES + 1):
                ck = got[1]["k"]
                errs.append(max(
                    worst([got[0]], [want[0]], f"{layout} call {i} logits",
                          PARITY_TOL),
                    *(worst([got[1][n].local],
                            [sh.local(want[1][n], mesh, ck.spec)],
                            f"{layout} call {i} cache {n}", PARITY_TOL)
                      for n in ("k", "v"))))
                if i == MESH_DECODES:
                    break
                tok = torch.from_numpy(forced[i].astype(np.int32)).to(dev)
                want = plm.decode_step(params, want[1], tok)
                got, launches, forms, _ = counted.run(
                    lambda: plm.decode_step(sp, got[1], tok))
                calls.append((launches, forms))
        # One launch per layer per call, on the rank's heads (prefill) or
        # its sequence block (decode: none while the block has no key).
        live = [1] + [int(P_len + i >= m * (max_len // 2))
                      for i in range(MESH_DECODES)]
        want_calls = [({"flash_attention": L} if n else {},
                       {("tile" if i == 0 else "split"): L} if n else {})
                      for i, n in enumerate(live)]
        if dev.type == "cuda" and calls != want_calls:
            raise AssertionError(f"rank {rank} lm mesh {layout}: launches "
                                 f"{calls}, expected {want_calls}")
        out[f"serve_parity_{layout}"] = {
            "max_len": max_len, "cache_block": list(got[1]["k"].local.shape),
            "cache_spec": [list(e) if isinstance(e, tuple) else e
                           for e in got[1]["k"].spec],
            "calls_with_launches": sum(live), "max_abs_err": max(errs),
            "tol": PARITY_TOL}
    return out


def _logit_stats(logits, keep: bool = False) -> dict:
    """Each row's argmax, top two tokens, top logit and top-2 margin of
    a call's logits (B, 1, V), whether all are finite, and with `keep`
    the logits (B, V) on the host."""
    top = logits[:, 0].float().topk(2, dim=-1)
    out = {"argmax": logits[:, 0].argmax(-1).tolist(),
           "top2": top.indices.tolist(), "top": top.values[:, 0].tolist(),
           "margin": (top.values[:, 0] - top.values[:, 1]).tolist(),
           "finite": bool(torch.isfinite(logits).all())}
    if keep:
        out["logits"] = logits[:, 0].float().cpu()
    return out


def _timed_engine(eng, sync, keep_logits: bool = False):
    """Wrap `eng`'s prefill and decode: per call the host wall ms (synced
    on both sides: a sharded call waits on its collectives anyway), the
    cache length it met, each row's argmax, top two tokens, top logit
    and top-2 margin, and with `keep_logits` the logits (B, V) on the
    host."""
    eng.calls = []

    def wrap(kind, fn):
        def call(*args):
            clen = args[1]["len"] if kind == "decode" else 0
            sync()
            t0 = time.perf_counter()
            logits, cache = fn(*args)
            sync()
            eng.calls.append({"kind": kind, "len": clen,
                              "ms": (time.perf_counter() - t0) * 1e3}
                             | _logit_stats(logits, keep_logits))
            return logits, cache
        return call

    eng._prefill = wrap("prefill", eng._prefill)
    eng._decode = wrap("decode", eng._decode)
    return eng


def lm_mesh_serve(mesh, rank: int, counted, small: bool) -> dict:
    """Phase 13 (b) on one rank: the whole LM_ARCH in bf16 (params drawn
    by a card generator from LM_MESH_SEED, the same on every rank) through
    ServeEngine(mesh=, serve_sharding="tp", max_len=LM_MESH_MAX_LEN) on
    the first LM_MESH_REQUESTS of phase 6 (b)'s requests; rank 0 also
    serves them alone (no mesh).
    Every rank's greedy tokens must be the same; the share equal to the
    one-rank engine's is reported, with the margins at the first call
    whose argmax differs."""
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import ServeEngine

    full, _ = _lm_mesh_configs(small)
    dev = torch.device(mesh.device_type)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(LM_MESH_SEED)
    params = LM(full).init(gen, device=dev)
    n_req = LM_MESH_REQUESTS if not small else 4
    out = {"requests": n_req}
    alone = None
    if rank == 0:
        eng = _timed_engine(ServeEngine(full, params, batch=LM_BATCH,
                                        max_len=LM_MESH_MAX_LEN, device=dev),
                            sync)
        eng.generate(lm_requests(full.vocab)[:1])       # one-time costs
        eng.calls = []
        t0 = time.perf_counter()
        res = eng.generate(lm_requests(full.vocab)[:n_req])
        sync()
        alone = {"res": res, "wall": time.perf_counter() - t0,
                 "calls": eng.calls}
        del eng
    eng = _timed_engine(ServeEngine(full, params, batch=LM_BATCH,
                                    max_len=LM_MESH_MAX_LEN, device=dev,
                                    mesh=mesh, serve_sharding="tp"), sync)
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reqs = lm_requests(full.vocab)[:n_req]
    t0 = time.perf_counter()
    res, launches, forms, _ = counted.run(lambda: eng.generate(reqs))
    wall = time.perf_counter() - t0
    calls = eng.calls
    # One launch per layer per prefill (its heads) and per decode step
    # in which this rank's sequence block holds a live key.
    start = mesh.get_local_rank("model") * (LM_MESH_MAX_LEN // 2)
    n_pre = sum(c["kind"] == "prefill" for c in calls)
    n_live = sum(c["kind"] == "decode" and c["len"] >= start for c in calls)
    want_l = {"flash_attention": full.n_layers * (n_pre + n_live)}
    want_f = {k: v for k, v in (("wgmma", full.n_layers * n_pre),
                                ("split", full.n_layers * n_live)) if v}
    if cuda and (launches != want_l or forms != want_f):
        raise AssertionError(f"rank {rank} lm mesh serve: launches "
                             f"{launches} / {forms}, expected {want_l} / "
                             f"{want_f}")
    if not all(c["finite"] for c in calls) or sorted(res) != list(
            range(n_req)) or any(len(res[r.uid]) != r.max_new_tokens
                                 for r in reqs):
        raise AssertionError(f"rank {rank} lm mesh serve: a NaN or a "
                             f"request not answered in full")

    def ms(cs, kind):
        v = [c["ms"] for c in cs if c["kind"] == kind]
        return sum(v) / len(v)

    generated = sum(len(v) for v in res.values())
    out.update({
        "tokens": {str(k): v for k, v in res.items()},
        "prefills": n_pre, "decode_steps": len(calls) - n_pre,
        "decode_steps_with_live_keys": n_live, "launches": launches,
        "forms": forms, "wall_s": wall, "requests_per_s": n_req / wall,
        "generated_tokens_per_s": generated / wall,
        "ms_per_prefill": ms(calls, "prefill"),
        "ms_per_decode_step": ms(calls, "decode"),
        "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if cuda else None)})
    if alone is not None:
        same = sum(a == b for r in range(n_req)
                   for a, b in zip(res[r], alone["res"][r]))
        total = sum(len(v) for v in alone["res"].values())
        first = None
        for i, (a, b) in enumerate(zip(calls, alone["calls"])):
            if a["argmax"] != b["argmax"]:
                rows = [j for j, (x, y) in enumerate(zip(a["argmax"],
                                                         b["argmax"]))
                        if x != y]
                first = {"call": i, "kind": a["kind"], "rows": rows,
                         "sharded": [(a["argmax"][j], a["margin"][j])
                                     for j in rows],
                         "alone": [(b["argmax"][j], b["margin"][j])
                                   for j in rows]}
                break
        out["alone"] = {
            "token_share_equal": same / total, "first_disagreement": first,
            "wall_s": alone["wall"],
            "requests_per_s": n_req / alone["wall"],
            "ms_per_prefill": ms(alone["calls"], "prefill"),
            "ms_per_decode_step": ms(alone["calls"], "decode")}
    return out


def lm_mesh_train(mesh, rank: int, tmp: str, counted, small: bool) -> dict:
    """Phase 13 (c) on one rank: Trainer(mesh=) at LM_ARCH's published
    widths and LM_MESH_TRAIN_LAYERS layers (fp32 compute, so that (a)'s
    fp32 bounds apply; AdamW), seq LM_TRAIN_SEQ, global batch
    LM_TRAIN_BATCH in the config's microbatches: to step
    LM_MESH_TRAIN_STEPS // 2 (checkpoint) on the (2, 2) mesh, host 1
    (ranks 2, 3) lost there, restored onto `elastic_mesh(survivors(...))`
    (1, 2) and run to LM_MESH_TRAIN_STEPS; the first segment again on the
    (2, 2) mesh, its losses bit-equal; on the first survivor, the same
    run on one rank (no mesh) straight: losses and final params at (a)'s
    bounds."""
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import fault_tolerance as ft
    from repro_torch.train.trainer import Trainer, TrainerConfig

    full, _ = _lm_mesh_configs(small)
    cfg = full.scaled(n_layers=LM_MESH_TRAIN_LAYERS if not small else 2,
                      dtype="float32")    # (a)'s bounds are fp32 bounds
    seq = LM_TRAIN_SEQ if not small else 64
    dev = torch.device(mesh.device_type)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ds = TokenDataset(vocab=cfg.vocab, seq_len=seq,
                      global_batch=LM_TRAIN_BATCH, seed=0)
    steps_n, half = LM_MESH_TRAIN_STEPS, LM_MESH_TRAIN_STEPS // 2

    def trainer(m, ckpt_dir, total=steps_n):
        """A trainer whose steps record their ms and loss in `.log`."""
        tr = Trainer(cfg, ds, AdamWConfig(lr=3e-4, warmup_steps=1,
                                          total_steps=steps_n),
                     TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                   ckpt_every=half, log_every=1, keep_last=2,
                                   async_checkpoint=False,
                                   seed=LM_MESH_SEED), mesh=m, device=dev)
        tr.log, fn = [], tr.step_fn

        def step(*a):
            sync()
            t0 = time.perf_counter()
            r = fn(*a)
            loss = float(r[2]["loss"])
            tr.log.append(((time.perf_counter() - t0) * 1e3, loss))
            return r
        tr.step_fn = step
        return tr

    ckpt_dir = os.path.join(tmp, "lm_ckpt")
    tr = trainer(mesh, ckpt_dir)
    n_micro = tr.n_micro
    counted.begin()
    try:
        tr.run(fail_at_step=half)
        raise AssertionError("the host failure did not stop the run")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    launches, forms, bwd = counted.end()
    per_step = {"flash_attention": 2 * cfg.n_layers * n_micro,
                "flash_attention_backward": cfg.n_layers * n_micro}
    if cuda and launches != {k: v * half for k, v in per_step.items()}:
        raise AssertionError(f"rank {rank} lm mesh train: launches "
                             f"{launches}, expected {half} x {per_step}")
    ranks = ft.survivors(mesh, [1], devices_per_host=2)
    small_mesh = ft.elastic_mesh(ranks, model_parallel=2, device=dev.type)
    out = {"n_layers": cfg.n_layers, "dtype": cfg.dtype, "seq": seq,
           "global_batch": LM_TRAIN_BATCH, "microbatches": n_micro,
           "launches_per_step": per_step, "forms_first_segment": forms,
           "backward_forms_first_segment": bwd,
           "survivors": ranks, "elastic_mesh": list(small_mesh.shape),
           "ms_per_step_mesh": [m for m, _ in tr.log],
           "losses_mesh": [v for _, v in tr.log]}
    got = None
    if rank in ranks:
        tr2 = trainer(small_mesh, ckpt_dir)
        res, _, _, _ = counted.run(tr2.run)
        got = tree_map(sh.full_tensor, res["params"])
        out.update(resumed=[h["step"] for h in res["history"]],
                   losses_elastic=[v for _, v in tr2.log],
                   ms_per_step_elastic=[m for m, _ in tr2.log])
        del res, tr2
    del tr
    gc.collect()
    sh.barrier(mesh)
    # The first segment again, on the (2, 2) mesh: bit-equal losses.
    again = trainer(mesh, None, total=half)
    counted.run(again.run)
    out["rerun_losses"] = [v for _, v in again.log]
    out["ms_per_step_rerun"] = [m for m, _ in again.log]
    if out["rerun_losses"] != out["losses_mesh"]:
        raise AssertionError(f"rank {rank} lm mesh train: a rerun's losses "
                             f"{out['rerun_losses']} differ from "
                             f"{out['losses_mesh']}")
    del again
    gc.collect()
    if rank == ranks[0]:
        alone_tr = trainer(None, None)
        alone = alone_tr.run()
        want = [v for _, v in alone_tr.log]
        mine = out["losses_mesh"] + out["losses_elastic"]
        errs = [abs(a - b) / abs(b) for a, b in zip(mine, want)]
        p_err = 0.0
        for a, b in zip(tree_leaves(got), tree_leaves(alone["params"])):
            if not torch.allclose(a, b, rtol=LM_MESH_PARAM_TOL,
                                  atol=LM_MESH_PARAM_TOL):
                raise AssertionError(f"lm mesh train: params vs one rank: "
                                     f"{(a - b).abs().max().item():.3e}")
            p_err = max(p_err, (a - b).abs().max().item())
        if len(errs) != steps_n or max(errs) > LM_MESH_LOSS_RTOL:
            raise AssertionError(f"lm mesh train: losses {mine} vs one "
                                 f"rank's {want}")
        out.update(losses_alone=want, loss_rel_err=max(errs),
                   loss_bound=LM_MESH_LOSS_RTOL, params_max_abs_err=p_err,
                   params_bound=LM_MESH_PARAM_TOL,
                   ms_per_step_alone=[m for m, _ in alone_tr.log])
        del alone, alone_tr
    del got
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def lm_mesh_substrate(mesh, rank: int, tmp: str, counted) -> dict:
    """Phase 13 (d) on one rank: `gpipe` over a GPIPE[0]-stage ("stage",)
    mesh against the stages in sequence; `compressed_psum` over a (2, 2)
    ("pod", "data") mesh against `repro`'s arithmetic reckoned here (each
    pod's values plus zero error, quantized by max |x| / 127 with
    half-to-even rounding, dequantized, their mean over the pods); then
    (last: it re-forms the group) RunSupervisor on `cnn` with host 1
    (ranks 2, 3) lost at step 3, its final state against the fault-free
    run on one rank at the conv mesh bound."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.compression import compressed_psum
    from repro_torch.parallel.pipeline import gpipe
    from repro_torch.train.conv_trainer import ConvTrainer, ConvTrainerConfig
    from repro_torch.train.supervisor import RunSupervisor

    dev = torch.device(mesh.device_type)
    out = {}
    n_st, n_mb, mb, d = GPIPE
    rng = np.random.default_rng(17)
    ws = (rng.normal(size=(n_st, d, d)) / math.sqrt(d)).astype(np.float32)
    x = rng.normal(size=(n_mb, mb, d)).astype(np.float32)
    stages = make_mesh(range(MESH_RANKS), (n_st,), ("stage",),
                       device=dev.type)
    y = gpipe(stages, "stage", lambda w, h: torch.tanh(h @ w),
              torch.from_numpy(ws).to(dev), torch.from_numpy(x).to(dev),
              n_mb)
    ref = torch.from_numpy(x).to(dev)
    for s in range(n_st):
        ref = torch.tanh(ref @ torch.from_numpy(ws[s]).to(dev))
    err = (y - ref).abs().max().item()
    if err > 1e-5:
        raise AssertionError(f"rank {rank} gpipe: max |err| {err:.3e}")
    out["gpipe"] = {"stages": n_st, "microbatches": n_mb,
                    "max_abs_err_vs_sequential": err, "tol": 1e-5}

    pods = make_mesh(range(MESH_RANKS), (2, 2), ("pod", "data"),
                     device=dev.type)
    g = rng.normal(size=(2, COMPRESS_N)).astype(np.float32)
    deq = []
    for p in range(2):
        scale = np.maximum(np.abs(g[p]).max(), np.float32(1e-12)) \
            / np.float32(127.0)
        q = np.clip(np.round(g[p] / scale), -127, 127).astype(np.int8)
        deq.append(q.astype(np.float32) * scale)
    want = (deq[0] + deq[1]) / np.float32(2.0)
    pod = pods.get_local_rank("pod")
    red, e = compressed_psum(torch.from_numpy(g[pod]).to(dev), pods, "pod",
                             torch.zeros(COMPRESS_N, device=dev))
    errs = (float(np.abs(red.cpu().numpy() - want).max()),
            float(np.abs(e.cpu().numpy() - (g[pod] - deq[pod])).max()))
    if max(errs) > 1e-6:
        raise AssertionError(f"rank {rank} compressed_psum: {errs}")
    out["compressed_psum"] = {"n": COMPRESS_N, "max_abs_err": errs[0],
                              "error_max_abs_err": errs[1], "tol": 1e-6,
                              "mean_abs_quantization_error": float(
                                  np.abs(want - g.mean(0)).mean())}

    cfg = dict(workload="cnn", total_steps=SUPERVISOR_STEPS,
               backend="cuda", ckpt_every=2, seed=0)
    sup = RunSupervisor(ConvTrainerConfig(**cfg, ckpt_dir=os.path.join(
        tmp, "sup_ckpt")), rendezvous=tmp, devices_per_host=2,
        model_parallel=2, host_schedule={3: [1]}, device=dev)
    t0 = time.perf_counter()
    res, launches, _, _ = counted.run(sup.run)
    rep = res["report"]
    out["supervisor"] = {"lost": bool(res.get("lost")), "report": rep,
                         "s": time.perf_counter() - t0, "launches": launches}
    if res.get("lost"):
        return out
    if rep["meshes"] != [{"data": 2, "model": 2}, {"data": 1, "model": 2}] \
            or rep["host_losses"] != 1 or rep["recompiles"] != 1 or \
            res["history"][-1]["step"] != SUPERVISOR_STEPS:
        raise AssertionError(f"rank {rank} supervisor: {rep}")
    state = tree_map(sh.full_tensor, res["state"])
    if dist.get_rank() == 0:
        clean = ConvTrainer(ConvTrainerConfig(**cfg), device=dev).run()
        err = 0.0
        for a, b in zip(tree_leaves(state), tree_leaves(clean["state"])):
            if not torch.allclose(a, b, rtol=MESH_RTOL, atol=MESH_ATOL):
                raise AssertionError(f"supervisor: state vs the fault-free "
                                     f"run: {(a - b).abs().max().item():.3e}")
            err = max(err, (a - b).abs().max().item())
        out["supervisor"]["state_max_abs_err_vs_fault_free"] = err
    return out


def lm_mesh_rank(rank: int, tmp: str, device: str = "cuda",
                 small: bool = False) -> None:
    """A spawned rank of phase 13: joins the `gloo` group through a
    `file://` store in `tmp`, runs (a)-(d) on a MESH_SHAPE mesh and writes
    its results to `tmp`.  Any failure raises in the rank, and the spawn
    raises it in the parent."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_debug_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=MESH_RANKS)
    try:
        mesh = make_debug_mesh(MESH_SHAPE, ("data", "model"), device=device)
        counted = _Counted(torch.cuda.synchronize if device == "cuda"
                           else (lambda: None))
        res = {"rank": rank, "coordinate": [mesh.get_local_rank(0),
                                            mesh.get_local_rank(1)]}
        seconds = {}
        for part, fn in (
                ("a", lambda: lm_mesh_parity(mesh, rank, counted, small)),
                ("b", lambda: lm_mesh_serve(mesh, rank, counted, small)),
                ("c", lambda: lm_mesh_train(mesh, rank, tmp, counted,
                                            small)),
                ("d", lambda: lm_mesh_substrate(mesh, rank, tmp, counted))):
            t0 = time.perf_counter()
            res[part] = fn()
            seconds[part] = time.perf_counter() - t0
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        res["seconds"] = seconds
        res["launches"] = counted.total
        with open(os.path.join(tmp, f"lm_rank_{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def lm_mesh_phase(card: str, device: str = "cuda",
                  small: bool = False) -> dict:
    """Phase 13: MESH_RANKS `gloo` ranks spawned on the one card
    (`lm_mesh_rank` in each); a rank's failure ends the phase with its
    error.  Prints each rank's results; every time is `gloo` ranks
    sharing one card, not a multi-card speed.  Returns the launches of
    the phase's main paths, summed over the ranks.  `small` narrows the
    model for a rehearsal on the CPU (`device="cpu"`)."""
    import torch.multiprocessing as mp

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(lm_mesh_rank, args=(tmp, device, small), nprocs=MESH_RANKS,
                 join=True)
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"lm_rank_{r}.json")) as f:
                ranks.append(json.load(f))
    tokens = [res["b"].pop("tokens") for res in ranks]
    if any(t != tokens[0] for t in tokens):
        raise AssertionError("lm mesh serve: the ranks' tokens differ")
    launches = {}
    for res in ranks:
        for k, v in res.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        print("lm mesh rank " + json.dumps(
            res | {"timing": f"{MESH_RANKS} gloo ranks sharing one card",
                   "card": card}))
    a, b, c = (ranks[0][k] for k in "abc")
    print(f"lm mesh: {LM_ARCH} on a {MESH_SHAPE} mesh of {MESH_RANKS} gloo "
          f"ranks sharing the card: (a) a train step's loss within "
          f"{a['train_step']['loss_rel_err']:.2e} (bound "
          f"{LM_MESH_LOSS_RTOL:g}) and params within "
          f"{a['train_step']['params_max_abs_err']:.2e} (bound "
          f"{LM_MESH_PARAM_TOL:g}) of one rank, prefill + decodes in both "
          f"layouts within {PARITY_TOL:g}; (b) {b['requests']} requests "
          f"served in the serve layout, "
          f"{b['alone']['token_share_equal']:.1%} of the greedy tokens equal "
          f"one rank's; (c) Trainer restored onto (1, 2) after a host loss, "
          f"losses within {c['loss_rel_err']:.2e} of one rank; (d) gpipe, "
          f"compressed_psum and RunSupervisor hold "
          f"({time.perf_counter() - t0:.1f} s)")
    return launches


# -- phase 14: the other LM families and the int8 cache on a mesh -----------

def _fm_config(arch: str, n_layers: int, small: bool, **kw):
    """`arch` at its published widths and `n_layers` layers, or with
    `small` (a CPU rehearsal) its SMOKE config at the SMOKE's depth."""
    from repro_torch.configs import get_config, get_smoke_config

    if small:
        return get_smoke_config(arch).scaled(**kw)
    return get_config(arch).scaled(n_layers=n_layers, **kw)


def _fm_inputs(cfg, small: bool):
    """Phase 6 (a)'s LM_BATCH prompts of 64-200 tokens (frames of the
    same lengths for an `embed_input` config, zeros in front), the
    MESH_DECODES forced tokens, and a max_len whose second sequence
    block takes the last MESH_DECODES // 2 decodes."""
    rng = np.random.default_rng(13)
    lens = rng.integers(*((4, 9) if small else (64, 201)), LM_BATCH)
    toks = np.zeros((LM_BATCH, int(lens.max())), np.int32)
    for i, n in enumerate(lens):
        toks[i, toks.shape[1] - n:] = rng.integers(1, cfg.vocab, n)
    if cfg.embed_input:
        toks = np.zeros((*toks.shape, cfg.d_model), np.float32)
        for i, n in enumerate(lens):
            toks[i, toks.shape[1] - n:] = rng.standard_normal(
                (n, cfg.d_model))
    forced = rng.integers(1, cfg.vocab, (MESH_DECODES, LM_BATCH, 1))
    return toks, forced, 2 * (toks.shape[1] + MESH_DECODES // 2)


def _fm_put(mesh, rank: int, draw, nbytes: int, **kw):
    """The params (`nbytes` of them whole) laid out by
    `tree_shardings(**kw)`: every rank draws the whole tree and keeps its
    blocks -- all at once where MESH_RANKS whole copies take at most half
    the card, else in turn."""
    import torch.distributed as dist

    from repro_torch.parallel import sharding as sh

    ps = None
    together = mesh.device_type != "cuda" or MESH_RANKS * nbytes <= \
        torch.cuda.get_device_properties(0).total_memory // 2
    for r in range(dist.get_world_size()):
        if r == rank or together:
            whole = draw()
            ps = sh.device_put(whole, sh.tree_shardings(whole, mesh, **kw))
            del whole
            gc.collect()
            if mesh.device_type == "cuda":
                torch.cuda.empty_cache()
        if together:
            break
        sh.barrier(mesh)
    return ps


@contextlib.contextmanager
def _unrounded_codes():
    """Record, in call order, every `kv_quantize` call's unrounded codes
    k / scale (fp32, on the host) while the block runs."""
    from repro_torch.models import layers

    seen, real = [], layers.kv_quantize

    def quantize(k):
        q, scale = real(k)
        seen.append((k.float() / scale[..., None]).cpu())
        return q, scale
    layers.kv_quantize = quantize
    try:
        yield seen
    finally:
        layers.kv_quantize = real


def _unrounded_cache(seen, cache, prompt_len: int) -> dict:
    """One device's unrounded codes laid out as its int8 cache's "k" and
    "v" (L, B, max_len, Hk, D): `seen` holds a prefill's k and v of each
    layer in turn, then each decode's, one position each."""
    out = {k: torch.zeros(cache[k].shape) for k in ("k", "v")}
    n = out["k"].shape[0]
    for j, r in enumerate(seen):
        call, rest = divmod(j, 2 * n)
        layer, k = divmod(rest, 2)
        at = prompt_len + call - 1 if call else 0
        out["kv"[k]][layer, :, at:at + r.shape[1]] = r
    return out


def fm_parity(mesh, rank: int, tmp: str, counted, arch: str, n_layers: int,
              layouts, small: bool, train: bool = True, **kw) -> dict:
    """Phase 14 (a) / (c) for one config on one rank, fp32 at published
    widths: rank 0 first runs it alone (the loss and every gradient at
    LM_TRAIN_PARITY, or FM_TRAIN's, with `train`; prefill and
    MESH_DECODES decodes) and saves the results to `tmp`; then on each
    layout every rank runs the same calls on its blocks and holds each
    of its blocks against the same block of rank 0's results (read from
    the file: no collective): the loss at LM_MESH_LOSS_RTOL, every
    gradient at LM_MESH_GRAD_TOL of its leaf's max, the MoE aux loss,
    the logits and the cache at PARITY_TOL per call (int8: each decode's
    logits against one rank's from the mesh's codes, and against one
    rank's own run within the int8 cache's own drift (that call's
    largest |difference| from an unquantized cache's); the codes equal to
    one rank's own run's or one apart where its unrounded code lies
    within KV_TIE_TOL of a half, their scales at KV_SCALE_RTOL); launches
    and forms per rank: one
    flash_attention per attention layer per prefill (tile) and per
    decode whose sequence block holds a key (split), twice per training
    forward and one backward."""
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.lm import LM
    from repro_torch.parallel import sharding as sh

    t_start = time.perf_counter()
    dev = torch.device(mesh.device_type)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = _fm_config(arch, n_layers, small, dtype="float32", **kw)
    lm = LM(cfg)
    toks, forced, max_len = _fm_inputs(cfg, small)
    prompt = torch.from_numpy(toks).to(dev)
    n_attn = attention_layers(cfg)
    B, S = FM_TRAIN.get(arch, LM_TRAIN_PARITY) if not small else (2, 24)
    batch = TokenDataset(vocab=cfg.vocab, seq_len=S, global_batch=B,
                         seed=21, embed_dim=cfg.d_model if cfg.embed_input
                         else None).batch(0)
    labels = batch["labels"].copy()
    labels[0, :7] = -1
    inputs = torch.from_numpy(batch["inputs"]).to(dev)
    labels = torch.from_numpy(labels).to(dev)
    ref_path = os.path.join(tmp, "fm_reference.pt")
    with torch.device("meta"):
        nbytes = sum(t.numel() * 4 for t in tree_leaves(lm.init_tree(
            torch.Generator())))

    def draw():
        return family_params(cfg, FM_SEED, device=dev.type)

    def host(out):
        """A call's logits and cache, copied to the host (the next decode
        writes the cache in place)."""
        return out[0].to("cpu", copy=True), {
            k: v.to("cpu", copy=True) for k, v in out[1].items()
            if k != "len"}

    def step(n):
        return torch.from_numpy(forced[n].astype(np.int32)).to(dev)

    out = {"arch": arch, "n_layers": cfg.n_layers, "kv_quant": cfg.kv_quant,
           "train_batch": B, "train_seq": S, "prompt_len": toks.shape[1],
           "max_len": max_len}
    if rank == 0:                     # one rank alone
        p, want = draw(), {}
        if train:
            sync()
            t0 = time.perf_counter()
            (loss, aux), grads = steps.loss_and_grads(lm, p, inputs, labels)
            sync()
            out["grad_ms_alone"] = (time.perf_counter() - t0) * 1e3
            print(f"phase 14: {arch}: one rank's gradients "
                  f"{out['grad_ms_alone']:.1f} ms", flush=True)
            want.update(loss=loss.item(), aux=float(aux["aux"]),
                        grads=[g.cpu() for g in tree_leaves(grads)],
                        grad_max=[g.abs().max().item()
                                  for g in tree_leaves(grads)])
            del grads
        with torch.no_grad(), _unrounded_codes() as seen:
            o = lm.prefill(p, prompt, max_len)
            calls = [host(o)]
            for i in range(MESH_DECODES):
                o = lm.decode_step(p, o[1], step(i))
                calls.append(host(o))
        want["calls"] = calls
        if cfg.kv_quant:
            want["unrounded"] = _unrounded_cache(seen, o[1], toks.shape[1])
            # The int8 cache's own drift: each decode's logits against
            # the same model's with an unquantized cache.
            plain = LM(cfg.scaled(kv_quant=False))
            with torch.no_grad():
                o = plain.prefill(p, prompt, max_len)
                want["drift"] = [0.0]
                for i in range(MESH_DECODES):
                    o = plain.decode_step(p, o[1], step(i))
                    want["drift"].append(
                        (o[0].cpu() - calls[i + 1][0]).abs().max().item())
        t0 = time.perf_counter()
        torch.save(want, ref_path)
        out["save_s"] = time.perf_counter() - t0
        del p, o, want, calls
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    sh.barrier(mesh)
    want = torch.load(ref_path, mmap=True, weights_only=True)

    def hold(got, ref, what, unrounded=None, rtol=PARITY_TOL,
             atol=PARITY_TOL):
        """This rank's block `got` against `ref`, the same block of rank
        0's result (on the host); the largest |err| (int8: the count of
        codes 1 apart, each only where rank 0's `unrounded` code lies
        within KV_TIE_TOL of the half between them)."""
        ref = ref.to(got.device)
        if unrounded is not None:
            d = (got.int() - ref.int()).abs()
            off = d == 1
            gap = (unrounded.to(got.device) - 0.5
                   - torch.minimum(got, ref).float()).abs()
            if d.numel() and (int(d.max()) > 1 or bool(
                    (gap[off] > KV_TIE_TOL).any())):
                raise AssertionError(
                    f"rank {rank} {what}: int8 codes {int(d.max())} apart, "
                    f"{int(off.sum())} one apart, the farthest of them "
                    f"{float(gap[off].max()) if off.any() else 0.0:.3e} "
                    f"from a tie")
            return float(off.sum())
        d = (got.float() - ref.float()).abs()
        if not bool(torch.isfinite(got).all()) or bool(
                (d > atol + rtol * ref.float().abs()).any()):
            raise AssertionError(f"rank {rank} {what}: max |err| "
                                 f"{d.max().item():.3e}")
        return d.max().item() if d.numel() else 0.0

    m = mesh.get_local_rank("model")
    # The int8 cache: a value at a rounding tie quantizes one way on the
    # mesh and the other on one rank, and later calls read the codes; so,
    # as phase 10 (a) does, each decode is held against one rank's decode
    # from a copy of the mesh's cache (every rank holds the small model
    # whole for it), and one rank's own run only by its cache.
    alone = draw() if cfg.kv_quant else None
    for layout in layouts:
        t_layout = time.perf_counter()
        name = f"{arch}{' kv_quant' if cfg.kv_quant else ''} {layout}"
        ps = _fm_put(mesh, rank, draw, nbytes, **FM_LAYOUTS[layout])
        row = {"put_s": time.perf_counter() - t_layout}
        if train and layout == "train":
            P = tree_map(lambda t: sh.as_sharded(t, mesh), ps)
            sync()
            t0 = time.perf_counter()
            ((loss, aux), grads), launches, forms, bwd = counted.run(
                lambda: steps.loss_and_grads(lm, P, inputs, labels))
            row["grad_ms_mesh"] = (time.perf_counter() - t0) * 1e3
            want_l = {"flash_attention": 2 * n_attn,
                      "flash_attention_backward": n_attn} if n_attn else {}
            if cuda and launches != want_l:
                raise AssertionError(f"rank {rank} {name} gradients: "
                                     f"launches {launches}, expected "
                                     f"{want_l}")
            g_err = 0.0
            for i, (g, p_) in enumerate(zip(tree_leaves(grads),
                                            tree_leaves(P))):
                big = max(want["grad_max"][i], 1e-30)
                g_err = max(g_err, hold(
                    g, sh.local(want["grads"][i], mesh, p_.spec),
                    f"{name} gradient {i}", rtol=0.0,
                    atol=LM_MESH_GRAD_TOL * big) / big)
            del grads, P
            l_err = abs(loss.item() - want["loss"]) / abs(want["loss"])
            a_err = abs(float(aux["aux"]) - want["aux"]) / max(
                abs(want["aux"]), 1e-30)
            if l_err > LM_MESH_LOSS_RTOL or (cfg.n_experts and
                                             a_err > LM_MESH_LOSS_RTOL):
                raise AssertionError(f"rank {rank} {name}: loss "
                                     f"{loss.item()} / aux {float(aux['aux'])}"
                                     f" vs one rank's {want['loss']} / "
                                     f"{want['aux']}")
            row.update(loss=loss.item(), loss_rel_err=l_err,
                       aux=float(aux["aux"]), aux_rel_err=a_err,
                       grads_max_err_of_leaf_max=g_err,
                       hold_s=time.perf_counter() - t0 - row["grad_ms_mesh"]
                       / 1e3,
                       grad_bound=LM_MESH_GRAD_TOL, train_launches=launches,
                       train_forms=forms, train_backward_forms=bwd,
                       train_s=time.perf_counter() - t0)
        errs, codes_apart, calls = [], 0.0, []
        t0 = time.perf_counter()
        with torch.no_grad():
            got = None
            for i in range(MESH_DECODES + 1):
                same = None
                if i == 0:
                    got, launches, forms, _ = counted.run(
                        lambda: lm.prefill(ps, prompt, max_len))
                else:
                    if alone is not None:
                        held = {k: sh.full_tensor(c).clone() if k != "len"
                                else c for k, c in got[1].items()}
                    got, launches, forms, _ = counted.run(
                        lambda: lm.decode_step(ps, got[1], step(i - 1)))
                    if alone is not None:
                        same = lm.decode_step(alone, held, step(i - 1))[0]
                calls.append((launches, forms))
                logits, cache = want["calls"][i]
                if same is not None:
                    row["logits_max_abs_err_own_cache"] = max(
                        row.get("logits_max_abs_err_own_cache", 0.0),
                        hold(got[0], logits, f"{name} call {i} logits "
                             f"against one rank's own run", rtol=0.0,
                             atol=want["drift"][i]))
                    row["own_cache_bound_min"] = min(row.get(
                        "own_cache_bound_min", math.inf), want["drift"][i])
                    logits = same
                e = hold(got[0], logits, f"{name} call {i} logits")
                for k, c in got[1].items():
                    if k == "len":
                        continue
                    ref = sh.local(cache[k], mesh, c.spec)
                    if c.local.dtype == torch.int8:
                        codes_apart += hold(
                            c.local, ref, f"{name} call {i} {k}",
                            unrounded=sh.local(want["unrounded"][k], mesh,
                                               c.spec))
                    elif k.endswith("scale"):
                        hold(c.local, ref, f"{name} call {i} {k}",
                             rtol=KV_SCALE_RTOL, atol=0.0)
                    else:
                        e = max(e, hold(c.local, ref, f"{name} call {i} {k}"))
                errs.append(e)
        live = [1] + [int(toks.shape[1] + i >= m * (max_len // 2))
                      for i in range(MESH_DECODES)]
        want_calls = [({"flash_attention": n_attn} if n and n_attn else {},
                       {("tile" if i == 0 else "split"): n_attn}
                       if n and n_attn else {})
                      for i, n in enumerate(live)]
        if cuda and calls != want_calls:
            raise AssertionError(f"rank {rank} {name}: launches {calls}, "
                                 f"expected {want_calls}")
        row.update(max_abs_err=max(errs), tol=PARITY_TOL,
                   calls_with_launches=sum(live) if n_attn else 0,
                   int8_codes_one_apart=codes_apart,
                   int8_tie_tol=KV_TIE_TOL if cfg.kv_quant else None,
                   calls_s=time.perf_counter() - t0,
                   cache_specs={k: [list(e_) if isinstance(e_, tuple) else e_
                                    for e_ in c.spec]
                                for k, c in got[1].items() if k != "len"})
        out[layout] = row
        del ps, got
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        if rank == 0:
            print(f"phase 14: {name}: {time.perf_counter() - t_layout:.1f} s "
                  + json.dumps({k: v for k, v in row.items()
                                if k.endswith(("_s", "_ms_mesh"))}),
                  flush=True)
    del want, alone
    sh.barrier(mesh)
    if rank == 0:
        os.remove(ref_path)
    out["seconds"] = time.perf_counter() - t_start
    return out


def _uncounted(fn):
    """fn(), its kernel launches left out of the counts (a reference call
    made inside a counted main path)."""
    from repro_torch.kernels import ops

    counts = (ops.LAUNCHES, ops.FLASH_FORMS, ops.FLASH_BWD_FORMS)
    saved = [dict(c) for c in counts]
    try:
        return fn()
    finally:
        for c, v in zip(counts, saved):
            c.update(v)


@contextlib.contextmanager
def _routes(force=None):
    """Within the block, every `models.moe.route` call's router logits
    and expert indices are recorded in `log["logits"]`, `log["idx"]` (on
    the host).  With `force` (another run's log) each call takes that
    run's choices instead, its gate values its own probs of them,
    renormalized, and its router logits are held against that run's:
    the largest |difference| as a share of its own largest |router
    logit| in `log["worst"]` (FM_SERVE_TOL bounds it, as it bounds the
    logits); the tokens whose choices so moved in `log["moved"]`, and
    the widest such move, its k-th router logit less the lowest forced
    one, in eps of the k-th (`log["gap_eps"]`)."""
    from repro_torch.models import moe

    real = moe.route
    log = {"idx": [], "logits": [], "moved": 0, "worst": 0.0,
           "gap_eps": 0.0}

    def route(params, x, cfg):
        probs, vals, idx = real(params, x, cfg)
        logits = (x @ params["router"].to(x.dtype)).float()
        if force is not None:
            i = len(log["idx"])
            want = force["idx"][i].to(idx.device)
            if want.shape != idx.shape:
                raise AssertionError(f"route call {i}: {tuple(idx.shape)} "
                                     f"here, {tuple(want.shape)} to force")
            log["worst"] = max(log["worst"], float(
                (force["logits"][i].to(logits.device) - logits).abs().max()
                / logits.abs().max()))
            kth = logits.gather(-1, idx[..., -1:])
            gap = (kth - logits.gather(-1, want).amin(-1, keepdim=True)
                   ).clamp_min(0)
            log["moved"] += int((gap > 0).sum())
            log["gap_eps"] = max(log["gap_eps"], float(
                (gap / (torch.finfo(x.dtype).eps * kth.abs())).max()))
            idx = want
            vals = probs.gather(-1, idx)
            vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
        log["idx"].append(idx.cpu())
        if force is None:
            log["logits"].append(logits.cpu())
        return probs, vals, idx

    moe.route = route
    try:
        yield log
    finally:
        moe.route = real


def _serve_agreement(calls, alone_calls, dtype, tol: float) -> dict:
    """A sharded engine's `calls` held call by call against one rank's
    `alone_calls`, each made on the same inputs: each call's largest
    |logit error| as a share of one rank's largest |logit| (within
    `tol`), and every row whose argmax differs, with each side's top two
    tokens, top logit and top-2 margin; it passes only at a tie: on each
    side the two picks are its top two and lie within 2 eps of `dtype`
    of the top logit (FM_SERVE's note)."""
    eps = torch.finfo(dtype).eps
    errs, flips = [], []
    kinds = [c["kind"] for c in calls] == [c["kind"] for c in alone_calls]
    for i, (a, b) in enumerate(zip(calls, alone_calls)):
        errs.append((a["logits"] - b["logits"]).abs().max().item()
                    / b["logits"].abs().max().item())
        for j, (x, y) in enumerate(zip(a["argmax"], b["argmax"])):
            if x != y:
                flips.append({
                    "call": i, "kind": a["kind"], "row": j,
                    "sharded": (a["top2"][j], a["top"][j], a["margin"][j]),
                    "alone": (b["top2"][j], b["top"][j], b["margin"][j]),
                    "tie": all(set(c["top2"][j]) == {x, y} and
                               c["margin"][j] <= 2 * eps * abs(c["top"][j])
                               for c in (a, b))})
    return {"calls": len(calls), "same_calls": kinds,
            "rows": sum(len(c["argmax"]) for c in calls),
            "argmax_equal_share": 1 - len(flips) / max(
                sum(len(c["argmax"]) for c in calls), 1),
            "logits_max_err_of_max": max(errs), "bound": tol,
            "logits_err_of_max_per_call": errs, "flips": flips,
            "ok": kinds and len(calls) == len(alone_calls) and
            max(errs) <= tol and all(f["tie"] for f in flips)}


def fm_serve(mesh, rank: int, counted, arch: str, n_layers: int,
             small: bool) -> dict:
    """Phase 14 (b) for one model on one rank: `arch` at `n_layers` layers
    in bf16 (params from FM_SEED + 1, the same on every rank) through
    ServeEngine(mesh=, serve_sharding="tp", max_len=LM_MESH_MAX_LEN) on
    phase 6 (b)'s first FM_REQUESTS requests.  After each of the
    engine's calls rank 0 makes the same call alone on the same inputs
    -- its tokens and, for a decode, the mesh's cache gathered whole --
    with the mesh's MoE routing (`_routes`), and every call is held
    against it (`_serve_agreement`; its launches are not counted).  One
    flash_attention per attention layer per prefill and per decode step
    whose sequence block holds a key."""
    from repro_torch.models.lm import LM
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve.engine import ServeEngine

    t_start = time.perf_counter()
    cfg = _fm_config(arch, n_layers, small)
    dev = torch.device(mesh.device_type)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = family_params(cfg, FM_SEED + 1, torch.bfloat16, dev.type)
    max_len = LM_MESH_MAX_LEN if not small else 1280
    reqs = lm_requests(cfg.vocab)[:FM_REQUESTS]
    if small:   # short prompts for the CPU
        for r in reqs:
            r.prompt, r.max_new_tokens = r.prompt[:6], min(r.max_new_tokens,
                                                           6)
    out = {"arch": arch, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "requests": len(reqs)}

    def ms(cs, kind):
        v = [c["ms"] for c in cs if c["kind"] == kind]
        return sum(v) / len(v)

    eng = _timed_engine(ServeEngine(cfg, params, batch=LM_BATCH,
                                    max_len=max_len, device=dev, mesh=mesh,
                                    serve_sharding="tp"), sync,
                        keep_logits=rank == 0)
    if rank != 0:
        params = None           # the mesh engine holds its blocks
    lm, alone_calls = LM(cfg), []
    routing = {"calls": 0, "worst": 0.0, "moved": 0, "gap_eps": 0.0}

    def held(kind, fn):
        def call(*args):
            cache = None
            if kind == "decode":      # every rank joins the gathers
                cache = {k: v if k == "len" else sh.full_tensor(v).clone()
                         for k, v in args[1].items()}
            with _routes() as rec:
                got = fn(*args)
            if rank != 0:
                return got

            def alone():
                sync()
                t0 = time.perf_counter()
                with torch.no_grad(), _routes(force=rec) as forced:
                    o = lm.prefill(params, args[1], max_len) \
                        if kind == "prefill" else \
                        lm.decode_step(params, cache, args[2])
                sync()
                return {"kind": kind,
                        "ms": (time.perf_counter() - t0) * 1e3} | \
                    _logit_stats(o[0], keep=True), forced
            row, forced = _uncounted(alone)
            alone_calls.append(row)
            routing["calls"] += len(forced["idx"])
            routing["moved"] += forced["moved"]
            for k in ("worst", "gap_eps"):
                routing[k] = max(routing[k], forced[k])
            if len(forced["idx"]) != len(rec["idx"]):
                raise AssertionError(f"{arch}: {len(rec['idx'])} route "
                                     f"calls on the mesh, "
                                     f"{len(forced['idx'])} alone")
            return got
        return call

    eng._prefill = held("prefill", eng._prefill)
    eng._decode = held("decode", eng._decode)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res, launches, forms, _ = counted.run(lambda: eng.generate(reqs))
    wall = time.perf_counter() - t0
    calls = eng.calls
    del eng, params
    n_attn = attention_layers(cfg)
    start = mesh.get_local_rank("model") * (max_len // 2)
    n_pre = sum(c["kind"] == "prefill" for c in calls)
    n_live = sum(c["kind"] == "decode" and c["len"] >= start for c in calls)
    want_l = {"flash_attention": n_attn * (n_pre + n_live)} if n_attn else {}
    pre = "tile" if cfg.head_dim == 80 else "wgmma"
    want_f = {k: v for k, v in ((pre, n_attn * n_pre),
                                ("split", n_attn * n_live)) if v}
    if cuda and (launches != want_l or forms != want_f):
        raise AssertionError(f"rank {rank} {arch} mesh serve: launches "
                             f"{launches} / {forms}, expected {want_l} / "
                             f"{want_f}")
    if not all(c["finite"] for c in calls) or sorted(res) != list(
            range(len(reqs))) or any(len(res[r.uid]) != r.max_new_tokens
                                     for r in reqs):
        raise AssertionError(f"rank {rank} {arch} mesh serve: a NaN or a "
                             f"request not answered in full")
    out.update({"tokens": {str(k): v for k, v in res.items()},
                "prefills": n_pre, "decode_steps": len(calls) - n_pre,
                "decode_steps_with_live_keys": n_live, "launches": launches,
                "forms": forms, "wall_s": wall,
                "ms_per_prefill": ms(calls, "prefill"),
                "ms_per_decode_step": ms(calls, "decode")})
    if rank == 0:
        agree = _serve_agreement(calls, alone_calls, cfg.compute_dtype,
                                 FM_SERVE_TOL)
        agree.update(route_calls=routing["calls"],
                     router_logits_err_of_max=routing["worst"],
                     route_tokens_moved=routing["moved"],
                     route_widest_move_eps=routing["gap_eps"])
        out["alone"] = {"ms_per_prefill": ms(alone_calls, "prefill"),
                        "ms_per_decode_step": ms(alone_calls, "decode"),
                        "per_call": agree}
        if not agree["ok"] or routing["worst"] > FM_SERVE_TOL:
            raise AssertionError(f"{arch} mesh serve against one rank's "
                                 f"calls on the same inputs: {agree}")
    out["seconds"] = time.perf_counter() - t_start
    return out


def fm_trainer(mesh, rank: int, counted, small: bool) -> dict:
    """Phase 14 (d) on one rank: Trainer(mesh=) on moonshot-v1-16b-a3b at
    FM_TRAINER's (layers, seq, global batch, steps), fp32, one microbatch;
    rank 0 then runs the same trainer alone: each step's loss and MoE
    aux within LM_MESH_LOSS_RTOL of its."""
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_start = time.perf_counter()
    layers, seq, gb, n_steps = FM_TRAINER
    cfg = _fm_config("moonshot-v1-16b-a3b", layers, small, dtype="float32",
                     microbatch=1)
    seq = seq if not small else 24
    dev = torch.device(mesh.device_type)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ds = TokenDataset(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=0)

    def trainer(m):
        tr = Trainer(cfg, ds, AdamWConfig(lr=3e-4, warmup_steps=1,
                                          total_steps=n_steps),
                     TrainerConfig(total_steps=n_steps, log_every=1,
                                   seed=FM_SEED), mesh=m, device=dev)
        tr.log, fn = [], tr.step_fn

        def step(*a):
            sync()
            t0 = time.perf_counter()
            r = fn(*a)
            tr.log.append(((time.perf_counter() - t0) * 1e3,
                           float(r[2]["loss"]), float(r[2]["aux"])))
            return r
        tr.step_fn = step
        return tr

    tr = trainer(mesh)
    # The run's final params and optimizer state are dropped here: kept,
    # every rank would hold its blocks through rank 0's run alone below.
    launches, forms, bwd = counted.run(tr.run)[1:]
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "flash_attention_backward": cfg.n_layers}
    if cuda and launches != {k: v * n_steps for k, v in per_step.items()}:
        raise AssertionError(f"rank {rank} mesh trainer: launches "
                             f"{launches}, expected {n_steps} x {per_step}")
    out = {"n_layers": cfg.n_layers, "seq": seq, "global_batch": gb,
           "steps": n_steps, "launches_per_step": per_step, "forms": forms,
           "backward_forms": bwd, "ms_per_step_mesh": [m for m, *_ in tr.log],
           "losses_mesh": [v for _, v, _ in tr.log],
           "aux_mesh": [a for *_, a in tr.log]}
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank == 0:
        alone = trainer(None)
        alone.run()
        errs = [abs(a - b) / abs(b) for a, b in
                zip(out["losses_mesh"] + out["aux_mesh"],
                    [v for _, v, _ in alone.log] + [a for *_, a in alone.log])]
        if len(errs) != 2 * n_steps or max(errs) > LM_MESH_LOSS_RTOL or \
                min(out["aux_mesh"]) <= 0:
            raise AssertionError(f"mesh trainer: losses / aux "
                                 f"{out['losses_mesh']} / {out['aux_mesh']} "
                                 f"vs one rank's {alone.log}")
        out.update(losses_alone=[v for _, v, _ in alone.log],
                   aux_alone=[a for *_, a in alone.log],
                   rel_err=max(errs), bound=LM_MESH_LOSS_RTOL,
                   ms_per_step_alone=[m for m, *_ in alone.log])
        del alone
        gc.collect()
    out["seconds"] = time.perf_counter() - t_start
    return out


def fm_rank(rank: int, tmp: str, device: str = "cuda",
            small: bool = False) -> None:
    """A spawned rank of phase 14: joins the `gloo` group through a
    `file://` store in `tmp`, runs (a)-(d) on a MESH_SHAPE mesh and writes
    its results to `tmp`."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_debug_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=MESH_RANKS)
    try:
        mesh = make_debug_mesh(MESH_SHAPE, ("data", "model"), device=device)
        counted = _Counted(torch.cuda.synchronize if device == "cuda"
                           else (lambda: None))

        def part(fn, *args, **kw):
            """fn's result, with this rank's peak of allocated card
            memory in it (GB)."""
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            r = fn(mesh, rank, *args, **kw)
            r["peak_memory_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                                   if device == "cuda" else None)
            return r

        res = {"rank": rank, "a": [], "b": []}
        for arch, (n, layouts) in FM_PARITY.items():
            res["a"].append(part(fm_parity, tmp, counted, arch, n, layouts,
                                 small))
        for arch, n in FM_SERVE.items():
            res["b"].append(part(fm_serve, counted, arch, n, small))
            if rank == 0:
                print(f"phase 14: {arch} served: "
                      f"{res['b'][-1]['seconds']:.1f} s", flush=True)
        res["c"] = part(fm_parity, tmp, counted, LM_ARCH, FM_KVQ_LAYERS,
                        ("train", "tp"), small, train=False, kv_quant=True)
        res["d"] = part(fm_trainer, counted, small)
        if rank == 0:
            print(f"phase 14: trainer: {res['d']['seconds']:.1f} s",
                  flush=True)
        res["launches"] = counted.total
        with open(os.path.join(tmp, f"fm_rank_{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def families_mesh_phase(card: str, device: str = "cuda",
                        small: bool = False) -> dict:
    """Phase 14: MESH_RANKS `gloo` ranks spawned on the one card (`fm_rank`
    in each); a rank's failure ends the phase with its error.  Prints
    each rank's results (every time is `gloo` ranks sharing one card,
    not a multi-card speed) and returns the launches of the phase's main
    paths, summed over the ranks.  `small` runs the SMOKE configs on the
    CPU (`device="cpu"`) as a rehearsal."""
    import torch.multiprocessing as mp

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(fm_rank, args=(tmp, device, small), nprocs=MESH_RANKS,
                 join=True)
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"fm_rank_{r}.json")) as f:
                ranks.append(json.load(f))
    for i in range(len(FM_SERVE)):
        tokens = [res["b"][i].pop("tokens") for res in ranks]
        if any(t != tokens[0] for t in tokens):
            raise AssertionError(f"{ranks[0]['b'][i]['arch']} mesh serve: "
                                 f"the ranks' tokens differ")
    launches = {}
    for res in ranks:
        for k, v in res.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        print("families mesh rank " + json.dumps(
            res | {"timing": f"{MESH_RANKS} gloo ranks sharing one card",
                   "card": card}))
    a = ranks[0]["a"]
    if device == "cuda":
        # Every rank's peak of allocated memory, summed per part: above
        # what the four ranks held at once, below the card less what this
        # process and the five CUDA contexts hold.
        peak = {}
        for p in "abcd":
            for i in range(len(ranks[0][p]) if p in "ab" else 1):
                rows = [res[p][i] if p in "ab" else res[p] for res in ranks]
                peak[f"{p} {rows[0].get('arch', '')}".strip()] = sum(
                    r["peak_memory_gb"] for r in rows)
        print("families mesh memory " + json.dumps(
            {"sum_of_rank_peaks_gb": peak,
             "this_process_reserved_gb": torch.cuda.memory_reserved() / 1e9,
             "card_gb": torch.cuda.get_device_properties(0).total_memory
             / 1e9, "card": card}))
    print("families mesh seconds " + json.dumps(
        {"a": {r["arch"]: r["seconds"] for r in a},
         "b": {r["arch"]: r["seconds"] for r in ranks[0]["b"]},
         "c": ranks[0]["c"]["seconds"], "d": ranks[0]["d"]["seconds"],
         "card": card}))
    worst = max(r[k]["max_abs_err"] for res in ranks for r in res["a"]
                for k in FM_LAYOUTS if k in r)
    print(f"families mesh: {', '.join(FM_PARITY)} on a {MESH_SHAPE} mesh of "
          f"{MESH_RANKS} gloo ranks sharing the card: (a) the loss, every "
          f"gradient and prefill + {MESH_DECODES} decodes in each layout "
          f"equal one rank's (worst logits / cache "
          f"{worst:.2e}"
          f", atol = rtol = {PARITY_TOL:g}); (b) {', '.join(FM_SERVE)} served in the "
          f"serve layout, each call against one rank's on its inputs "
          f"(logits within "
          f"{[r['alone']['per_call']['logits_max_err_of_max'] for r in ranks[0]['b']]}"
          f" of their max, bound {FM_SERVE_TOL:g}; argmax equal shares "
          f"{[r['alone']['per_call']['argmax_equal_share'] for r in ranks[0]['b']]}"
          f", the rest at bf16 ties); (c) {LM_ARCH} with kv_quant "
          f"in both layouts; (d) Trainer on moonshot, losses and aux within "
          f"{ranks[0]['d']['rel_err']:.2e} of one rank "
          f"({time.perf_counter() - t0:.1f} s)")
    return launches


# -- phase 15: the dry-run ------------------------------------------------------

def dryrun_forms() -> list:
    """Phase 15 (a): each of DRYRUN_FORMS launched on the card (its
    kernel called directly: a comparison, counted nowhere) and run as its
    fake form on fake copies of the same operands.  The fake outputs'
    shapes, dtypes, strides and device type must equal the launch's, and
    the bytes the fake form allocates, each rounded to the allocator's
    512-byte granule, the allocator's peak during the launch (the pool
    emptied first, so every block is carved fresh)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import attention
    from repro_torch.launch.steps import TraceCounters

    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for form, dt, B, Sq, Sk, Hq, Hk, D, off, lse in DRYRUN_FORMS:
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for shape in ((B, Sq, Hq, D), (B, Sk, Hk, D),
                                 (B, Sk, Hk, D)))
        plan = attention.plan(dt, B, Sq, Sk, Hq, Hk, D)
        if lse is None:
            what = f"backward {form}"
            if attention.backward_plan(dt, B, Sq, Sk, Hq, Hk, D) != form:
                raise AssertionError(f"phase 15 (a) {what}: the plan picks "
                                     f"another form")
            out, l = attention.flash_attention_cuda(
                q, k, v, causal=True, q_offset=off, form=plan,
                return_lse=True)
            operands = (q, k, v, out, torch.randn_like(out), l)

            def call(*ts):
                return attention.flash_attention_backward_cuda(
                    *ts, causal=True, q_offset=off, form=form)
        else:
            what = f"forward {form}" + (" with lse" if lse else "")
            if plan.form != form:
                raise AssertionError(f"phase 15 (a) {what}: the plan picks "
                                     f"{plan.form}")
            operands = (q, k, v)

            def call(*ts):
                return attention.flash_attention_cuda(
                    *ts, causal=True, q_offset=off, form=plan,
                    return_lse=lse)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        real = call(*operands)
        torch.cuda.synchronize()
        real_bytes = torch.cuda.max_memory_allocated() - before
        counters = TraceCounters(granule=512)
        with FakeTensorMode() as mode:
            fakes = [mode.from_tensor(t) for t in operands]
            with counters:
                fake = call(*fakes)
        real, fake = ((t,) if isinstance(t, torch.Tensor) else tuple(t)
                      for t in (real, fake))
        got = [(tuple(t.shape), t.dtype, t.stride(), t.device.type)
               for t in fake]
        want = [(tuple(t.shape), t.dtype, t.stride(), t.device.type)
                for t in real]
        if got != want or counters.peak != real_bytes:
            raise AssertionError(f"phase 15 (a) {what}: fake {got}, "
                                 f"{counters.peak} B; launch {want}, "
                                 f"{real_bytes} B")
        rows.append({"form": what, "dtype": str(dt), "shape": [B, Sq, Sk, Hq,
                                                               Hk, D],
                     "outputs": [list(t.shape) for t in real],
                     "allocated_bytes": real_bytes})
        del real, fake, operands, fakes
    return rows


def dryrun_trace(_, arch: str, shape: str, tmp: str) -> None:
    """Phase 15 (b), a spawned process: `arch` x `shape` traced as rank 0
    of the 16 x 16 mesh (`launch/dryrun.py::run_cell`, a fake world of 256
    ranks) on fake tensors; the record written into `tmp`."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun

    dryrun.run_cell(arch, shape, False, tmp)


def dryrun_card(_, tmp: str) -> None:
    """Phase 15 (a) and (c), a spawned process on the card: the fake forms
    against launches, then DRYRUN_REAL traced as rank 0 of the 16 x 16
    mesh in the fake world (each storage rounded to the allocator's
    512-byte granule) and its rank 0 run for real (zeros) there.  The
    bytes the real arguments take on the card must equal the trace's
    arguments, the allocator's rise from a reset to its peak the trace's
    temp, the peak the trace's arguments plus temp within
    DRYRUN_MEM_TOL (the cuBLAS workspace, which belongs to the process,
    made before the reset), and the launches by form the trace's fake
    forms' calls.  Writes {"forms", "trace", "real"} into `tmp`."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models.config import SHAPES

    forms = dryrun_forms()
    arch, shape = DRYRUN_REAL
    cfg, shp = get_config(arch), SHAPES[shape]
    dryrun.fake_world(256)
    t0 = time.perf_counter()
    want = lower_cell(cfg, shp, make_production_mesh(device="cpu")).trace(
        granule=512)
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    before_args = torch.cuda.memory_allocated()
    cell = lower_cell(cfg, shp, make_production_mesh(), fake=False)
    torch.cuda.synchronize()
    args_bytes = torch.cuda.memory_allocated() - before_args
    for dt in (torch.float32, torch.bfloat16):
        torch.ones(64, 64, device="cuda", dtype=dt) @ \
            torch.ones(64, 64, device="cuda", dtype=dt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_reset = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    real = cell.trace()
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    predicted = want["argument_size_in_bytes"] + want["temp_size_in_bytes"]
    off = peak / predicted - 1.0
    if args_bytes != want["argument_size_in_bytes"]:
        raise AssertionError(f"phase 15 (c): the arguments take {args_bytes}"
                             f" B on the card, "
                             f"{want['argument_size_in_bytes']} B in the "
                             f"trace")
    if peak - at_reset != want["temp_size_in_bytes"]:
        raise AssertionError(f"phase 15 (c): the card rose {peak - at_reset}"
                             f" B from the reset, the trace's temp is "
                             f"{want['temp_size_in_bytes']} B")
    if abs(off) > DRYRUN_MEM_TOL:
        raise AssertionError(f"phase 15 (c): the card's peak {peak} B is "
                             f"{off:+.2%} from the trace's {predicted} B")
    if (real["launches"], real["attention_forms"]) != (
            want["launches"], want["attention_forms"]):
        raise AssertionError(f"phase 15 (c): launches {real['launches']} "
                             f"{real['attention_forms']}, the trace's "
                             f"{want['launches']} {want['attention_forms']}")
    res = {"forms": forms, "trace": want, "real": {
        "max_memory_allocated": peak, "allocated_at_reset": at_reset,
        "arguments_on_card": args_bytes,
        "cublas_workspace": at_reset - before_args - args_bytes,
        "rise_from_reset": peak - at_reset,
        "trace_arguments": want["argument_size_in_bytes"],
        "trace_temp": want["temp_size_in_bytes"],
        "trace_arguments_plus_temp": predicted, "off": off,
        "launches": real["launches"],
        "attention_forms": real["attention_forms"],
        "collectives": real["collectives"], "trace_s": trace_s,
        "step_s": real_s}}
    with open(os.path.join(tmp, "card.json"), "w") as f:
        json.dump(res, f)


def dryrun_phase(card: str) -> dict:
    """Phase 15: DRYRUN_TRACED's traces and the card's checks
    (`dryrun_card`), three spawned processes at once; any failure raises.
    Prints each traced record beside `benchmarks/roofline.py`'s terms for
    the cell under the H100, and (a)'s and (c)'s results.  Returns the
    launches of (c)'s real run."""
    import torch.multiprocessing as mp

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.benchmarks import flops, roofline

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=dryrun_trace, args=(0, a, s, tmp))
                 for a, s in DRYRUN_TRACED]
        procs.append(ctx.Process(target=dryrun_card, args=(0, tmp)))
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        failed = [p.exitcode for p in procs if p.exitcode]
        if failed:
            raise AssertionError(f"phase 15: a process exited with {failed}")
        recs = []
        for a, s in DRYRUN_TRACED:
            with open(os.path.join(tmp, f"{a}.{s}.16x16.json")) as f:
                recs.append(json.load(f))
        with open(os.path.join(tmp, "card.json")) as f:
            res = json.load(f)
    hw = flops.H100_SXM
    for rec in recs:
        r = roofline.cell_roofline(rec["arch"], rec["shape"], hw)
        ranks = rec["n_devices"]
        coll = sum(v["bytes"] for k, v in rec["collectives"].items()
                   if k != "group_sizes")
        print("dryrun cell " + json.dumps(rec | {"card": card, "roofline": {
            k: r[k] for k in ("model_flops", "impl_flops", "compute_s",
                              "memory_s", "collective_s", "dominant")}
            | {"hardware": hw.name}, "trace_x_ranks": {
                "flops": rec["cost"]["flops"] * ranks,
                "collective_bytes": coll * ranks,
                "compute_s": rec["cost"]["flops"] / hw.peak_flops,
                "collective_s": coll / hw.link_bw}}))
    for row in res["forms"]:
        print("dryrun form " + json.dumps(row | {"card": card}))
    print("dryrun real " + json.dumps(res["real"] | {
        "cell": list(DRYRUN_REAL), "mesh": "16x16", "rank": 0,
        "card": card}))
    print(f"dryrun: {len(res['forms'])} fake forms equal their launches; "
          f"{len(recs)} production cells traced; {'/'.join(DRYRUN_REAL)}'s "
          f"rank 0 on the card took the trace's argument bytes and rose by "
          f"its temp bytes, peaking {res['real']['off']:+.2%} from it "
          f"(bound {DRYRUN_MEM_TOL:.0%}), its launches by form equal "
          f"({time.perf_counter() - t0:.1f} s)")
    return res["real"]["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.spec import ConvSpec, Epilogue
    from repro_torch.data.pipeline import ConvDataset
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, tiling
    from repro_torch.kernels.attention import (
        flash_attention_backward_cuda, flash_attention_backward_plain,
        flash_attention_cuda, flash_attention_plain)
    from repro_torch.kernels.attention import backward_plan as attn_bwd_plan
    from repro_torch.kernels.attention import plan as attn_plan
    from repro_torch.kernels.dconv_backward import TILES as BWD_TILES
    from repro_torch.kernels.dconv_backward import plan as backward_plan
    from repro_torch.kernels.dconv_backward import (conv_backward_plain,
                                                    tconv_backward_plain)
    from repro_torch.kernels.dconv_filtergrad import dconv_filter_grad_plain
    from repro_torch.kernels.dconv_forward import dconv_forward_plain
    from repro_torch.kernels.implicit_gemm import plan as ig_plan
    from repro_torch.kernels.implicit_gemm import tconv_implicit_gemm_plain
    from repro_torch.kernels.tconv_phase import tconv_fused_plain
    from repro_torch.models import cnn, gan, vision
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.lm import LM
    from repro_torch.serve.conv_engine import ConvRequest, ConvServeEngine
    from repro_torch.serve.engine import Request

    dev = torch.device("cuda")
    phase_s, t_mark = {}, [time.perf_counter()]

    def mark(phase):
        """Seconds since the previous mark, as the phase's time."""
        now = time.perf_counter()
        phase_s[phase] = now - t_mark[0]
        t_mark[0] = now
        print(f"phase {phase}: {phase_s[phase]:.1f} s", flush=True)

    card = card_line()
    print(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: off for cuDNN and torch.matmul (fp32 against fp32)")

    # -- phase 2: build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for label, regs, spills in ptxas_usage(log):
            print(f"  {name}: {label}: {regs} registers, {spills}")
    mark("1-2")

    # -- phase 3: each kernel against its plain version and the library -------
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def cotangent(B, hw, c):
        """A cotangent at scale 1/sqrt(B*Oh*Ow): each dW sum is O(1)."""
        return rand(B, *hw, c) / math.sqrt(B * hw[0] * hw[1])

    def output(ep, *shape):
        """A forward output the epilogue could give (tanh's in (-1, 1))."""
        act = Epilogue(activation=ep.activation, slope=ep.slope)
        return act.apply(rand(*shape)) if ep.needs_y else None

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def hwio(w_oihw):
        return w_oihw.permute(2, 3, 1, 0)

    relu, tanh = Epilogue(activation="relu"), Epilogue(activation="tanh")
    leaky = Epilogue(activation="leaky_relu", slope=0.2)
    ragged_ep = Epilogue(activation="leaky_relu", slope=0.2, bias=True,
                         scale=0.5)

    def plan_name(op, spec, B, hw, oh_ow, cin, cout, bias=False):
        """The tiles and splits `dconv_backward.plan` gives a launch: each
        role's tile (BM x BN), tiles and CTAs per tile.  `hw` is the big
        side (x, or the tconv's output n_out)."""
        p = backward_plan(op, spec, B, hw, oh_ow, cin, cout, n_out=hw,
                          bias=bias)
        gather = None if p.tile < 0 else "{} {}x{} {} x{}".format(
            "dx" if op in ("conv_backward", "tconv_phase") else
            "y" if op == "dconv_forward" else "ddy", *BWD_TILES[p.tile],
            p.tiles, p.splits)
        if p.dw_tile < 0:
            return gather
        dw = "dW {}x{} {} x{} (chunk {})".format(
            *BWD_TILES[p.dw_tile], p.dw_tiles, p.dw_splits, p.chunk)
        return dw if gather is None else f"{gather}, {dw}"

    def ig_plan_name(spec, B, n_out, in_hw, cin, cout, itemsize=4):
        """The tile, Cin tile, Cout chunk, CTAs and shared memory that
        `implicit_gemm.plan` gives a launch."""
        p = ig_plan(spec, B, n_out, in_hw, cin, cout, itemsize)
        return (f"tile {p.th}x{p.tw}, Cin {p.cin_t}, chunk {p.chunk} in "
                f"{p.stages} stage(s), {p.ctas} CTAs x {p.threads} threads, "
                f"{p.smem} B shared")

    def cast(dtype, *ts):
        return tuple(None if t is None else t.to(dtype) for t in ts)

    def dtype_keys(dtype):
        """A bf16 case's own keys: one bf16 ulp against the plain version,
        5e-2 against cuDNN, both of the output's largest magnitude; the
        bf16 tensor-core peak for its bound."""
        if dtype == torch.float32:
            return {}
        return dict(dtype="bf16", tol=BF16_TOL, lib_tol=BF16_LIB_TOL,
                    flops_per_s=BF16_FLOPS_PER_S)

    def tag(name, dtype):
        return name if dtype == torch.float32 else f"{name}_bf16"

    def fwd_case(name, B, hw, cin, cout, k, s, p, d, ep, path, timed=False,
                 dtype=torch.float32):
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
        x, w = cast(dtype, rand(B, *hw, cin),
                    rand(*spec.filter_shape, cin, cout))
        bias = rand(cout).to(dtype) if ep.bias else None
        w_lib = w.permute(3, 2, 0, 1).contiguous()   # one-time layout
        oh_ow = spec.out_size(hw)
        return dtype_keys(dtype) | dict(
                    kernel="dconv_forward", case=tag(name, dtype), path=path,
                    timed=path or timed, rerun=True,
                    form=plan_name("dconv_forward", spec, B, hw, oh_ow, cin,
                                   cout),
                    run=lambda: ops.dconv_forward(
                        x, w, stride=s, padding=p, dilation=d, bias=bias,
                        epilogue=ep),
                    plain=lambda: dconv_forward_plain(x, w, spec, bias=bias,
                                                      epilogue=ep),
                    lib=lambda: ep.apply(F.conv2d(
                        nchw(x), w_lib, bias=None, stride=spec.stride,
                        padding=spec.padding,
                        dilation=spec.dilation).permute(0, 2, 3, 1), bias),
                    macs=useful_macs(spec, B, oh_ow, hw, cin, cout),
                    nbytes=x.element_size() * (
                        x.numel() + w.numel()
                        + (cout if bias is not None else 0)
                        + B * oh_ow[0] * oh_ow[1] * cout))

    def tconv_case(kernel, name, B, in_hw, n_out, cin, cout, k, s, p, d, ep,
                   path, timed=False, w_scale=1.0, dtype=torch.float32):
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
        assert spec.out_size(n_out) == tuple(in_hw), (name, n_out)
        dy, w = cast(dtype, rand(B, *in_hw, cout),
                     rand(*spec.filter_shape, cin, cout) * w_scale)
        bias = rand(cin).to(dtype) if ep.bias else None
        w_lib = w.permute(3, 2, 0, 1).contiguous()   # one-time layout
        strategy = "implicit_gemm" if kernel == "tconv_implicit_gemm" \
            else "phase"
        plain = tconv_implicit_gemm_plain if kernel == "tconv_implicit_gemm" \
            else tconv_fused_plain
        exact = spec.input_size(in_hw)
        out_pad = tuple(n_out[a] - exact[a] for a in range(2))
        form = ig_plan_name(spec, B, n_out, in_hw, cin, cout,
                            dy.element_size()) \
            if strategy == "implicit_gemm" \
            else plan_name("tconv_phase", spec, B, n_out, in_hw, cin, cout)
        return dtype_keys(dtype) | dict(
                    kernel=kernel, case=tag(name, dtype), path=path,
                    timed=path or timed, rerun=True, form=form,
                    run=lambda: ops.tconv_phase(
                        dy, w, stride=s, padding=p, n_out=n_out, dilation=d,
                        bias=bias, epilogue=ep, strategy=strategy),
                    plain=lambda: plain(dy, w, spec, n_out=n_out, bias=bias,
                                        epilogue=ep),
                    lib=lambda: ep.apply(F.conv_transpose2d(
                        nchw(dy), w_lib, stride=spec.stride,
                        padding=spec.padding, output_padding=out_pad,
                        dilation=spec.dilation).permute(0, 2, 3, 1), bias),
                    macs=useful_macs(spec, B, in_hw, n_out, cin, cout),
                    nbytes=dy.element_size() * (
                        dy.numel() + w.numel()
                        + (cin if bias is not None else 0)
                        + B * n_out[0] * n_out[1] * cin))

    def backward_case(name, B, hw, cin, cout, k, s, p, d, ep, path,
                      timed=False, dtype=torch.float32):
        """conv_backward: (dx, dW[, db]) of y = ep(conv(x, w))."""
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
        oh_ow = spec.out_size(hw)
        x, w, dy, y = cast(dtype, rand(B, *hw, cin),
                           rand(*spec.filter_shape, cin, cout),
                           cotangent(B, oh_ow, cout),
                           output(ep, B, *oh_ow, cout))
        w_lib = w.permute(3, 2, 0, 1).contiguous()   # one-time layout
        geo = dict(stride=spec.stride, padding=spec.padding,
                   dilation=spec.dilation)

        def lib():
            m = ep.mask_cotangent(y, dy) if y is not None else dy
            g = nchw(m if ep.scale is None else m * ep.scale)
            dx = torch.nn.grad.conv2d_input((B, cin, *hw), w_lib, g, **geo)
            dw = torch.nn.grad.conv2d_weight(nchw(x), w_lib.shape, g, **geo)
            return (dx.permute(0, 2, 3, 1), hwio(dw)) + \
                ((m.sum(dim=(0, 1, 2)),) if ep.bias else ())

        macs = useful_macs(spec, B, oh_ow, hw, cin, cout)
        return dtype_keys(dtype) | dict(
                    kernel="conv_backward", case=tag(name, dtype), path=path,
                    timed=path or timed,
                    rerun=True, form=plan_name("conv_backward", spec, B, hw,
                                               oh_ow, cin, cout, ep.bias),
                    run=lambda: ops.conv_backward(x, dy, w, n_out=hw, y=y,
                                                  epilogue=ep, **geo),
                    plain=lambda: conv_backward_plain(
                        x, dy, w, spec, n_out=hw, y=y, epilogue=ep),
                    lib=lib, macs=2 * macs,
                    nbytes=x.element_size() * (
                        2 * x.numel() + 2 * w.numel() + dy.numel()
                        + (y.numel() if y is not None else 0)
                        + (cout if ep.bias else 0)))

    def ct_backward_case(name, B, hw, cin, cout, k, s, p, d, ep, path,
                         dtype=torch.float32):
        """tconv_backward: (ddy, dW[, db]) of z = ep(tconv(dy, w)), the
        cotangent g and z on the (B, *hw, cin) side."""
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
        oh_ow = spec.out_size(hw)
        g, z, dy, w = cast(dtype, rand(B, *hw, cin), output(ep, B, *hw, cin),
                           cotangent(B, oh_ow, cout),
                           rand(*spec.filter_shape, cin, cout))
        w_lib = w.permute(3, 2, 0, 1).contiguous()   # one-time layout
        geo = dict(stride=spec.stride, padding=spec.padding,
                   dilation=spec.dilation)

        def lib():
            m = ep.mask_cotangent(z, g) if z is not None else g
            gs = nchw(m if ep.scale is None else m * ep.scale)
            ddy = F.conv2d(gs, w_lib, **geo)
            dw = torch.nn.grad.conv2d_weight(gs, w_lib.shape, nchw(dy), **geo)
            return (ddy.permute(0, 2, 3, 1), hwio(dw)) + \
                ((m.sum(dim=(0, 1, 2)),) if ep.bias else ())

        macs = useful_macs(spec, B, oh_ow, hw, cin, cout)
        return dtype_keys(dtype) | dict(
                    kernel="tconv_backward", case=tag(name, dtype), path=path,
                    timed=path, rerun=True,
                    form=plan_name("tconv_backward", spec, B, hw, oh_ow, cin,
                                   cout, ep.bias),
                    run=lambda: ops.tconv_backward(g, dy, w, z=z, epilogue=ep,
                                                   **geo),
                    plain=lambda: tconv_backward_plain(g, dy, w, spec, z=z,
                                                       epilogue=ep),
                    lib=lib, macs=2 * macs,
                    nbytes=g.element_size() * (
                        g.numel() + (z.numel() if z is not None else 0)
                        + 2 * dy.numel() + 2 * w.numel()
                        + (cin if ep.bias else 0)))

    def filter_grad_case(name, B, hw, cin, cout, k, s, p, d, path,
                         dtype=torch.float32):
        spec = ConvSpec.make(stride=s, padding=p, filter_shape=k, dilation=d)
        oh_ow = spec.out_size(hw)
        x, dy = cast(dtype, rand(B, *hw, cin), cotangent(B, oh_ow, cout))
        w_shape = (cout, cin, *spec.filter_shape)
        geo = dict(stride=spec.stride, padding=spec.padding,
                   dilation=spec.dilation)
        return dtype_keys(dtype) | dict(
                    kernel="dconv_filter_grad", case=tag(name, dtype),
                    path=path, timed=path, rerun=True,
                    form=plan_name("filter_grad", spec, B, hw, oh_ow, cin,
                                   cout),
                    run=lambda: ops.dconv_filter_grad(
                        x, dy, k=spec.filter_shape, **geo),
                    plain=lambda: dconv_filter_grad_plain(x, dy, spec),
                    lib=lambda: hwio(torch.nn.grad.conv2d_weight(
                        nchw(x), w_shape, nchw(dy), **geo)),
                    macs=useful_macs(spec, B, oh_ow, hw, cin, cout),
                    nbytes=x.element_size() * (x.numel() + dy.numel()
                                               + math.prod(w_shape)))

    B = TRAIN_BATCH
    # The direct convs of the training path: discriminator c1-c3 (K = 4,
    # leaky_relu) and CNN layers 1-3 (K = 3, relu), all S = 2, P = 1.
    direct = [("disc_c1", (32, 32), 3, 32, 4, leaky),
              ("disc_c2", (16, 16), 32, 64, 4, leaky),
              ("disc_c3", (8, 8), 64, 128, 4, leaky),
              ("cnn_l1", (32, 32), 3, 32, 3, relu),
              ("cnn_l2", (16, 16), 32, 64, 3, relu),
              ("cnn_l3", (8, 8), 64, 128, 3, relu)]
    # The generator's transposed convs t1-t3 as (g side, Cin, Cout, ep).
    gen_layers = [("gan_t1", (8, 8), 64, 128, relu),
                  ("gan_t2", (16, 16), 32, 64, relu),
                  ("gan_t3", (32, 32), 3, 32, tanh)]
    cases, picks = [], {}

    def conv_cases(dtype):
        """The six conv kernels' cases in `dtype`: the paths' shapes and the
        plans' ragged edges, each race point's pick under its case name."""
        out, kw = [], dict(dtype=dtype)
        for Bs in (SLOT_BATCH, 64):
            path = Bs == SLOT_BATCH
            for r in (1, 2, 4):   # ASPP branches: 3x3, S=1, P=D=r, 3 -> 16
                out.append(fwd_case(f"aspp_rate{r}_B{Bs}", Bs, (128, 128), 3,
                                    16, 3, 1, r, r, relu, path, timed=True,
                                    **kw))
            # The generator's layers on both kernels of the phase /
            # implicit-GEMM race: the arm tiling.plan_strategy picks is the
            # path's, the other is timed for the race.  Each kernel's row
            # sums its three layers at the slot batch.
            for layer, in_hw, n_out, cin, cout, act in GEN_TCONVS:
                ep = Epilogue(activation=act)
                point = tag(f"{layer}_B{Bs}", dtype)
                picks[point] = tiling.plan_strategy(
                    "input_grad", ConvSpec.make(stride=2, padding=1,
                                                filter_shape=4),
                    x_shape=(Bs, *n_out, cin), dy_shape=(Bs, *in_hw, cout),
                    epilogue=ep, dtype=dtype)[0]
                for arm, kernel in TCONV_KERNELS.items():
                    out.append(tconv_case(
                        kernel, f"{layer}_B{Bs}_{arm}", Bs, in_hw, n_out, cin,
                        cout, 4, 2, 1, 1, ep, path, timed=True, **kw)
                        | {"race": point})
        for name, hw, cin, cout, k, ep in direct:
            out.append(fwd_case(f"{name}_B{B}", B, hw, cin, cout, k, 2, 1, 1,
                                ep, False, timed=True, **kw))
            out.append(backward_case(f"{name}_B{B}", B, hw, cin, cout, k, 2,
                                     1, 1, ep, True, **kw))
            out.append(filter_grad_case(f"{name}_B{B}", B, hw, cin, cout, k,
                                        2, 1, 1, True, **kw))
        for name, hw, cin, cout, ep in gen_layers:
            out.append(ct_backward_case(f"{name}_B{B}", B, hw, cin, cout, 4,
                                        2, 1, 1, ep, True, **kw))
        # Ragged geometries: bias fills, non-exact n_out, residues no tap
        # reaches (S=3 > K=2), stride and dilation sharing a factor,
        # channels that are not a multiple of the 32-lane reduction tile.
        out.append(fwd_case("ragged_fwd", 3, (37, 29), 5, 7, (3, 2), (2, 1),
                            (1, 2), (2, 3), ragged_ep, False, **kw))
        # The forwards' plan edges: reductions split over CTAs whose chunks
        # do not divide them (3 x 3 taps x 72 = 648, 14 ways of 48; the
        # tconv's longest class 4 taps x 72 = 288, 9 ways of 32), and
        # ragged channels (Cin 130, Cout 37) on both forward kernels.
        out.append(fwd_case("fwd_split_k648", 2, (8, 8), 72, 24, 3, 1, 1, 1,
                            ragged_ep, False, **kw))
        out.append(fwd_case("ragged_channels", 2, (9, 9), 130, 37, 3, 2, 1,
                            1, ragged_ep, False, **kw))
        for kernel in ("tconv_phase", "tconv_implicit_gemm"):
            # On the implicit GEMM: Cout over one chunk (72, 37; two
            # stages) and Cin over one thread's register tile (24, 130).
            out.append(tconv_case(kernel, "tconv_split_k648", 2, (4, 4),
                                  (8, 8), 24, 72, 3, 2, 1, 1, ragged_ep,
                                  False, **kw))
            out.append(tconv_case(kernel, "ragged_channels", 2, (5, 5),
                                  (9, 9), 130, 37, 3, 2, 1, 1, ragged_ep,
                                  False, **kw))
            out.append(tconv_case(kernel, "ragged_s3k2", 3, (5, 6), (14, 12),
                                  5, 7, (2, 3), (3, 2), (1, 1), 1, ragged_ep,
                                  False, **kw))
            out.append(tconv_case(kernel, "ragged_s2d2", 2, (6, 5), (14, 14),
                                  4, 6, 3, 2, 1, (2, 3), ragged_ep, False,
                                  **kw))
        # The backward plan's edges: 1183 positions, which the dW split
        # count does not divide, and Cin = 3 at B = 16 (ragged_channels is
        # the third).
        ragged = [("ragged_s3k2", 3, (14, 12), 5, 7, (2, 3), (3, 2), (1, 1),
                   1),
                  ("ragged_s2d2", 2, (14, 14), 4, 6, 3, 2, 1, (2, 3)),
                  ("ragged_channels", 2, (9, 9), 130, 37, 3, 2, 1, 1),
                  ("positions_1183", 7, (26, 26), 8, 16, 3, 2, 1, 1),
                  ("cin3_b16", 16, (32, 32), 3, 32, 4, 2, 1, 1)]
        for name, Bs, hw, cin, cout, k, s, p, d in ragged:
            out.append(backward_case(name, Bs, hw, cin, cout, k, s, p, d,
                                     ragged_ep, False, **kw))
            out.append(ct_backward_case(name, Bs, hw, cin, cout, k, s, p, d,
                                        ragged_ep, False, **kw))
            out.append(filter_grad_case(name, Bs, hw, cin, cout, k, s, p, d,
                                        False, **kw))
        return out

    cases += conv_cases(torch.float32)
    # Phase 8's geometries, held here before it trains on them: the atrous
    # head's branches (3 -> 16, D = P = 1, 2, 4, relu; the dx tile at N =
    # 3 with dilation) forward and backward, its 1x1 fuse conv's backward
    # (48 -> 4), and patchify's S = K = 14 conv (3 -> 1024; 196 residue
    # classes of one tap in the dx role) forward and backward.
    plain_ep = Epilogue()
    for r in (1, 2, 4):
        cases.append(fwd_case(f"atrous_rate{r}_B{ATROUS_BATCH}", ATROUS_BATCH,
                              (ATROUS_SIZE, ATROUS_SIZE), 3, 16, 3, 1, r, r,
                              relu, False, timed=True))
        cases.append(backward_case(
            f"atrous_rate{r}_B{ATROUS_BATCH}", ATROUS_BATCH,
            (ATROUS_SIZE, ATROUS_SIZE), 3, 16, 3, 1, r, r, relu, False,
            timed=True))
    cases.append(backward_case(f"atrous_fuse_B{ATROUS_BATCH}", ATROUS_BATCH,
                               (ATROUS_SIZE, ATROUS_SIZE), 48, 4, 1, 1, 0, 1,
                               plain_ep, False, timed=True))
    for make in (fwd_case, backward_case):
        cases.append(make(f"patchify_B{PATCH_BATCH}", PATCH_BATCH,
                          (PATCH_SIZE, PATCH_SIZE), 3, PATCH_D_MODEL, PATCH,
                          PATCH, 0, 1, plain_ep, False, timed=True))
    # The input gradients the planner races in phase 8, on both of its
    # arms at their analytical plans (weights at 1/sqrt(Kh*Kw*Cout), so
    # each output is of order 1).
    for name, cin, n, o, k, m, s, d in paper_layers():
        spec = paper_spec(n, o, k, s, d)
        picks[name] = tiling.plan_strategy(
            "input_grad", spec, x_shape=(PAPER_BATCH, n, n, cin),
            dy_shape=(PAPER_BATCH, o, o, m))[0]
        for arm, kernel in TCONV_KERNELS.items():
            cases.append(tconv_case(kernel, f"{name}_{arm}", PAPER_BATCH,
                                    (o, o), (n, n), cin, m, k, s,
                                    spec.padding, d, plain_ep, False,
                                    timed=True,
                                    w_scale=1.0 / math.sqrt(k * k * m))
                         | {"race": name})
    # The same conv cases on the kernels' bf16 entries, and the atrous
    # branches in bf16 (phase 8 trains them in fp32).
    cases += conv_cases(torch.bfloat16)
    for r in (1, 2, 4):
        for make in (fwd_case, backward_case):
            cases.append(make(f"atrous_rate{r}_B{ATROUS_BATCH}", ATROUS_BATCH,
                              (ATROUS_SIZE, ATROUS_SIZE), 3, 16, 3, 1, r, r,
                              relu, False, timed=True, dtype=torch.bfloat16))

    def attention_case(name, B, Sq, Sk, Hq, Hk, D, causal, dtype, path,
                       timed=False, cache_len=0):
        """flash_attention on (B,Sq,Hq,D) queries.  With `cache_len`, k and
        v are the live prefix [:, :Sk] of (B, cache_len, Hk, D) buffers,
        as a decode step passes its KV cache."""
        q = rand(B, Sq, Hq, D).to(dtype)
        if cache_len:
            k = rand(B, cache_len, Hk, D).to(dtype)[:, :Sk]
            v = rand(B, cache_len, Hk, D).to(dtype)[:, :Sk]
        else:
            k, v = rand(B, Sk, Hk, D).to(dtype), rand(B, Sk, Hk, D).to(dtype)
        timed = path or timed
        # The library's causal mask is top-left aligned: it computes this
        # function at Sq = Sk, or with no mask where every key is visible.
        assert not timed or not causal or Sq in (1, Sk), name
        pairs = B * Hq * visible_pairs(Sq, Sk, causal)
        form = attn_plan(dtype, B, Sq, Sk, Hq, Hk, D)
        return dict(kernel="flash_attention", case=name, path=path,
                    form=form.form if form.splits == 1
                    else f"{form.form} x{form.splits}",
                    rerun=True, timed=timed, tol=ATTN_TOL[dtype],
                    lib_tol=ATTN_LIB_TOL[dtype],
                    flops_per_s=BF16_FLOPS_PER_S if dtype == torch.bfloat16
                    else FP32_FLOPS_PER_S,
                    run=lambda: ops.flash_attention(q, k, v, causal=causal),
                    plain=lambda: flash_attention_plain(q, k, v,
                                                        causal=causal),
                    lib=lambda: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=causal and Sq == Sk,
                        enable_gqa=True).transpose(1, 2),
                    macs=2 * D * pairs,       # 4 D operations per pair
                    nbytes=q.element_size() * (2 * q.numel()
                                               + 2 * B * Sk * Hk * D))

    def attention_bwd_case(name, B, Sq, Sk, Hq, Hk, D, dtype, path,
                           timed=False, q_offset=None, form=None):
        """flash_attention_backward (causal) from the kernel's own forward
        output and lse, at a cotangent of unit scale, in `form` (None:
        `backward_plan`'s).  Its check holds the kernel's lse against the
        plain forward's first.  The library is SDPA's backward: its
        forward + backward (autograd) less its forward, both timed
        here."""
        q = rand(B, Sq, Hq, D).to(dtype)
        k, v = rand(B, Sk, Hk, D).to(dtype), rand(B, Sk, Hk, D).to(dtype)
        do = rand(B, Sq, Hq, D).to(dtype)
        off = Sk - Sq if q_offset is None else q_offset
        out, lse = flash_attention_cuda(
            q, k, v, causal=True, q_offset=off,
            form=attn_plan(dtype, B, Sq, Sk, Hq, Hk, D), return_lse=True)
        timed = path or timed
        assert not timed or Sq == Sk, name

        def check():
            want = flash_attention_plain(q, k, v, q_offset=off,
                                         return_lse=True)[1]
            max_err(lse, want, f"flash_attention lse {name}")

        def sdpa(backward):
            qq, kk, vv = (t.detach().transpose(1, 2).requires_grad_(backward)
                          for t in (q, k, v))
            o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                               enable_gqa=True)
            if not backward:
                return o
            return tuple(g.transpose(1, 2) for g in torch.autograd.grad(
                o, (qq, kk, vv), do.transpose(1, 2)))

        pairs = B * Hq * visible_pairs(Sq, Sk, True)
        form = form or attn_bwd_plan(dtype, B, Sq, Sk, Hq, Hk, D)
        return dict(kernel="flash_attention_backward", case=name, path=path,
                    form=form, rerun=True, timed=timed, tol=ATTN_TOL[dtype],
                    lib_tol=ATTN_LIB_TOL[dtype], check=check,
                    iters=5 if Sq >= 4096 else 20,
                    flops_per_s=BF16_FLOPS_PER_S if dtype == torch.bfloat16
                    else FP32_FLOPS_PER_S,
                    run=lambda: flash_attention_backward_cuda(
                        q, k, v, out, do, lse, causal=True, q_offset=off,
                        form=form),
                    plain=lambda: flash_attention_backward_plain(
                        q, k, v, out, do, lse, causal=True, q_offset=off),
                    lib=lambda: sdpa(True), lib_forward=lambda: sdpa(False),
                    macs=5 * D * pairs,       # 10 D operations per pair
                    nbytes=q.element_size() * (4 * q.numel() + 4 * k.numel())
                    + lse.element_size() * lse.numel())

    # The training path's attentions (qwen3-0.6b at train_4k's length,
    # one microbatch of 2): the forward and its backward -- the path's
    # form (wgmma), then the simt form on the same shape, timed beside it.
    cases.append(attention_case("train_S4096_bf16", 2, LM_TRAIN_SEQ,
                                LM_TRAIN_SEQ, 16, 8, 128, True,
                                torch.bfloat16, True))
    cases.append(attention_bwd_case("train_S4096_bf16", 2, LM_TRAIN_SEQ,
                                    LM_TRAIN_SEQ, 16, 8, 128, torch.bfloat16,
                                    True))
    cases.append(attention_bwd_case("train_S4096_bf16_simt", 2, LM_TRAIN_SEQ,
                                    LM_TRAIN_SEQ, 16, 8, 128, torch.bfloat16,
                                    False, timed=True, form="simt"))
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        forms = (None, "simt") if dtype == torch.bfloat16 else (None,)
        for S in (1024, 1000):
            for form in forms:
                cases.append(attention_bwd_case(
                    f"S{S}_{tag}" + ("_simt" if form else ""), 2, S, S, 16,
                    8, 128, dtype, False, timed=True, form=form))
        cases.append(attention_bwd_case(f"Sq300_Sk1000_qoff500_{tag}", 2,
                                        300, 1000, 16, 8, 128, dtype, False,
                                        q_offset=500))

    # zamba2-2.7b's shared attention block (MHA 32 heads, head_dim 80) at
    # the engine's batch 4: prefill at S 1024 and 1000 on the tile form, a
    # split decode over a max_len 2048 cache, the backward at S 1024 on
    # simt, in bf16 and fp32.
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for S in (1024, 1000):
            cases.append(attention_case(f"d80_prefill_S{S}_{tag}", LM_BATCH,
                                        S, S, 32, 32, 80, True, dtype, False,
                                        timed=True))
        cases.append(attention_case(f"d80_decode_len1024_{tag}", LM_BATCH, 1,
                                    1025, 32, 32, 80, True, dtype, False,
                                    timed=True, cache_len=LM_MAX_LEN))
        cases.append(attention_bwd_case(f"d80_S1024_{tag}", LM_BATCH, 1024,
                                        1024, 32, 32, 80, dtype, False,
                                        timed=True))

    # Phase 11's own shapes in bf16: its training microbatch of 2 at seq
    # 4096 (zamba2's shared block on tile / simt, moonshot's MHA 16 heads
    # at head_dim 128 on wgmma), forward and backward; its served prefills
    # at the engine's batch 4 and decodes over a max_len 2048 cache
    # (moonshot on wgmma / split, zamba2 on tile / split).
    for tag, Hq, D in (("zamba2", 32, 80), ("moonshot", 16, 128)):
        cases.append(attention_case(f"{tag}_train_S4096_bf16", 2,
                                    LM_TRAIN_SEQ, LM_TRAIN_SEQ, Hq, Hq, D,
                                    True, torch.bfloat16, False, timed=True))
        cases.append(attention_bwd_case(f"{tag}_train_S4096_bf16", 2,
                                        LM_TRAIN_SEQ, LM_TRAIN_SEQ, Hq, Hq,
                                        D, torch.bfloat16, False,
                                        timed=True))
        # (zamba2's S 1024 prefill and decode are the d80 cases above.)
        for S in (128, 256, 512) + ((1024,) if D == 128 else ()):
            cases.append(attention_case(f"{tag}_prefill_S{S}_bf16", LM_BATCH,
                                        S, S, Hq, Hq, D, True,
                                        torch.bfloat16, False, timed=True))
            cases.append(attention_case(f"{tag}_decode_len{S}_bf16",
                                        LM_BATCH, 1, S + 1, Hq, Hq, D, True,
                                        torch.bfloat16, False, timed=True,
                                        cache_len=LM_MAX_LEN))

    # Phase 12's own shapes in bf16: musicgen-medium's (MHA 24 heads,
    # head_dim 64) training microbatch of 2 at seq 4096, forward and
    # backward (wgmma), its served prefills at batch 4 (wgmma) and decodes
    # over a max_len 2048 cache (split); internvl2-76b's (GQA 64 / 8,
    # head_dim 128: a decode row block of 8, the split form's most) served
    # prefills and decodes.
    cases.append(attention_case("musicgen_train_S4096_bf16", 2, LM_TRAIN_SEQ,
                                LM_TRAIN_SEQ, 24, 24, 64, True,
                                torch.bfloat16, False, timed=True))
    cases.append(attention_bwd_case("musicgen_train_S4096_bf16", 2,
                                    LM_TRAIN_SEQ, LM_TRAIN_SEQ, 24, 24, 64,
                                    torch.bfloat16, False, timed=True))
    for tag, Hq, Hk, D in (("musicgen", 24, 24, 64),
                           ("internvl2", 64, 8, 128)):
        for S in (128, 256, 512, 1024):
            cases.append(attention_case(f"{tag}_prefill_S{S}_bf16", LM_BATCH,
                                        S, S, Hq, Hk, D, True,
                                        torch.bfloat16, False, timed=True))
            cases.append(attention_case(f"{tag}_decode_len{S}_bf16",
                                        LM_BATCH, 1, S + 1, Hq, Hk, D, True,
                                        torch.bfloat16, False, timed=True,
                                        cache_len=LM_MAX_LEN))

    # The serving path's attentions (qwen3-0.6b: Hq 16, Hk 8, head_dim
    # 128, bf16, slot batch 4): prefill at the served lengths, and decode
    # over the live prefix of a max_len 2048 cache.
    for S in (128, 256, 512, 1024):
        cases.append(attention_case(f"prefill_S{S}_bf16", LM_BATCH, S, S, 16,
                                    8, 128, True, torch.bfloat16, True))
        cases.append(attention_case(f"decode_len{S}_bf16", LM_BATCH, 1, S + 1,
                                    16, 8, 128, True, torch.bfloat16, True,
                                    cache_len=LM_MAX_LEN))
    # The parity run's dtype, and MQA at head_dim 256.
    cases.append(attention_case("prefill_S1024_fp32", LM_BATCH, 1024, 1024,
                                16, 8, 128, True, torch.float32, False,
                                timed=True))
    cases.append(attention_case("decode_len1024_fp32", LM_BATCH, 1, 1025, 16,
                                8, 128, True, torch.float32, False,
                                timed=True, cache_len=LM_MAX_LEN))
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        cases.append(attention_case(f"mqa_d256_{tag}", 2, 300, 300, 8, 1, 256,
                                    True, dtype, False, timed=True))
        # tests/test_kernels.py::ATTN_SWEEP (the Pallas block sizes bq, bk
        # do not apply): ragged, non-causal, MQA, Sq < Sk, Sq = 1.
        for geom in ((2, 64, 64, 4, 2, 32, True),
                     (1, 128, 128, 8, 8, 64, True),
                     (2, 48, 96, 4, 1, 32, True),
                     (1, 33, 70, 8, 2, 16, False),
                     (1, 1, 40, 4, 4, 32, True),
                     (2, 70, 70, 2, 2, 128, True)):
            name = "sweep_B{}_Sq{}_Sk{}_H{}x{}_D{}_{}".format(
                *geom[:6], "causal" if geom[6] else "full")
            cases.append(attention_case(f"{name}_{tag}", *geom, dtype,
                                        False))
        # The forms' edges: Sq and Sk at the 64-row / 64-key tiles, every
        # head_dim, causal with q_offset > 0 and full; decode lengths about
        # the split form's tiles over a strided cache view.
        for D in (16, 32, 64, 80, 128, 256):
            for Sq, Sk, causal in ((63, 63, True), (64, 64, True),
                                   (65, 130, True), (65, 65, False)):
                cases.append(attention_case(
                    f"edge_Sq{Sq}_Sk{Sk}_D{D}_"
                    f"{'causal' if causal else 'full'}_{tag}", 1, Sq, Sk, 4,
                    2, D, causal, dtype, False))
        for length in (1, 31, 32, 33, 64, 65, 1025):
            cases.append(attention_case(f"decode_len{length}_cache_{tag}", 2,
                                        1, length, 16, 8, 128, True, dtype,
                                        False, cache_len=LM_MAX_LEN))

    def as_tuple(out):
        """The outputs a call gave (a backward's db is None without a
        bias)."""
        return tuple(t for t in out if t is not None) \
            if isinstance(out, tuple) else (out,)

    def max_err(got, want, what, tol=TOL):
        """Largest |got - want|; raises unless every pair is allclose at
        `tol` (one number for atol and rtol, a pair (atol, rtol), or
        (atol, rtol, "of max"): atol times want's largest magnitude) and
        of one dtype."""
        atol, rtol, *rel = tol if isinstance(tol, tuple) else (tol, tol)
        got, want = as_tuple(got), as_tuple(want)
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} outputs, expected "
                                 f"{len(want)}")
        err = 0.0
        for a, b in zip(got, want):
            if rel and a.dtype != b.dtype:
                raise AssertionError(f"{what}: dtype {a.dtype} vs {b.dtype}")
            a, b = a.float(), b.float()
            scale = b.abs().max().item() if rel and b.numel() else 1.0
            if a.shape != b.shape or not torch.allclose(
                    a, b, atol=atol * scale, rtol=rtol):
                raise AssertionError(
                    f"{what}: shape {tuple(a.shape)} vs {tuple(b.shape)}, "
                    f"max |err| {(a - b).abs().max().item():.3e}")
            err = max(err, (a - b).abs().max().item())
        return err

    timer = DeviceTimer()
    # The floor under every launch: a kernel that does nothing, launched
    # through ctypes as the kernels are, on the same timer.
    empty = build.kernel_function("implicit_gemm", "empty_launch",
                                  [ctypes.c_void_p])
    floor_ms = timer(lambda: build.check_launch("implicit_gemm", empty(
        torch.cuda.current_stream().cuda_stream)))
    print("launch floor " + json.dumps({"empty_kernel_ms": floor_ms,
                                        "card": card}))
    kernels, race, bf16_launches = {}, {}, {}
    for c in cases:
        before = dict(ops.LAUNCHES)
        if "check" in c:
            c["check"]()
        got = c["run"]()
        torch.cuda.synchronize()
        what = f"{c['kernel']} {c['case']}"
        tol = c.get("tol", TOL)
        err = max_err(got, c["plain"](), what + " against the plain version",
                      tol)
        row = dict(kernel=c["kernel"], case=c["case"], max_abs_err=err)
        if "form" in c:
            row["form"] = c["form"]
        if c.get("rerun") and not all(
                torch.equal(a, b)
                for a, b in zip(as_tuple(got), as_tuple(c["run"]()))):
            raise AssertionError(f"{what}: a rerun is not bit-identical")
        if c["timed"]:
            lib = c["lib"]
            lib_err = max_err(got, lib(), what + " against the library",
                              c.get("lib_tol", tol))
            b_ms, b_by = bound_ms(c["nbytes"], c["macs"],
                                  c.get("flops_per_s", FP32_FLOPS_PER_S))
            iters = c.get("iters", PHASE3_ITERS)
            lib_ms = timer(lib, iters)
            if "lib_forward" in c:   # a backward: less the library's forward
                lib_ms -= timer(c["lib_forward"], iters)
            row.update(lib_err=lib_err, ms=timer(c["run"], iters),
                       plain_ms=timer(c["plain"], iters), library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by, macs=c["macs"],
                       nbytes=c["nbytes"])
        print("case " + json.dumps(row))
        if c.get("dtype") == "bf16":   # every launch the case made
            for name, n in ops.LAUNCHES.items():
                bf16_launches[name] = bf16_launches.get(name, 0) + n \
                    - before[name]
        if "race" in c:
            point = race.setdefault(c["race"], {"pick": picks[c["race"]]})
            point[c["kernel"]] = row["ms"]
            point["library"], point["bound"] = row["library_ms"], \
                row["bound_ms"]
        # A conv kernel's bf16 cases sum into a row of their own.
        row_name = c["kernel"] + ("_bf16" if c.get("dtype") == "bf16" else "")
        k = kernels.setdefault(row_name, dict(
            name=c["kernel"], max_abs_err=0.0, ms=0.0, plain_ms=0.0,
            library_ms=0.0, bound_ms=0.0, by={"bytes": 0.0,
                                               "operations": 0.0}))
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if c["path"]:   # one launch at each of its path shapes, summed
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                k[key] += row[key]
            k["by"][row["bound_by"]] += row["bound_ms"]
    for point in race.values():   # a miss: the pick's arm 10 % slower
        ms = {arm: point[kernel] for arm, kernel in TCONV_KERNELS.items()}
        point["miss"] = ms[point["pick"]] > MISS_RATIO * min(ms.values())
    print("race " + json.dumps(race | {"card": card}))
    print(f"kernels: all {len(kernels)} (the six conv kernels' bf16 entries "
          f"counted apart) agree with their plain versions and the library "
          f"within {TOL:g} at every case (flash attention in bf16, (atol, "
          f"rtol): {ATTN_TOL[torch.bfloat16]} against the plain version, "
          f"{ATTN_LIB_TOL[torch.bfloat16]} against the library; the conv "
          f"kernels in bf16 {BF16_TOL} and {BF16_LIB_TOL})")
    print("phase 3 bf16 launches " + json.dumps(bf16_launches))
    del cases        # their closures hold every case's tensors on the card
    gc.collect()
    torch.cuda.empty_cache()
    mark("3")

    # -- phase 4: serve at the published widths --------------------------------
    gen = torch.Generator().manual_seed(1234)
    gp = gan.generator_init(gen, device=dev)          # z 64, base 64, RGB
    ap = vision.atrous_head_init(gen, device=dev)     # 3 -> 16, 4 classes
    eng = ConvServeEngine(gan_params=gp, aspp_params=ap,
                          slot_batch=SLOT_BATCH, queue_limit=2 * N_REQUESTS,
                          ladder=("cuda",), device=dev)
    img = (128, 128, 3)
    eng.warmup([("gan_gen", (64,)), ("aspp", img)], compile=True)
    rng = np.random.default_rng(7)
    reqs = []
    for _ in range(N_REQUESTS):
        reqs.append(ConvRequest(None, "gan_gen",
                                rng.standard_normal(64).astype(np.float32)))
        reqs.append(ConvRequest(None, "aspp",
                                rng.standard_normal(img).astype(np.float32)))
    ops.reset_launches()
    t0 = time.perf_counter()
    res = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    batches = -(-N_REQUESTS // SLOT_BATCH)
    expect = {"dconv_forward": 3 * batches}
    for layer, *_ in GEN_TCONVS:      # each layer on the arm the race picks
        kernel = TCONV_KERNELS[picks[f"{layer}_B{SLOT_BATCH}"]]
        expect[kernel] = expect.get(kernel, 0) + batches
    if serve_launches != expect:
        raise AssertionError(f"serve launches {serve_launches}, expected "
                             f"{expect}")
    h = eng.health()
    bad = {k: h[k] for k in ("kernel_faults", "fallbacks", "failures",
                             "nan_events", "sheds", "deadline_misses")
           if h[k]}
    if bad or h["completed"] != h["submitted"] or len(res) != len(reqs):
        raise AssertionError(f"serving was not clean: {bad}, completed "
                             f"{h['completed']} of {h['submitted']}")
    cpu = torch.device("cpu")
    with torch.no_grad():
        for kind, fn, params in (
                ("gan_gen", gan.generator_apply, gp),
                ("aspp", vision.atrous_head_apply, ap)):
            sel = [r for r in reqs if r.kind == kind]
            batch = torch.from_numpy(np.stack([r.payload for r in sel]))
            plain = fn({k: v.to(cpu) for k, v in params.items()}, batch,
                       backend="cuda").numpy()
            for r, want in zip(sel, plain):
                got = res[r.uid]
                if not (got.shape == want.shape and np.all(np.isfinite(got))
                        and np.allclose(got, want, atol=TOL, rtol=TOL)):
                    raise AssertionError(
                        f"{kind} request {r.uid}: max |err| "
                        f"{np.abs(got - want).max():.3e} against the plain "
                        f"versions")
    print(f"serve: {len(res)} requests ({N_REQUESTS} gan_gen 32x32x3, "
          f"{N_REQUESTS} aspp 128x128x3 -> 4 classes), slot batch "
          f"{SLOT_BATCH}, ladder ('cuda',): all equal the plain versions "
          f"within {TOL:g}")
    print("serve launches " + json.dumps(serve_launches))
    print("health " + json.dumps({
        k: h[k] for k in ("submitted", "completed", "launches", "p50_us",
                          "p99_us", "kernel_faults", "fallbacks",
                          "failures", "nan_events")}
        | {"requests_per_s": len(res) / wall, "card": card}))
    mark("4")

    # -- phase 5: train at the published widths --------------------------------
    def gan_step(state, b):
        new, g_loss, d_loss = gan.gan_sgd_step(state, b["z"], b["real"],
                                               lr=LR, backend="cuda")
        return new, (g_loss, d_loss)

    def cnn_step(params, b):
        new, loss = cnn.sgd_step(params, b["x"], b["labels"], lr=LR,
                                 backend="cuda")
        return new, (loss,)

    gen = torch.Generator().manual_seed(2024)
    models = [
        ("gan_sgd_step", gan_step,
         gan.gan_init(gen, z_dim=64, base=64, ch=3, device=dev),
         ConvDataset(kind="gan", batch=B, image=32, z_dim=64, seed=0)),
        ("sgd_step", cnn_step, cnn.simple_cnn_init(gen, device=dev),
         ConvDataset(kind="cnn", batch=B, image=32, seed=0)),
    ]
    train_launches, trained, fp32_ms = {}, [], {}
    for step_name, step, state, ds in models:
        cpu_state = tree_map(lambda t: t.to(cpu), state)
        step_ms, worst = [], 0.0
        for i in range(TRAIN_STEPS):
            batch = ds.batch_at(i)
            on_cpu = {k: torch.from_numpy(v) for k, v in batch.items()}
            on_dev = {k: v.to(dev) for k, v in on_cpu.items()}
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            ops.reset_launches()
            start.record()
            new, losses = step(state, on_dev)
            end.record()
            end.synchronize()
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            if launches != STEP_LAUNCHES[step_name]:
                raise AssertionError(f"{step_name} step {i + 1}: launches "
                                     f"{launches}, expected "
                                     f"{STEP_LAUNCHES[step_name]}")
            for name, n in launches.items():
                train_launches[name] = train_launches.get(name, 0) + n
            step_ms.append(start.elapsed_time(end))
            if i == 0:   # the same step from the same state, bit for bit
                again, again_losses = step(state, on_dev)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(
                        tree_leaves((new, losses)),
                        tree_leaves((again, again_losses)))):
                    raise AssertionError(f"{step_name}: step 1 repeated on "
                                         f"the card is not bit-identical")
            cpu_new, cpu_losses = step(cpu_state, on_cpu)
            got = [t.to(cpu) for t in tree_leaves((new, losses))]
            want = tree_leaves((cpu_new, cpu_losses))
            for a, b in zip(got, want):
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{step_name} step {i + 1}: a "
                                         f"non-finite value on the card")
                if a.shape != b.shape or not torch.allclose(
                        a, b, atol=TRAIN_TOL, rtol=TRAIN_TOL):
                    raise AssertionError(
                        f"{step_name} step {i + 1}: max |err| "
                        f"{(a - b).abs().max().item():.3e} against the plain "
                        f"versions on the CPU")
                worst = max(worst, (a - b).abs().max().item())
            state, cpu_state = new, cpu_new
            print(f"train {step_name} step {i + 1}: losses "
                  f"{[round(float(v), 6) for v in losses]}, "
                  f"{step_ms[-1]:.3f} ms")
        steady = sum(step_ms[1:]) / (len(step_ms) - 1)
        fp32_ms[step_name] = steady
        print("train " + json.dumps({
            "step": step_name, "batch": B, "steps": TRAIN_STEPS,
            "ms_per_step": steady, "images_per_s": B / steady * 1e3,
            "first_step_ms": step_ms[0], "max_abs_err_vs_cpu": worst,
            "launches_per_step": STEP_LAUNCHES[step_name], "card": card}))
        trained.append((step_name, step, state, ds))
    print(f"train: {TRAIN_STEPS} gan_sgd_step + {TRAIN_STEPS} sgd_step at "
          f"batch {B} equal the plain versions on the CPU within "
          f"{TRAIN_TOL:g} after every step; step 1 repeats bit for bit")
    print("train launches " + json.dumps(train_launches))
    for step_name, step, state, ds in trained:
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in ds.batch_at(TRAIN_STEPS + i).items()}
                   for i in range(PROFILE_TRAIN_STEPS)]
        print("train profile " + json.dumps(
            {"step": step_name, "batch": B}
            | train_profile(step, state, batches) | {"card": card}))

    # (b) the same steps in bf16: every param and the batch cast to bf16
    # (the same draws as (a)'s), held against the same bf16 steps through
    # the plain versions on the CPU.
    def bf16(tree):
        return tree_map(lambda t: t.to(torch.bfloat16)
                        if t.is_floating_point() else t, tree)

    gen = torch.Generator().manual_seed(2024)
    models = [
        ("gan_sgd_step", gan_step,
         bf16(gan.gan_init(gen, z_dim=64, base=64, ch=3, device=dev)),
         ConvDataset(kind="gan", batch=B, image=32, z_dim=64, seed=0)),
        ("sgd_step", cnn_step, bf16(cnn.simple_cnn_init(gen, device=dev)),
         ConvDataset(kind="cnn", batch=B, image=32, seed=0)),
    ]
    train_launches_bf16 = {}
    for step_name, step, state, ds in models:
        cpu_state = tree_map(lambda t: t.to(cpu), state)
        step_ms, worst = [], 0.0
        for i in range(TRAIN_STEPS_BF16):
            on_cpu = bf16({k: torch.from_numpy(v)
                           for k, v in ds.batch_at(i).items()})
            on_dev = {k: v.to(dev) for k, v in on_cpu.items()}
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            ops.reset_launches()
            start.record()
            new, losses = step(state, on_dev)
            end.record()
            end.synchronize()
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            if launches != STEP_LAUNCHES[step_name]:
                raise AssertionError(f"{step_name} bf16 step {i + 1}: "
                                     f"launches {launches}, expected "
                                     f"{STEP_LAUNCHES[step_name]}")
            for name, n in launches.items():
                train_launches_bf16[name] = \
                    train_launches_bf16.get(name, 0) + n
            step_ms.append(start.elapsed_time(end))
            if i == 0:   # the same step from the same state, bit for bit
                again, again_losses = step(state, on_dev)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(
                        tree_leaves((new, losses)),
                        tree_leaves((again, again_losses)))):
                    raise AssertionError(f"{step_name}: bf16 step 1 repeated "
                                         f"on the card is not bit-identical")
            cpu_new, cpu_losses = step(cpu_state, on_cpu)
            got = [t.to(cpu) for t in tree_leaves((new, losses))]
            want = tree_leaves((cpu_new, cpu_losses))
            for a, b in zip(got, want):
                a, b = a.float(), b.float()
                big = b.abs().max().item()
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{step_name} bf16 step {i + 1}: a "
                                         f"non-finite value on the card")
                if a.shape != b.shape or not torch.allclose(
                        a, b, atol=TRAIN_TOL_BF16 * big,
                        rtol=TRAIN_TOL_BF16):
                    raise AssertionError(
                        f"{step_name} bf16 step {i + 1}: max |err| "
                        f"{(a - b).abs().max().item():.3e} against the plain "
                        f"versions on the CPU, largest |value| {big:.3e}")
                worst = max(worst, (a - b).abs().max().item() / max(big,
                                                                    1e-30))
            if not all(t.dtype == torch.bfloat16 for t in got):
                raise AssertionError(f"{step_name} bf16 step {i + 1}: an "
                                     f"output not in bf16")
            state, cpu_state = new, cpu_new
            print(f"train bf16 {step_name} step {i + 1}: losses "
                  f"{[float(v) for v in losses]}, {step_ms[-1]:.3f} ms")
        steady = sum(step_ms[1:]) / (len(step_ms) - 1)
        print("train bf16 " + json.dumps({
            "step": step_name, "batch": B, "steps": TRAIN_STEPS_BF16,
            "ms_per_step": steady, "fp32_ms_per_step": fp32_ms[step_name],
            "first_step_ms": step_ms[0],
            "max_err_of_leaf_max_vs_cpu": worst,
            "launches_per_step": STEP_LAUNCHES[step_name], "card": card}))
    print(f"train bf16: {TRAIN_STEPS_BF16} gan_sgd_step + "
          f"{TRAIN_STEPS_BF16} sgd_step at batch {B} in bf16 equal the "
          f"plain versions on the CPU within {TRAIN_TOL_BF16:g} of each "
          f"leaf's largest magnitude after every step; step 1 repeats bit "
          f"for bit")
    print("train bf16 launches " + json.dumps(train_launches_bf16))
    mark("5")

    # -- phase 6: LM serving ---------------------------------------------------
    full = get_config(LM_ARCH)

    # (a) 2 layers at full width in fp32: the card against the CPU.
    plm = LM(full.scaled(n_layers=PARITY_LAYERS, dtype="float32"))
    cpu_params, lens, toks, forced, max_len = lm_parity_inputs(plm)
    dev_params = tree_map(lambda t: t.to(dev), cpu_params)

    def hold(got, want, what):
        got = got.to(cpu)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"lm parity {what}: a non-finite value")
        if got.shape != want.shape or not torch.allclose(
                got, want, atol=PARITY_TOL, rtol=PARITY_TOL):
            raise AssertionError(f"lm parity {what}: max |err| "
                                 f"{(got - want).abs().max().item():.3e} "
                                 f"against the plain versions on the CPU")
        return (got - want).abs().max().item()

    worst = 0.0
    ops.reset_launches()
    with torch.no_grad():
        out = plm.prefill(dev_params, torch.from_numpy(toks).to(dev), max_len)
        want = plm.prefill(cpu_params, torch.from_numpy(toks), max_len)
        for step in range(PARITY_DECODES + 1):
            what = "prefill" if step == 0 else f"decode {step}"
            worst = max(worst, hold(out[0], want[0], what + " logits"),
                        hold(out[1]["k"], want[1]["k"], what + " cache k"),
                        hold(out[1]["v"], want[1]["v"], what + " cache v"))
            if out[1]["len"] != want[1]["len"]:
                raise AssertionError(f"lm parity {what}: cache len")
            if step < PARITY_DECODES:
                tok = torch.from_numpy(forced[step].astype(np.int32))
                out = plm.decode_step(dev_params, out[1], tok.to(dev))
                want = plm.decode_step(cpu_params, want[1], tok)
    parity_launches = ops.LAUNCHES["flash_attention"]
    if parity_launches != PARITY_LAYERS * (1 + PARITY_DECODES):
        raise AssertionError(f"lm parity: {parity_launches} flash_attention "
                             f"launches, expected one per layer per call")
    # fp32: the prefill on the tile form, every decode on the split form.
    parity_forms = {"tile": PARITY_LAYERS, "wgmma": 0,
                    "split": PARITY_LAYERS * PARITY_DECODES}
    if ops.FLASH_FORMS != parity_forms:
        raise AssertionError(f"lm parity: flash_attention forms "
                             f"{ops.FLASH_FORMS}, expected {parity_forms}")
    print("lm parity " + json.dumps({
        "arch": LM_ARCH, "n_layers": PARITY_LAYERS, "dtype": "float32",
        "prompt_lens": lens.tolist(), "decode_steps": PARITY_DECODES,
        "max_abs_err_vs_cpu": worst, "tol": PARITY_TOL}))
    del cpu_params, dev_params, out, want

    # (b) the whole model in bf16 through the serving engine.
    lm = LM(full)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator().manual_seed(1), device=dev)
    init_s = time.perf_counter() - t0

    warm = instrumented_engine(full, params)   # one-time costs
    warm.generate([Request(uid=0, prompt=np.arange(1, 200, dtype=np.int32),
                           max_new_tokens=3)])
    runs = []
    for run in range(2):
        eng, reqs = instrumented_engine(full, params), lm_requests(full.vocab)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        calls = eng.stats["prefills"] + eng.stats["decode_steps"]
        if launches != {"flash_attention": full.n_layers * calls}:
            raise AssertionError(f"lm serve run {run + 1}: launches "
                                 f"{launches}, expected "
                                 f"{full.n_layers} x {calls} flash_attention")
        # Every prefill on the tensor-core form, every decode step on the
        # split-kv form.
        forms = {"tile": 0,
                 "wgmma": full.n_layers * eng.stats["prefills"],
                 "split": full.n_layers * eng.stats["decode_steps"]}
        if ops.FLASH_FORMS != forms:
            raise AssertionError(f"lm serve run {run + 1}: flash_attention "
                                 f"forms {ops.FLASH_FORMS}, expected {forms}")
        forms_run = dict(ops.FLASH_FORMS)
        if not all(bool(ok) for *_, ok in eng.calls):
            raise AssertionError(f"lm serve run {run + 1}: NaN or inf in the "
                                 f"logits")
        if sorted(res) != list(range(LM_REQUESTS)) or any(
                len(res[r.uid]) != r.max_new_tokens for r in reqs):
            raise AssertionError(f"lm serve run {run + 1}: not every request "
                                 f"was answered in full")
        runs.append(dict(res=res, wall=wall, launches=launches,
                         forms=forms_run,
                         stats=dict(eng.stats), calls=eng.calls, reqs=reqs,
                         peak=torch.cuda.max_memory_allocated()))
    if runs[1]["res"] != runs[0]["res"] or runs[1]["stats"] != \
            runs[0]["stats"]:
        raise AssertionError("lm serve: a second run gave other tokens")
    first = runs[0]
    lm_launches = first["launches"]
    ms = {kind: [s.elapsed_time(e) for k, s, e, _ in first["calls"]
                 if k == kind] for kind in ("prefill", "decode")}
    generated = sum(len(v) for v in first["res"].values())
    decode_ms = sorted(ms["decode"])
    print("lm serve " + json.dumps({
        "arch": LM_ARCH, "n_layers": full.n_layers, "dtype": full.dtype,
        "batch": LM_BATCH, "max_len": LM_MAX_LEN, "requests": LM_REQUESTS,
        "prompt_tokens": int(sum(len(r.prompt) for r in first["reqs"])),
        "generated_tokens": generated, "stats": first["stats"],
        "launches": lm_launches, "flash_attention_forms": first["forms"],
        "wall_s": [r["wall"] for r in runs],
        "requests_per_s": LM_REQUESTS / first["wall"],
        "generated_tokens_per_s": generated / first["wall"],
        "ms_per_prefill": sum(ms["prefill"]) / len(ms["prefill"]),
        "ms_per_decode_step": sum(ms["decode"]) / len(ms["decode"]),
        "prefill_ms": ms["prefill"],
        "decode_ms_min_median_max": [decode_ms[0],
                                     decode_ms[len(decode_ms) // 2],
                                     decode_ms[-1]],
        "peak_memory_gb": first["peak"] / 1e9, "init_s": init_s,
        "card": card}))
    print("lm decode profile " + json.dumps(
        decode_profile(lm, params, dev) | {"card": card}))
    print(f"lm: {PARITY_LAYERS}-layer {LM_ARCH} fp32 equals the CPU within "
          f"{PARITY_TOL:g} over prefill and {PARITY_DECODES} decode steps; "
          f"{LM_REQUESTS} requests served twice with the same tokens, "
          f"{full.n_layers} flash_attention launches per prefill and per "
          f"decode step, no NaN")
    mark("6")

    # -- phase 7: the trainer, its step captured as a CUDA graph ---------------
    trainer_launches = trainer_phase(card)
    mark("7")

    # -- phase 8: atrous training, patchify and the planner --------------------
    vision_launches = vision_phase(card)
    mark("8")

    # -- phase 9: LM training -------------------------------------------------
    lm_train_launches = lm_train_phase(card)
    mark("9")

    # -- phase 10: the int8 KV cache, the examples, the quickstart ------------
    int8_launches = int8_serve_phase(card, params, first)
    example_launches = examples_phase(card)
    quickstart_launches = quickstart_phase(card)
    del params, first
    mark("10")

    # -- phase 11: the moe, ssm and hybrid families ----------------------------
    families = families_phase(card)
    mark("11")

    # -- phase 12: the audio and vlm families; the conv steps on a mesh -------
    embed_launches = embeds_phase(card)
    mark("12a")
    mesh_launches = mesh_phase(card)
    mark("12b")

    # -- phase 13: the dense LM on a mesh ----------------------------------------
    lm_mesh_launches = lm_mesh_phase(card)
    mark("13")

    # -- phase 14: the other LM families and the int8 cache on a mesh --------
    fm_launches = families_mesh_phase(card)
    mark("14")

    # -- phase 15: the dry-run ----------------------------------------------
    dryrun_launches = dryrun_phase(card)
    mark("15")
    print("phases " + json.dumps({"seconds": phase_s, "card": card}))

    sources = {"dconv_forward": ("dconv_forward.cu",
                                 "src/repro/kernels/dconv_forward.py:104"),
               "tconv_phase": ("tconv_phase.cu",
                               "src/repro/kernels/tconv_phase.py:263"),
               "tconv_implicit_gemm": (
                   "implicit_gemm.cu", "src/repro/kernels/implicit_gemm.py:147"),
               "conv_backward": ("conv_backward.cu",
                                 "src/repro/kernels/dconv_backward.py:254"),
               "tconv_backward": ("tconv_backward.cu",
                                  "src/repro/kernels/dconv_backward.py:518"),
               "dconv_filter_grad": (
                   "dconv_filtergrad.cu",
                   "src/repro/kernels/dconv_filtergrad.py:114"),
               "flash_attention": ("flash_attention.cu",
                                   "src/repro/kernels/attention.py:83"),
               "flash_attention_backward": (
                   "flash_attention_bwd.cu",
                   "jax.grad of src/repro/models/layers.py:108")}
    rows = []
    for name, (source, replaces) in sources.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{source}",
                     "replaces": replaces,
                     "launches": serve_launches.get(name, 0)
                     + train_launches.get(name, 0)
                     + lm_launches.get(name, 0)
                     + trainer_launches.get(name, 0)
                     + vision_launches.get(name, 0)
                     + lm_train_launches.get(name, 0)
                     + int8_launches.get(name, 0)
                     + example_launches.get(name, 0)
                     + quickstart_launches.get(name, 0)
                     + families["launches"].get(name, 0)
                     + embed_launches.get(name, 0)
                     + mesh_launches.get(name, 0)
                     + lm_mesh_launches.get(name, 0)
                     + fm_launches.get(name, 0)
                     + dryrun_launches.get(name, 0),
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": max(k["by"], key=k["by"].get),
                     "library_ms": k["library_ms"]})
        if name.startswith("flash_attention"):   # zamba2's instantiations
            rows[-1]["launches_head_dim_80"] = families["d80"].get(name, 0)
        rows[-1]["launches_phase_12"] = embed_launches.get(name, 0) \
            + mesh_launches.get(name, 0)
        rows[-1]["launches_phase_13"] = lm_mesh_launches.get(name, 0)
        rows[-1]["launches_phase_14"] = fm_launches.get(name, 0)
        rows[-1]["launches_phase_15"] = dryrun_launches.get(name, 0)
        kb = kernels.get(name + "_bf16")
        if kb is not None:   # the conv kernels' bf16 entries
            rows[-1].update(
                launches_bf16=train_launches_bf16.get(name, 0)
                + bf16_launches.get(name, 0),
                launches_bf16_path=train_launches_bf16.get(name, 0),
                launches_bf16_phase_3=bf16_launches.get(name, 0),
                max_abs_err_bf16=kb["max_abs_err"], ms_bf16=kb["ms"],
                plain_ms_bf16=kb["plain_ms"], bound_ms_bf16=kb["bound_ms"],
                bound_by_bf16=max(kb["by"], key=kb["by"].get),
                library_ms_bf16=kb["library_ms"])
    print(json.dumps({"kernels": rows}))
    print(card)        # exactly as nvidia-smi gives name and power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
