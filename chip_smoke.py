#!/usr/bin/env python3
"""Smoke run of fedvit_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --trace    # and where the time of a serving batch
                                     # and of a training step goes

Phases, one line of output each (or a few):

1. the card (``nvidia-smi`` name and power limit, ``torch.cuda``), then the
   build of every hand-written kernel from ``fedvit_torch/csrc`` with ``nvcc``
   (one compiler per source, all at once);
2. each kernel against its plain PyTorch version on the card, at the shape
   the serving path gives it (and a small fp32 case, and ViT-H's head width
   d = 80 at a small batch), with its time, the plain version's, one PyTorch
   library call's for the same function, and the least time the card could
   take (the bound);
3. serving: a ViT-B/16@224 ``ISICClassifier`` (4 channels, metadata, bf16,
   seeded random weights) takes seeded 272² uint8 canvases through the eval
   augment and forward (``eval/serve.py::_evaluate``) at batch 256, with a
   ragged last batch; the kernel's launch count must be 12 per forward and
   the logits must match the same model run with the plain attention;
4. the same for 8-view TTA (``evaluate_with_tta``) at batch 32;
5. with ``--trace`` only: a serving batch broken into stages (each ended by
   a synchronise, host clock) and a ``torch.profiler`` trace of
   ``_evaluate`` (device time by kernel, the device's busy share);
6. training (``fedvit_torch/train/step.py::make_train_step``):
   a. K2, K3 and K4 against their plain versions at the shapes a ViT-B
      micro-batch of 64 gives them (and small fp32 cases, and K2 and K3 at
      d = 80), with their times,
      the plain versions', a PyTorch library call's and the bound;
   b. the step: ViT-B/16@224 (4 channels, metadata, bf16, drop-path 0.1 and
      the default dropouts, seeded perturbed weights), asymmetric loss,
      MixUp/CutMix, AdamW with LLRD, clip, EMA, macro batch 128 as 2
      micro-batches of 64 made by the eval augment from seeded 272² uint8
      canvases; 1 warm-up step then 5 timed ones, img/s and peak memory, the
      launch counts (2 × (12 K2, 12 K3, 25 K4) a step, no K1), the parameters
      and the EMA shadow must move as the update says;
   c. the gradients of one macro batch through the kernels against the same
      step through the plain attention and LayerNorm backward, leaf by leaf,
      and a control with K3's bias gradient zeroed that must fail the check;
   with ``--trace``, a ``torch.profiler`` trace of one training step;
7. SwinV2-L@384 serving (``swinv2_large_window12to24_192to384``):
   a. K5 (the windowed attention with a relative-position bias and a shift
      mask) against its plain version: small fp32 cases with a ragged N,
      several windows and several rows a window, then bf16 at the four stage
      shapes a batch of 32 gives it, with the real shift mask where the stage
      has one; its time, the plain version's, SDPA's with the summed bias and
      mask as ``attn_mask``, and the bound; the log-sum-exp variant's output
      bit-equal to K5's and its LSE against ``torch.logsumexp``;
   b. serving: the ``ISICClassifier`` on SwinV2-L (4 channels, metadata, bf16,
      seeded perturbed weights) takes seeded 448² uint8 canvases through
      ``_evaluate`` at batch 32 with a ragged last batch; 24 K5 launches per
      forward and none of K1-K4; the logits against the same model with the
      plain attention, and a control with the relative-position bias zeroed
      that must fail the check;
   c. the same for 8-view TTA at batch 8;
   with ``--trace``, the stages and profile of a SwinV2-L serving batch;
8. SwinV2-L@384 training:
   a. K6 (the windowed attention's backward) through the autograd Function
      (K5's log-sum-exp entry forward, K6 backward) against autograd of the
      plain version: small fp32 cases (several windows and rows a window, the
      real shift mask, a ragged N), then bf16 at the four stage shapes a
      micro-batch of 8 gives it, each of dq, dk, dv and dbias; its time, the
      plain autograd backward's, SDPA's backward and the bound; K4 at
      SwinV2-L's widths (D = 192, 384, 1536 in bf16, 1536 in fp32);
   b. the step: SwinV2-L (4 channels, metadata, bf16, drop-path 0.2), the
      recipe of 6b with LLRD 0.8, macro batch 16 as 2 micro-batches of 8;
      1 warm-up step then 5 timed ones, img/s and peak memory, the launch
      counts (per micro-batch 24 of K5's log-sum-exp entry, 24 K6, one K4 per
      LayerNorm, none of K1-K3 nor of the plain K5), every parameter and the
      EMA shadow must move;
   c. between the warm-up step and the timed ones, the gradients of one
      macro batch through the kernels against the same step through the plain
      attention and LayerNorm backward, leaf by leaf and for the q, k and v
      rows of every qkv weight, each allowed the limit plus twice its own
      rounding noise (the plain path against the plain path with fp32
      attention); the kernel path twice for the same bits; and a control with
      K6's bias gradient zeroed that must fail the check on every ``cpb_mlp``
      leaf;
   with ``--trace``, a ``torch.profiler`` trace of one SwinV2-L training step;
9. the train augment and the fold trainer:
   a. K7 (row and column shifts) against its plain version, bit for bit:
      small fp32 cases (C of 1, 3, 4, a ragged W, H ≠ W, ties, shifts past
      the extent), then the rotation's and RandAugment's shapes at a ViT-B@224
      macro batch of 128 and a SwinV2-L@384 macro batch of 16, rows and
      columns, with the time, the plain version's, ``torch.gather``'s and the
      bound;
   b. K8 (equalize) the same way at (128, 224, 224, 3) and (16, 384, 384, 3),
      with a constant channel and a nearly constant one;
   c. ``make_device_augment(cfg, train=True)`` on seeded 272² and 448²
      4-channel canvases at those macro batches: ms a call, 12 K7 and 3 K8
      launches a call, the output bit-equal to the same call through the
      plain shifts and equalize from the same generator state, every
      RandAugment op chosen by some sample, mask values ±1;
   d. ``train_fold`` on ViT-B/16@224 (the recipe of 6b with the train augment,
      data made resident on the card): 2 epochs of 1,280 images (10 steps
      an epoch) with best and resume checkpoints, validation on 64, an
      8-view TTA test on 40; then a resumed run to 3 epochs that must run
      epoch 3 alone and restore every tensor bit for bit; train img/s a
      epoch and the fold rate over epochs 2 and 3 (the first warms up),
      validation img/s, checkpoint seconds and
      bytes, peak memory, launches a step (12 K7, 3 K8, 2 × (12 K2, 12 K3, 25
      K4)); then ``auto_batch_size`` at its defaults;
   with ``--trace``, the augment's and the step's share of a fold step and a
   profile of one;
10. ViT-B/16@224 with ``model.attention_impl`` ``packed`` (K10, attention on
   the qkv Dense's output with its bias) and ``mega`` (K11, the projection
   inside the kernel):
   a. each entry of K10 and K11 (forward, the forward with the log-sum-exp,
      backward) against its plain version: small fp32 cases (N of 37 and 197,
      3 batch rows, d of 64 and 80), then bf16 at the serving shape (batch
      256, forward) and the micro-batch of 64 (log-sum-exp entry, backward),
      K11's dx, dW and db each, its backward twice for the same bits; the
      time, the plain version's, the library yardstick's (SDPA on the q/k/v
      views; ``F.linear`` then SDPA for K11) and the bound; then K11's three
      products alone (``gemm_product``: x·W at the serving shape, dqkv·Wᵀ
      and xᵀ·dqkv at 64) against the fp32 product of the same bf16
      operands, twice for the same bits, with ms, TFLOP/s, the share of the
      bf16 peak and ``torch.matmul``'s bf16 time;
   b. serving and 8-view TTA as phases 3 and 4 with each value: 12 K10 (or
      K11) launches a forward and no other attention kernel, the logits
      against the same model with the plain attention, a control that must
      fail the check (``packed``: the qkv Dense without its bias; ``mega``:
      the plain K11 with its bias zeroed), img/s and peak memory beside
      ``auto``'s from phase 3; with ``--trace`` a serving profile;
   c. the training step of phase 6 with each value: a warm-up and 5 timed
      steps, 12 log-sum-exp entries, 12 backwards and 25 K4 a micro-batch
      and no other kernel, the parameters and the EMA shadow moving, then one
      macro batch's gradients leaf by leaf (and the q, k and v rows of every
      qkv weight) against the plain path as in 6c, the rows each allowed the
      limit plus twice their own rounding noise as in 8c, with a control
      that must fail (``mega``: K11 with dW zeroed, on every qkv
      weight; ``packed``: K10 with the k third of dqkv zeroed, on every qkv
      weight's k rows); with ``--trace`` a profile of a step;
11. the op-level attention (``ops/attention.py``'s entries with JAX's
   ``impl``) and its kernels, K9 (bias-free attention on flat q, k, v) and K12
   (SwinV2's scaled-cosine windowed attention on raw q and k):
   a. each entry of K9 (forward, the forward with the log-sum-exp, backward)
      against its plain version: small fp32 cases (N of 37 and 197, 3 batch
      rows, d of 64 and 80), then bf16 at ViT-B's serving shape (batch 256,
      forward) and micro-batch of 64 (log-sum-exp entry, backward), and at
      ViT-L/16@384's (16, 577, 1024, 16 heads); K9 on three (B, N, E) tensors
      against K10 on their concatenation, bit for bit; the time, the plain
      version's, SDPA's on the (B, H, N, d) views and the bound;
   b. each entry of K12 against its plain version (the output, the
      log-sum-exp, and dq, dk, dv, dscale, dbias; bf16 dscale against the
      plain version in the TPU kernel's order): small fp32 cases (several
      windows and rows a window, a ragged N, rows of q and k of norm 0 and
      below 1e-6), then bf16 at SwinV2-L@384's four stage shapes with the
      real shift mask where the stage has one, the forward at 32 images and
      the backward at 8, scales exp(U[ln 10, ln 100]) as the model's
      logit_scale; the backward twice for the same bits; the time, the plain
      version's, ``F.normalize`` then SDPA's and the bound;
   c. the entries on CUDA tensors with ``impl="auto"`` at those widths,
      forward and under autograd, with every count set to 0 before: one
      launch a call of the right kernel entry, none for
      ``dot_product_attention`` with a bias (its plain body, as JAX's);
   with controls that must fail the checks: K9 with the score scale 1, K12
   with each head's scale 1, K12 with dscale zeroed.

Any failure raises and exits non-zero. The second-to-last line is a JSON
object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
SERVE_BATCH, SERVE_IMAGES = 256, 3 * 256 + 40   # 4 forwards, the last ragged
TTA_BATCH, TTA_IMAGES = 32, 2 * 32 + 8          # 3 forwards of 32·8 views
BLOCKS = 12                                      # ViT-B: one K1 launch per block
NORMS = 2 * BLOCKS + 1                           # ViT-B LayerNorms: one K4 each
MICRO, ACCUM, TIMED_STEPS = 64, 2, 5             # training: macro batch 128
SWIN = "swinv2_large_window12to24_192to384.ms_in22k_ft_in1k"
SWIN_SIZE, SWIN_DEPTHS = 384, (2, 2, 18, 2)      # one K5 launch per block
SWIN_BATCH, SWIN_IMAGES = 32, 3 * 32 + 8         # 4 forwards, the last ragged
SWIN_TTA_BATCH, SWIN_TTA_IMAGES = 8, 2 * 8 + 4   # 3 forwards of 8·8 views
# K5's shapes in SwinV2-L@384 at batch 32: (windows W0, rows a window B,
# tokens N, heads H, side of the map for the shift mask or None, launches a
# forward). Stages 2 and 3 are one window that covers the map: no mask.
SWIN_STAGES = ((16, 32, 576, 6, 96, 2), (4, 32, 576, 12, 48, 2),
               (1, 32, 576, 24, None, 18), (1, 32, 144, 48, None, 2))
SWIN_MICRO, SWIN_ACCUM = 8, 2                    # SwinV2-L training: macro 16
SWIN_DROP_PATH, SWIN_LLRD = 0.2, 0.8
# the same stages at a training micro-batch of 8: K6's shapes
SWIN_TRAIN_STAGES = tuple((w0, SWIN_MICRO, n, h, side, count)
                          for w0, _, n, h, side, count in SWIN_STAGES)

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances of the kernel against its plain version on the card.
# fp32: both keep fp32 scores, max and sums; they differ by summation order
# and __expf over 197 keys.
K1_ATOL_FP32 = 2e-5
# bf16: outputs are averages of bf16 values of |v| < 8, where one bf16 ulp is
# 2^-5; both round the softmax weights to bf16 before P·V, the plain version
# after normalising them (the XLA branch's cast, as the TPU kernel does) and
# the kernel before (its online softmax divides the fp32 sum at the end), so
# each weight differs by a bf16 rounding and the two may round the output one
# ulp apart.
K1_ATOL_BF16 = 2.0 ** -5
# Logits of the whole bf16 model, kernel against plain attention, as the RMS
# of the difference over the RMS of the plain logits. The one-ulp differences
# above pass through 12 blocks of bf16 matmuls and residual adds; with the
# weights of ``perturb`` (non-zero biases, peaked attention) a wrong qkv bias
# or softmax scale moves the logits by a third of their RMS or more, and the
# run checks that dropping the qkv bias does exceed the limit.
LOGITS_RTOL_BF16 = 0.1
# K2's log-sum-exp against torch.logsumexp of the same fp32 scores (values of
# 5-10): summation order, __expf and logf.
K2_LSE_ATOL = 1e-4
# K3 (dqkv, dbias) against autograd of the plain version, as a share of the
# largest |value|: fp32, sums over N keys and B·N rows in another order;
# bf16, four bf16 ulps of the largest value — the plain backward rounds P, dP
# and dS to bf16 at each cast of its forward, the kernel keeps them fp32.
K3_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}

# K10 is K1-K3 without the bias: K1's, K2's and K3's tolerances, for their
# reasons. K11's output: fp32 atol 1e-4, the qkv its GEMM sums over D = 768
# products in another order than the plain fp32 matmul (~1e-6 of |qkv|) feeds
# the attention, then K1's 2e-5; bf16 2^-5 as K1 (qkv rounds to the same bf16
# value unless the two fp32 sums straddle a rounding boundary, and the two
# round the softmax weights at K1's two places). K11's dx, dW
# and db, as shares of the largest |value|: fp32 1e-4 (sums over N keys, B·N
# rows and 3E columns in another order); bf16 2^-5, four bf16 ulps of the
# largest value, as K3 (its dqkv carries K3's difference; each of dx, dW and
# db sums it in fp32 and rounds once).
K11_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
K11_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}

# K4 against ln_bwd_plain, as a share of the largest |value|: dx fp32 1e-5,
# bf16 2^-6 (both round dx to bf16, one ulp apart from fp32 sums in another
# order); dgamma and dbeta 1e-4 (fp32 sums over the rows in another order).
K4_DX_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
K4_SUM_TOL = 1e-4
# The gradient of each parameter over one macro batch, kernel path against
# the plain attention and LayerNorm backward, as the RMS of the difference
# over the RMS of the plain gradient. As for the logits: bf16 roundings that
# differ by an ulp (K2 rounds P to bf16 before normalising where the plain
# forward rounds it after, K3 keeps P, dP and dS fp32) pass through 12
# blocks forward and back; a wrong bias gradient, scale or softmax moves a
# leaf's gradient by its own size, and the run checks that zeroing K3's bias
# gradient exceeds the limit.
GRAD_RTOL_BF16 = 0.1
# A leaf whose gradient is 0 in exact arithmetic carries only rounding noise,
# which no relative error can hold: the check leaves out every leaf whose
# plain-path RMS gradient is at most NOISE_SHARE x the median leaf's. The
# noise of a bf16 sum that cancels is about one bf16 ulp (2^-8) of the terms
# it sums, which are of a typical gradient's size; the limit allows four. The
# biases of the metadata branch's two Dense layers must be among the leaves
# left out: they feed a BatchNorm in training mode, which subtracts the batch
# mean (the CPU step test leaves them out of its per-element check too). A
# real gradient on either breaks the rule and fails the run.
NOISE_SHARE = 2.0 ** -6
# K5 against its plain version, for K1's reasons: fp32, both keep fp32 scores
# (here plus the fp32 bias and mask), max and sums, and differ by summation
# order and __expf over up to 576 keys; bf16, the plain version rounds the
# softmax weights to bf16 before P·V and the kernel keeps them fp32, one bf16
# ulp (2^-5) of outputs below 8. The log-sum-exp (values up to ~40, where an
# fp32 ulp is 4e-6) against torch.logsumexp of the plain fp32 scores.
K5_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -5}
K5_LSE_ATOL = 1e-4
# Logits of the bf16 SwinV2-L, K5 against the plain attention: as for the
# ViT, RMS of the difference over the RMS of the plain logits, one-ulp
# differences through 24 post-norm blocks. The limit is a tenth of the ViT's:
# SwinV2 pools the mean over its tokens, which averages away both the
# rounding differences and most of what a changed attention pattern does (a
# softmax row sums to 1 whatever its weights), where the ViT reads the one cls
# token. The control, the plain path with the relative-position bias zeroed,
# must exceed the limit: on these seeded weights it reads about 0.02 and the
# kernel path about 0.003.
SWIN_LOGITS_RTOL_BF16 = 0.01
ZERO_GRAD = ("metadata_branch.net.0.bias", "metadata_branch.net.4.bias")
# K6 (dq, dk, dv, dbias) against autograd of the plain version. fp32, as K3:
# a share of the largest |value|, sums over N keys and (dbias) W0·B rows in
# another order and __expf. bf16, as the RMS of the difference over the RMS of
# the plain gradient: both round P to bf16 before dv; the kernel rounds dS to
# bf16 before dq and dk where the plain backward keeps it fp32, and the plain
# backward rounds dP to bf16 where the kernel keeps it fp32, so every term of
# a sum differs by a bf16 rounding (2^-9 of its size) and the rounded outputs
# by an ulp here and there: some 2^-8 of the RMS. A wrong window index, mask,
# lse or a dropped ragged tile moves whole rows by their own size.
K6_TOL_FP32 = 1e-4
K6_RTOL_BF16 = 2.0 ** -6
# The gradient of each SwinV2-L parameter over one macro batch, kernel path
# against the plain attention and LayerNorm backward, as for the ViT (RMS of
# the difference over the RMS of the plain gradient), through 24 post-norm
# blocks forward and back. Most leaves read about 0.01; the limit is some
# four times that. SwinV2 has leaves that bf16 rounding alone moves by more:
# the gradients of q_bias, logit_scale and the cpb_mlp are sums that cancel
# (a row of dS sums to 0, and the cosine norm removes dq's radial part), so a
# leaf is allowed the limit plus twice its own rounding noise, measured in
# the same run as how far the plain path is from the plain path with its
# attention computed in fp32. A leaf whose noise exceeds NOISY_LEAF differs
# by a quarter of its size between two correct paths and can judge no third:
# it is printed, not judged. The two biases before a training-mode BatchNorm
# must be among those, and the leaves of the control and the q, k and v rows
# of every qkv weight (judged apart: they carry dq, dk and dv without the
# cancelling sums) must not. The control, K6 with its bias gradient zeroed,
# leaves the cpb_mlp leaves without their only gradient and must fail on
# every one. The check runs right after the warm-up step: six steps later
# these seeded, perturbed weights have moved to where rounding alone moves
# the median leaf by 0.12 and the check could tell little.
SWIN_GRAD_RTOL_BF16 = 0.05
NOISY_LEAF = 0.25
# Phase 11. K9 is K10's kernel on three tensors: K10's tolerances (K1's,
# K2's and K3's), for their reasons; against K10 on the same values, the
# same bits. K12 against its plain version: the output fp32 atol 1e-4 (K5's
# 2e-5, and the two normalise in other orders, q·(r·s) against q/‖q‖·s, an
# ulp or two apart on scores up to s + 16 = 116, where an fp32 ulp is 8e-6);
# its gradients fp32 1e-4 of the largest |value|, as K6. bf16, each output and
# gradient as the RMS of the difference over the RMS of the plain value,
# 2^-6 as K6's: both round q̂ and k̂, P and dS to bf16 (K6's reasons), and an
# element of q̂ or k̂ whose two fp32 values straddle a bf16 rounding boundary
# moves its row's scores by a bf16 ulp of it, rarely, which a max would
# charge in full. dscale = Σ q̂·dq̂n is a sum that cancels (Σ_j dS_ij = 0, so
# it is Σ_j dS_ij·(s_ij − c) for any c). The kernel rounds dS to bf16 before
# dq̂n, as the TPU kernel does; autograd of the plain version keeps dS fp32
# and rounds dq̂n. The dS rounding moves dscale more: the kernel's bf16
# dscale, and JAX's kernel's in interpret mode, sit further from the fp32
# value than the plain version's (11b prints the kernel's and the plain
# version's distances from the plain version run in fp32). So bf16 dscale is
# held at the same 2^-6 to ``windowed_cosine_dscale``, the plain version in
# the TPU kernel's order, from which the kernel differs only by summation
# order and rare straddled roundings. K12's log-sum-exp against torch.logsumexp of the plain
# version's fp32 scores: fp32 atol 1e-4 (values up to ~125; K5's reasons);
# bf16 the mean |difference| at most 2^-8, a bf16 ulp of the scores below 1,
# for the same rare straddles.
K12_ATOL_FP32 = 1e-4
K12_TOL_FP32 = 1e-4
K12_RTOL_BF16 = 2.0 ** -6
K12_LSE_ATOL_FP32 = 1e-4
K12_LSE_MEAN_BF16 = 2.0 ** -8
VIT_L_ATTENTION = (16, 577, 16, 64)   # ViT-L/16@384: (B, N, heads, d)
# Phase 9: the train augment at each configuration's macro batch (name,
# backbone, macro batch, canvas, image size), and the fold's images (train,
# validation, test; the test's last TTA batch of 16 is ragged). 1,280 train
# images make 10 steps an epoch, enough to time an epoch after the first.
AUG_CASES = (("vit", "vit_base_patch16_224", MICRO * ACCUM, 272, 224),
             ("swin", SWIN, SWIN_MICRO * SWIN_ACCUM, 448, SWIN_SIZE))
FOLD_IMAGES = (1280, 64, 40)
FOLD_WORKDIR = Path(__file__).resolve().parent / "build" / "chip_smoke_fold"
# K7 and K8 against their plain versions, the train augment through them
# against the same call through the plain versions: bit for bit (a shift
# moves values; equalize's fp32 values are integers below 2^24 and both
# divide correctly rounded).


def shift_shapes(macro: int, size: int):
    """K7's shapes in a train augment call: the rotation's canvas, padded by
    size // 3 with the mask as a 4th channel, and RandAugment's, padded by its
    rotation pad (ops/randaugment.py)."""
    rot = size + 2 * (size // 3)
    chain = size + 2 * max(8, int(math.tan(math.radians(12.0) / 2)
                                  * (size / 2)) + 2)
    return (macro, rot, rot, 4), (macro, chain, chain, 3)


def log(*parts) -> None:
    print(*parts, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    The calls are queued behind a sleeping kernel, so the events time the
    device's work and not the host's: a wrapper that takes longer to enqueue
    than its kernel takes to run would otherwise be timed by the host. If
    the sleep ended before the last call was queued, it runs again with a
    longer sleep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for cycles in (10 ** 8, 4 * 10 ** 8, 16 * 10 ** 8):   # from ~50 ms
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            break
    else:
        log("[time] the host queued the calls slower than the device ran "
            "them: this time includes the host's gaps")
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def short(dtype) -> str:
    return str(dtype).split(".")[-1]


def check_k1(fa, attention_from_qkvb, b, n, heads, d, dtype, atol, timed):
    """K1, through the wrapper the model calls, against its plain version on
    the same inputs; returns its record."""
    e = heads * d
    g = torch.Generator(device="cuda").manual_seed(SEED + b)
    qkv = torch.randn(b, n, 3 * e, device="cuda", generator=g).to(dtype)
    bias = 0.5 * torch.randn(3 * e, device="cuda", generator=g)
    out = fa.flash_attention_qkvb(qkv, bias, heads)
    torch.cuda.synchronize()
    want = attention_from_qkvb(qkv, bias, heads)
    if out.shape != (b, n, e) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"K1 {tuple(qkv.shape)} {dtype}: bad output")
    err = float((out.float() - want.float()).abs().max())
    log(f"[k1] qkv {tuple(qkv.shape)} {short(dtype)} heads {heads}: "
        f"max_abs_err {err!r} (tolerance {atol!r})")
    if not err <= atol:
        raise RuntimeError(f"K1 disagrees with its plain version: {err} > {atol}")
    rec = {"max_abs_err": err}
    if timed:
        q, k, v = biased_views(qkv, bias, heads)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec["ms"] = cuda_ms(lambda: fa.flash_attention_qkvb(qkv, bias, heads))
        rec["plain_ms"] = cuda_ms(lambda: attention_from_qkvb(qkv, bias, heads))
        rec["library_ms"] = cuda_ms(lambda: sdpa(q, k, v))
        nbytes = (qkv.numel() + bias.numel() + out.numel()) * qkv.element_size()
        flops = 4.0 * b * heads * n * n * d          # q·kᵀ and p·v
        rec.update(bound(nbytes, flops, dtype))
        log(f"[k1] kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r} ms, "
            f"sdpa {rec['library_ms']!r} ms (on the biased views), bound "
            f"{rec['bound_ms']!r} ms by {rec['bound_by']} ({nbytes} B, "
            f"{flops:.4g} flop)")
    return rec


def serving_inputs(n_images: int, canvas: int, seed: int = SEED):
    from fedvit_torch.data.constants import encode_metadata_batch
    from fedvit_torch.data.pipeline import ArrayDataSource

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(n_images, canvas, canvas, 3), dtype=np.uint8)
    mask = (rng.random((n_images, canvas, canvas, 1)) > 0.5).astype(np.uint8) * 255
    meta = encode_metadata_batch(rng.random(n_images),
                                 rng.integers(0, 3, n_images),
                                 rng.integers(0, 9, n_images))
    return ArrayDataSource({"image": np.concatenate([img, mask], axis=-1),
                            "label": rng.integers(0, 8, n_images),
                            "metadata": meta})


def perturb(model, seed: int) -> None:
    """Move every weight of the seeded model by seeded noise, so that biases
    are non-zero and attention is peaked: linear and patch-embedding weights
    by N(0, 4 / fan_in) (q·k scores then spread over several units), every
    other tensor by N(0, 0.25); BatchNorm variances stay positive. Buffers
    that the state dict leaves out (SwinV2's tables and masks) stay."""
    g = torch.Generator().manual_seed(seed)
    saved = set(model.state_dict())
    with torch.no_grad():
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            if not t.is_floating_point() or name not in saved:
                continue
            linear = name.endswith("weight") and t.dim() >= 2
            std = 2.0 / math.sqrt(t[0].numel()) if linear else 0.5
            t.add_(std * torch.randn(t.shape, generator=g).to(t.device))
            if name.endswith("running_var"):
                t.abs_().add_(0.5)


@contextlib.contextmanager
def rebound(module, name, fn):
    """``module.name`` is ``fn`` inside the block, and itself again after."""
    kernel = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def attention_replaced_by(fn):
    """Run the ViT's attention through ``fn`` instead of the kernel."""
    from fedvit_torch.models import layers
    return rebound(layers, "flash_attention_qkvb", fn)


def window_attention_replaced_by(fn):
    """Run the SwinV2's attention through ``fn`` instead of the kernel."""
    from fedvit_torch.models import swin
    return rebound(swin, "flash_attention_bias_flat", fn)


def rel_rms(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def compare_logits(name, got, want, limit=LOGITS_RTOL_BF16):
    if got.shape != want.shape or not np.isfinite(got).all():
        raise RuntimeError(f"{name}: logits {got.shape} not finite or wrong shape")
    err = rel_rms(got, want)
    log(f"[{name}] logits {got.shape} finite; kernel vs plain attention: RMS "
        f"error {err!r} x RMS logit (limit {limit!r}), RMS logit "
        f"{float(np.sqrt(np.mean(want ** 2)))!r}, max_abs_err "
        f"{float(np.abs(got - want).max())!r}")
    if not err <= limit:
        raise RuntimeError(f"{name}: kernel path disagrees with the plain path")


def expect_launches(name, fa, forwards):
    got = fa.flash_attention_qkvb.launches
    log(f"[{name}] K1 launches {got} for {forwards} forwards")
    if got != BLOCKS * forwards:
        raise RuntimeError(f"{name}: {got} K1 launches, want {BLOCKS * forwards}")
    return got


# The names of the ViT attention kernels in a device profile: the demangled
# instances of attention_fwd.cuh's fwd_kernel<D, kBias, kLse> (bf16, the
# tensor-core forward) and attention_bwd.cuh's kernels <T, D, kBias, kSum>,
# which K1-K3, K10 and K11 share, told apart by their flags. K11 adds
# gemm.cuh's bf16 products (wgmma_kernel).
K1_NAMES = (r"attn_fwd::fwd_kernel<[^>]*, true, false>",)
K2_NAMES = (r"attn_fwd::fwd_kernel<[^>]*, true, true>",)
K3_NAMES = (r"attn_bwd::delta_kernel<",
            r"attn_bwd::(dkdv|dq)_kernel<[^>]*, true, true>",
            r"column_sum_kernel<")
K10_NAMES = (r"attn_fwd::fwd_kernel<[^>]*, false, false>",)
K10_LSE_NAMES = (r"attn_fwd::fwd_kernel<[^>]*, false, true>",)
K10_BWD_NAMES = (r"attn_bwd::delta_kernel<",
                 r"attn_bwd::(dkdv|dq)_kernel<[^>]*, false, false>")
K11_GEMM_NAMES = (r"gemm::wgmma_kernel<",)
K11_BWD_NAMES = (r"attn_bwd::delta_kernel<",
                 r"attn_bwd::(dkdv|dq)_kernel<[^>]*, false, true>",
                 r"column_sum_kernel<")
K4_NAMES = ("ln_bwd_rows_kernel", "ln_bwd_columns_kernel")


def in_group(key, patterns) -> bool:
    """Whether a profile entry's name matches one of ``patterns`` (regular
    expressions; a plain part of a name is one too)."""
    return any(re.search(p, key) for p in patterns)


def device_events(prof):
    """The profile's device-side entries (kernels, copies), longest first,
    and their total ms: an aten op's own entry repeats the time of the
    kernels it launched, so only these add up to the device's busy time."""
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0),
                    key=lambda e: e.self_device_time_total, reverse=True)
    return events, sum(e.self_device_time_total for e in events) / 1e3


def trace_serving(model, step, augment, source, cfg, smi, batch_size=SERVE_BATCH,
                  kernel=("K1", K1_NAMES), tag="") -> None:
    """Stages of each full serving batch, then a profile of ``_evaluate``;
    ``kernel`` is the attention kernel's label and the patterns of its names
    in the profile (see in_group), ``tag`` marks the lines of another model
    or attention than the ViT's ``auto``."""
    from torch.profiler import ProfilerActivity, profile

    from fedvit_torch.eval.serve import _evaluate, _to_device

    stages_tag, profile_tag = f"[stages{tag}]", f"[profile{tag}]"
    n = math.ceil(len(source) / batch_size)
    stages = {k: [] for k in ("gather", "to_device", "augment", "forward",
                              "to_host")}
    with torch.inference_mode():
        for i in range(n - 1):                       # the full batches
            t = [time.perf_counter()]
            batch = source.gather(np.arange(i * batch_size, (i + 1) * batch_size))
            t.append(time.perf_counter())
            dev = _to_device(batch, torch.device("cuda"))
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            dev = augment(dev)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            logits = model(dev["image"], dev["metadata"])["logits"]
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            logits.float().cpu().numpy()
            t.append(time.perf_counter())
            for k, a, b in zip(stages, t, t[1:]):
                stages[k].append((b - a) * 1e3)
    total = float(sum(np.median(v) for v in stages.values()))
    log(f"{stages_tag} batch {batch_size}, median of {n - 1} ({smi}):")
    for k, v in stages.items():
        ms = float(np.median(v))
        log(f"{stages_tag}   {k:10s} {ms!r} ms ({100 * ms / total:.1f}%)")
    log(f"{stages_tag}   total {total!r} ms = {batch_size / total * 1e3!r} img/s "
        f"synchronised")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _evaluate(step, source, batch_size, cfg.num_classes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events, device_ms = device_events(prof)
    log(f"{profile_tag} {n} batches: wall {wall_ms!r} ms, device {device_ms!r} ms, "
        f"busy {100 * device_ms / wall_ms:.1f}% ({smi})")
    for e in events[:15]:
        ms = e.self_device_time_total / 1e3
        log(f"{profile_tag}   {ms / n!r} ms/batch ({100 * ms / device_ms:.1f}%) "
            f"x{e.count / n:g} {e.key[:90]}")
    k_ms = sum(e.self_device_time_total for e in events
               if in_group(e.key, kernel[1])) / 1e3
    log(f"{profile_tag} {kernel[0]} {k_ms / n!r} ms/batch = "
        f"{100 * k_ms / device_ms:.1f}% of device time")
    if not k_ms > 0:
        raise RuntimeError(f"{profile_tag}: no device time under {kernel[0]}'s "
                           f"names {kernel[1]}")


def seeded(shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (scale * torch.randn(shape, device="cuda", generator=g)).to(dtype)


def rel_max(got, want) -> float:
    """max |got − want| as a share of max |want| (or of 1 when smaller)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def attention_lse_plain(attention_from_qkvb, qkv, bias, heads):
    """K2's plain version: the plain attention and torch.logsumexp of its
    fp32 scaled scores, (B, H, N)."""
    b, n, e3 = qkv.shape
    e, d = e3 // 3, e3 // 3 // heads
    x = qkv + bias.to(qkv.dtype)
    q, k = (x[..., i * e:(i + 1) * e].reshape(b, n, heads, d).float()
            for i in (0, 1))
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(d)
    return attention_from_qkvb(qkv, bias, heads), torch.logsumexp(s, -1)


def qkv_views(qkv, heads):
    """q, k, v (B, H, N, d) views of a packed (B, N, 3E) tensor."""
    b, n, e3 = qkv.shape
    return qkv.view(b, n, 3, heads, e3 // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)


def biased_views(qkv, bias, heads):
    return qkv_views(qkv + bias.to(qkv.dtype), heads)


def check_k2(fa, attention_from_qkvb, b, n, heads, dtype, timed, d=64):
    """K2 through its wrapper: the output bit-identical to K1's and within
    K1's tolerance of the plain version, the log-sum-exp within
    K2_LSE_ATOL."""
    e = heads * d
    qkv = seeded((b, n, 3 * e), dtype, SEED + 10 + n)
    bias = seeded((3 * e,), torch.float32, SEED + 11 + n, 0.5)
    out, lse = fa.qkvb_attention_lse_cuda(qkv, bias, heads)
    torch.cuda.synchronize()
    same = torch.equal(out, fa.qkvb_attention_cuda(qkv, bias, heads))
    want, want_lse = attention_lse_plain(attention_from_qkvb, qkv, bias, heads)
    err = float((out.float() - want.float()).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    atol = K1_ATOL_FP32 if dtype == torch.float32 else K1_ATOL_BF16
    log(f"[k2] qkv {tuple(qkv.shape)} {short(dtype)}: out max_abs_err {err!r} "
        f"(tolerance {atol!r}), bit-identical to K1: {same}; lse max_abs_err "
        f"{lse_err!r} (tolerance {K2_LSE_ATOL!r})")
    if not (same and err <= atol and lse_err <= K2_LSE_ATOL
            and bool(torch.isfinite(lse).all())):
        raise RuntimeError("K2 disagrees with K1 or with its plain version")
    rec = {"max_abs_err": err}
    if timed:
        q, k, v = biased_views(qkv, bias, heads)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec["ms"] = cuda_ms(lambda: fa.qkvb_attention_lse_cuda(qkv, bias, heads))
        rec["plain_ms"] = cuda_ms(
            lambda: attention_lse_plain(attention_from_qkvb, qkv, bias, heads))
        rec["library_ms"] = cuda_ms(lambda: sdpa(q, k, v))
        nbytes = ((qkv.numel() + bias.numel() + out.numel()) * qkv.element_size()
                  + lse.numel() * 4)
        rec.update(bound(nbytes, 4.0 * b * heads * n * n * d, dtype))
        log(f"[k2] kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r} ms, sdpa "
            f"forward {rec['library_ms']!r} ms, bound {rec['bound_ms']!r} ms by "
            f"{rec['bound_by']} ({nbytes} B)")
    return rec


def check_k3(fa, attention_from_qkvb, b, n, heads, dtype, timed, d=64):
    """K3 through the autograd Function (K2 forward, K3 backward): dqkv and
    dbias against autograd of the plain version on the same seeded dout."""
    e = heads * d
    qkv = seeded((b, n, 3 * e), dtype, SEED + 20 + n)
    bias = seeded((3 * e,), torch.float32, SEED + 21 + n, 0.5)
    dout = seeded((b, n, e), dtype, SEED + 22 + n)
    qkv_g, bias_g = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    out = fa.flash_attention_qkvb(qkv_g, bias_g, heads)
    dqkv, dbias = torch.autograd.grad(out, (qkv_g, bias_g), dout)
    torch.cuda.synchronize()
    qkv_p, bias_p = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    out_p = attention_from_qkvb(qkv_p, bias_p, heads)
    want_dqkv, want_dbias = torch.autograd.grad(out_p, (qkv_p, bias_p), dout,
                                                retain_graph=True)
    tol = K3_TOL[dtype]
    errs = (rel_max(dqkv, want_dqkv), rel_max(dbias, want_dbias))
    err = float((dqkv.float() - want_dqkv.float()).abs().max())
    log(f"[k3] qkv {tuple(qkv.shape)} {short(dtype)}: dqkv max_abs_err {err!r}, "
        f"{errs[0]!r} of max |dqkv| {float(want_dqkv.abs().max())!r}; dbias "
        f"{errs[1]!r} of max |dbias| {float(want_dbias.abs().max())!r} "
        f"(tolerance {tol!r} of the largest |value|)")
    if not (max(errs) <= tol and bool(torch.isfinite(dqkv).all())
            and dqkv.dtype == dtype and dbias.dtype == torch.float32):
        raise RuntimeError("K3 disagrees with its plain version")
    rec = {"max_abs_err": err}
    if timed:
        o, lse = fa.qkvb_attention_lse_cuda(qkv, bias, heads)
        rec["ms"] = cuda_ms(
            lambda: fa.qkvb_attention_bwd_cuda(qkv, bias, o, dout, lse, heads))
        rec["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out_p, (qkv_p, bias_p), dout, retain_graph=True))
        qkv_s, bias_s = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        out_s = torch.nn.functional.scaled_dot_product_attention(
            *biased_views(qkv_s, bias_s, heads))
        rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out_s, (qkv_s, bias_s), dout.view(b, n, heads, d).transpose(1, 2),
            retain_graph=True))
        nbytes = ((2 * qkv.numel() + 2 * o.numel() + bias.numel())
                  * qkv.element_size() + (lse.numel() + dbias.numel()) * 4)
        rec.update(bound(nbytes, 10.0 * b * heads * n * n * d, dtype))
        log(f"[k3] kernel {rec['ms']!r} ms, plain backward {rec['plain_ms']!r} "
            f"ms, sdpa backward {rec['library_ms']!r} ms (on the biased views), "
            f"bound {rec['bound_ms']!r} ms by {rec['bound_by']} ({nbytes} B)")
    return rec


def check_k4(ln, shape, dtype, timed):
    """K4 through ``layer_norm_bwd`` against ``ln_bwd_plain``."""
    d = shape[-1]
    x = (seeded(shape, torch.float32, SEED + 30 + d, 2.0) + 0.5).to(dtype)
    dy = seeded(shape, dtype, SEED + 31 + d)
    w = 1.0 + seeded((d,), torch.float32, SEED + 32 + d, 0.3)
    got = ln.layer_norm_bwd(x, w, dy, 1e-6)
    torch.cuda.synchronize()
    want = ln.ln_bwd_plain(x, w, dy, 1e-6)
    errs = [rel_max(a, b) for a, b in zip(got, want)]
    tols = (K4_DX_TOL[dtype], K4_SUM_TOL, K4_SUM_TOL)
    err = float((got[0].float() - want[0].float()).abs().max())
    log(f"[k4] x {shape} {short(dtype)}: dx max_abs_err {err!r}; as shares of "
        f"the largest |value|, dx {errs[0]!r}, dgamma {errs[1]!r}, dbeta "
        f"{errs[2]!r} (tolerances {tols[0]!r}, {tols[1]!r}, {tols[2]!r})")
    if not all(e <= t for e, t in zip(errs, tols)):
        raise RuntimeError("K4 disagrees with its plain version")
    rec = {"max_abs_err": err}
    if timed:
        rec["ms"] = cuda_ms(lambda: ln.layer_norm_bwd(x, w, dy, 1e-6))
        rec["plain_ms"] = cuda_ms(lambda: ln.ln_bwd_plain(x, w, dy, 1e-6))
        xr = x.clone().requires_grad_()
        wr = w.to(dtype).requires_grad_()
        br = torch.zeros(d, device="cuda", dtype=dtype, requires_grad=True)
        f = torch.nn.functional.layer_norm
        fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
            f(xr, (d,), wr, br, 1e-6), (xr, wr, br), dy))
        fwd = cuda_ms(lambda: f(xr, (d,), wr, br, 1e-6))
        rec["library_ms"] = fwd_bwd - fwd
        nbytes = 3 * x.numel() * x.element_size() + 3 * d * 4
        # per element: mean and E[x²] 3, xhat 2, g 1, the two means 3,
        # dgamma and dbeta 3, dx 4 — 16 fp32 operations
        rec.update(bound(nbytes, 16.0 * x.numel(), torch.float32))
        log(f"[k4] kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r} ms, "
            f"F.layer_norm backward {rec['library_ms']!r} ms (forward+backward "
            f"{fwd_bwd!r} − forward {fwd!r}), bound {rec['bound_ms']!r} ms by "
            f"{rec['bound_by']} ({nbytes} B)")
    return rec


def counted(fa, ln) -> dict:
    """Every kernel wrapper that counts its launches, by kernel (the
    attention kernels only when ``ln`` is None)."""
    fns = {"K1": fa.flash_attention_qkvb, "K2": fa.qkvb_attention_lse_cuda,
           "K3": fa.qkvb_attention_bwd_cuda,
           "K10": fa.flash_attention_qkv, "K10_lse": fa.qkv_attention_lse_cuda,
           "K10_bwd": fa.qkv_attention_bwd_cuda,
           "K11": fa.flash_attention_xqkv, "K11_lse": fa.xqkv_attention_lse_cuda,
           "K11_bwd": fa.xqkv_attention_bwd_cuda,
           "K5": fa.flash_attention_bias_flat,
           "K5_lse": fa.window_attention_lse_cuda,
           "K6": fa.window_attention_bwd_cuda,
           "K9": fa.flash_attention_flat, "K9_lse": fa.flat_attention_lse_cuda,
           "K9_bwd": fa.flat_attention_bwd_cuda,
           "K12": fa.flash_attention_cosine_flat,
           "K12_lse": fa.cosine_window_attention_lse_cuda,
           "K12_bwd": fa.cosine_window_attention_bwd_cuda}
    return fns if ln is None else fns | {"K4": ln.layer_norm_bwd_cuda}


def launch_counts(fa, ln) -> dict:
    return {k: fn.launches for k, fn in counted(fa, ln).items()}


def reset_counts(fa, ln) -> None:
    for fn in counted(fa, ln).values():
        fn.launches = 0


def layer_norm_backward_replaced_by(fn):
    """Run every LayerNorm backward through ``fn`` instead of K4."""
    from fedvit_torch.ops import layer_norm
    return rebound(layer_norm, "layer_norm_bwd", fn)


def k3_without_dbias(fa):
    """K2 forward and K3 backward with K3's bias gradient replaced by zeros:
    the control of 6c, in the model's place of ``flash_attention_qkvb``."""

    class WithoutDbias(fa.QkvbAttention):
        @staticmethod
        def backward(ctx, dout):
            dqkv, dbias, _ = fa.QkvbAttention.backward(ctx, dout)
            return dqkv, torch.zeros_like(dbias), None

    return WithoutDbias.apply


def training_batches(cfg, n_batches: int, macro: int):
    """Macro batches on the card: seeded uint8 canvases through the eval
    augment, standing in for the train augment (not ported yet)."""
    from fedvit_torch.data.pipeline import canvas_size, make_device_augment
    from fedvit_torch.eval.serve import _to_device

    source = serving_inputs(n_batches * macro, canvas_size(cfg.model.image_size))
    augment = make_device_augment(cfg, False)
    with torch.no_grad():
        return [augment(_to_device(source.gather(np.arange(i * macro,
                                                           (i + 1) * macro)),
                                   torch.device("cuda")))
                for i in range(n_batches)]


def training_setup(backbone, image_size, micro, accum, drop_path, llrd,
                   attention_impl="auto"):
    """The current-generation recipe on ``backbone``: (cfg, model, state,
    step, 1 + TIMED_STEPS macro batches)."""
    from fedvit_torch.core.config import (AugmentationConfig, Config,
                                          DataConfig, LLRDConfig, LossConfig,
                                          ModelConfig, OptimizerConfig,
                                          SchedulerConfig, EMAConfig,
                                          TrainingConfig)
    from fedvit_torch.models import build_model
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step

    cfg = Config(
        data=DataConfig(use_segmentation_mask=True),
        model=ModelConfig(backbone=backbone, image_size=image_size,
                          compute_dtype="bfloat16", drop_path_rate=drop_path,
                          attention_impl=attention_impl),
        training=TrainingConfig(
            batch_size=micro, gradient_accumulation_steps=accum,
            optimizer=OptimizerConfig(lr=1e-4),
            scheduler=SchedulerConfig(warmup_epochs=0),
            llrd=LLRDConfig(decay_rate=llrd, head_lr_mult=10.0),
            grad_clip=1.0, ema=EMAConfig(decay=0.9995)),
        augmentation=AugmentationConfig(),       # MixUp 0.4 + CutMix 1.0 p0.7
        loss=LossConfig(type="asymmetric"))
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    perturb(model, SEED)
    tx, _ = build_optimizer(cfg, model, steps_per_epoch=100)
    state = TrainState.create(model, tx, seed=SEED)
    step = make_train_step(cfg, build_loss(cfg))
    batches = training_batches(cfg, 1 + TIMED_STEPS, micro * accum)
    return cfg, model, state, step, batches


def warm_up_step(tag, cfg, model, state, step, batch):
    """One step, checked: every parameter moves, and the EMA shadow moves by
    (1 − d) of the step's update."""
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, m = step(state, batch)
    torch.cuda.synchronize()
    d = cfg.training.ema.decay
    still = [n for n, p in model.named_parameters() if torch.equal(p, before[n])]
    num = den = worst = 0.0
    for n, p in model.named_parameters():
        dp = (p.detach() - before[n]).double()
        de = (state.ema[n] - before[n]).double()
        num += float((de * dp).sum())
        den += float((dp * dp).sum())
        want = d * before[n] + (1 - d) * p.detach()
        worst = max(worst, float((state.ema[n] - want).abs().max())
                    / max(float(before[n].abs().max()), 1e-30))
    ratio = num / den
    log(f"[{tag}] warm-up step: loss {float(m['loss'])!r}, grad_norm "
        f"{float(m['grad_norm'])!r}; parameters that did not move: "
        f"{len(still)} of {len(before)} {still[:5]}; EMA moved by {ratio!r} of "
        f"the update (want 1 − d = {1 - d!r}), largest deviation from "
        f"d·s + (1−d)·p {worst!r} of the leaf's size")
    # the shadow's change is (1 − d)·Δp plus its own fp32 rounding, which is
    # of Δp's size on leaves at the lowest LLRD scales; so the ratio is held
    # to 1%, and the update itself to a few ulps of the leaf
    if still or not abs(ratio - (1 - d)) <= 1e-2 * (1 - d) or worst > 1e-6:
        raise RuntimeError("the warm-up step did not move the parameters or "
                           "the EMA shadow as it should")
    return state


def timed_steps(tag, what, fa, ln, state, step, batches, want, smi):
    """The timed steps: launch counts against ``want``, finite losses, img/s
    and peak memory; returns (state, counts)."""
    macro = batches[0]["image"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, ln)
    metrics = []
    t0 = time.perf_counter()
    for batch in batches:
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = launch_counts(fa, ln)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    log(f"[{tag}] steps {state.step}: loss {losses}, grad_norm {norms}")
    log(f"[{tag}] launches in {len(batches)} steps: {counts} (want {want})")
    if counts != want:
        raise RuntimeError("the training step did not launch the kernels as "
                           "it should")
    if not all(math.isfinite(v) for v in losses + norms) or \
            len(set(losses)) < 2:
        raise RuntimeError("the training loss is not finite or does not move")
    log(f"[{tag}] {what}, macro batch {macro} ({step.accum} x "
        f"{macro // step.accum}): {len(batches)} steps in {train_s!r} s = "
        f"{len(batches) * macro / train_s!r} img/s, "
        f"{train_s / len(batches) * 1e3!r} ms/step, peak {peak_gb!r} GiB ({smi})")
    return state, counts


def grads_by_path(model, state, step, batch, paths):
    """One macro batch's gradients by parameter name (fp32) and loss, once for
    each entry of ``paths`` (name → context managers to run inside, none for
    the kernels), every time from the same generator states and buffers."""
    snap = (state.generator.get_state(), state.np_rng.bit_generator.state,
            {n: t.clone() for n, t in model.named_buffers()})
    got = {}
    for name, managers in paths.items():
        state.generator.set_state(snap[0])
        state.np_rng.bit_generator.state = snap[1]
        with torch.no_grad():
            for n, t in model.named_buffers():
                t.copy_(snap[2][n])
        with contextlib.ExitStack() as stack:
            for ctx in managers:
                stack.enter_context(ctx)
            grads, loss, _ = step.accumulate_grads(state, batch)
        got[name] = ({n: g.float().clone() for n, g in grads.items()},
                     float(loss))
    for p in model.parameters():
        p.grad = None
    return got


def compare_grads(tag, got, limit, control_leaves, control_name, report=(),
                  noisy=lambda name: True):
    """Each leaf's gradient, ``got["kernel"]`` against ``got["plain"]``, as the
    RMS of the difference over the RMS of the plain gradient; ``got["control"]``
    must fail the same check on every one of ``control_leaves``. Leaves whose
    name ends in one of ``report`` are printed by group.

    What a leaf is allowed depends on what ``got`` holds. Without
    ``got["fp32"]``: ``limit``, and the leaves of noise-sized plain gradient
    (see NOISE_SHARE) are left out, the ZERO_GRAD ones required among them.
    With it (the plain path with its attention computed in fp32): ``limit``
    plus twice the leaf's own rounding noise, which is how far the plain path
    is from that fp32 path, for the leaves that ``noisy`` picks (all by
    default), ``limit`` for the others; leaves whose noise exceeds NOISY_LEAF
    are left out, the ZERO_GRAD ones required among them."""
    (kernel, loss_k), (plain, loss_p) = got["kernel"], got["plain"]
    control = got["control"][0]

    def errors(a, b, names):
        return {n: rel_rms(a[n].cpu().numpy(), b[n].cpu().numpy()) for n in names}

    if "fp32" in got:
        noise = errors(plain, got["fp32"][0], plain)
        left_out = {n: v for n, v in noise.items() if v > NOISY_LEAF}
        allowed = {n: limit + 2 * v if noisy(n) else limit
                   for n, v in noise.items() if n not in left_out}
        log(f"[{tag}] rounding noise of a leaf = plain path vs the plain path "
            f"with fp32 attention: median {float(np.median(list(noise.values())))!r}"
            f", largest by kind {group_max(noise)}; left out of the check "
            f"(noise > {NOISY_LEAF!r}): {left_out}")
        if not set(ZERO_GRAD) <= set(left_out):
            raise RuntimeError(f"a bias before a training-mode BatchNorm is not "
                               f"all noise: {({n: noise[n] for n in ZERO_GRAD})}")
    else:
        rms = {n: float(g.square().mean().sqrt()) for n, g in plain.items()}
        median = float(np.median(list(rms.values())))
        left_out = {n: r for n, r in rms.items() if r <= NOISE_SHARE * median}
        log(f"[{tag}] leaves with a noise-sized plain gradient (RMS <= "
            f"{NOISE_SHARE!r} x the median leaf's {median!r}), left out of the "
            f"check: RMS gradient {left_out}; the smallest leaves kept: "
            f"{sorted((r, n) for n, r in rms.items() if n not in left_out)[:3]}")
        if not set(ZERO_GRAD) <= set(left_out):
            raise RuntimeError(f"a bias before a training-mode BatchNorm has "
                               f"more than a noise-sized gradient: "
                               f"{({n: rms[n] for n in ZERO_GRAD})}")
        allowed = {n: limit for n in plain if n not in left_out}
    must_judge = [*control_leaves, *(n for n in plain if n.endswith("]"))]
    if not set(must_judge) <= set(allowed):
        raise RuntimeError(f"left out of the check: "
                           f"{sorted(set(must_judge) - set(allowed))}")
    errs = errors(kernel, plain, allowed)
    over = {n: (e, allowed[n]) for n, e in errs.items() if not e <= allowed[n]}
    worst = sorted(errs.items(), key=lambda kv: -kv[1] / allowed[kv[0]])[:3]
    ctrl = errors(control, plain, control_leaves)
    caught = [n for n in control_leaves if ctrl[n] > allowed[n]]
    log(f"[{tag}] grads, kernels vs plain path: loss {loss_k!r} vs {loss_p!r}; "
        f"RMS error / RMS grad over {len(errs)} leaves: median "
        f"{float(np.median(list(errs.values())))!r}, nearest their limits "
        f"{[(n, e, allowed[n]) for n, e in worst]} (limit {limit!r}); control, "
        f"{control_name}: smallest error over the {len(control_leaves)} leaves "
        f"{min(ctrl.values())!r}, {len(caught)} over their limits (largest "
        f"limit {max(allowed[n] for n in control_leaves)!r})")
    for suffix in report:
        group = {n: v for n, v in errs.items() if n.endswith(suffix)}
        if not group:
            log(f"[{tag}]   {suffix}: every leaf left out")
            continue
        log(f"[{tag}]   {suffix}: {len(group)} leaves, error median "
            f"{float(np.median(list(group.values())))!r}, largest "
            f"{max(group.values())!r}; limits from "
            f"{min(allowed[n] for n in group)!r} to "
            f"{max(allowed[n] for n in group)!r}")
    if over or not abs(loss_k - loss_p) <= limit * abs(loss_p):
        raise RuntimeError(f"the kernel path's gradients disagree with the "
                           f"plain path's: {over}")
    if len(caught) != len(control_leaves):
        raise RuntimeError(f"the gradient check cannot tell {control_name}")


def group_max(values) -> dict:
    """{leaf kind: (count, largest value)}, a kind being the leaf's name with
    its block and stage numbers taken out."""
    kinds = {}
    for n, v in values.items():
        kind = "".join(c for c in n if not c.isdigit()).replace("..", ".")
        count, top = kinds.get(kind, (0, 0.0))
        kinds[kind] = (count + 1, max(top, v))
    return kinds


def train_phase(fa, ln, attention_from_qkvb, smi, trace):
    """Phase 6b and 6c; returns the launch counts of the timed steps."""
    cfg, model, state, step, batches = training_setup(
        "vit_base_patch16_224", 224, MICRO, ACCUM, 0.1, 0.75)
    state = warm_up_step("train", cfg, model, state, step, batches[0])
    want = {k: 0 for k in counted(fa, ln)} | {
        "K2": TIMED_STEPS * ACCUM * BLOCKS, "K3": TIMED_STEPS * ACCUM * BLOCKS,
        "K4": TIMED_STEPS * ACCUM * NORMS}
    state, counts = timed_steps("train", "ViT-B/16@224 bf16 4ch+meta", fa, ln,
                                state, step, batches[1:], want, smi)

    # 6c. one macro batch's gradients, kernels against the plain path
    got = grads_by_path(model, state, step, batches[1], {
        "kernel": (),
        "plain": (attention_replaced_by(attention_from_qkvb),
                  layer_norm_backward_replaced_by(ln.ln_bwd_plain)),
        "control": (attention_replaced_by(k3_without_dbias(fa)),)})
    compare_grads("train", got, GRAD_RTOL_BF16,
                  [n for n in got["plain"][0] if n.endswith("attn.qkv.bias")],
                  "K3's dbias zeroed")
    if trace:
        trace_training("profile-train", step, state, batches[2], smi, {
            "K2": K2_NAMES, "K3": K3_NAMES, "K4": K4_NAMES})
    return counts


def trace_training(tag, step, state, batch, smi, groups) -> None:
    """A profile of one training step: device time by kernel, the busy share,
    and the share of each group of kernels (label → patterns of their names,
    see in_group); a group that reads no device time fails."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events, device_ms = device_events(prof)
    log(f"[{tag}] one step: wall {wall_ms!r} ms, device {device_ms!r} "
        f"ms in {sum(e.count for e in events)} kernels and copies, busy "
        f"{100 * device_ms / wall_ms:.1f}% ({smi})")
    for e in events[:20]:
        ms = e.self_device_time_total / 1e3
        log(f"[{tag}]   {ms!r} ms ({100 * ms / device_ms:.1f}%) "
            f"x{e.count} {e.key[:90]}")
    for k, names in groups.items():
        ms = sum(e.self_device_time_total for e in events
                 if in_group(e.key, names)) / 1e3
        log(f"[{tag}] {k} {ms!r} ms = {100 * ms / device_ms:.1f}% of "
            f"device time")
        if not ms > 0:
            raise RuntimeError(f"[{tag}]: no device time under {k}'s names "
                               f"{names}")


def window_inputs(w0, b, n, heads, dtype, side, seed):
    """K5's inputs as a SwinV2 block makes them: q and k of unit norm per head
    (q times a logit scale of 10), v normal, a bias of 16·sigmoid size, and
    the real shift mask of a ``side``² map of windows of √N (None: no mask)."""
    from fedvit_torch.models.swin import shift_attention_mask

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows, d = w0 * b, 32

    def unit(scale):
        t = torch.randn(rows, n, heads, d, device="cuda", generator=g)
        return (scale * t / t.norm(dim=-1, keepdim=True)).reshape(
            rows, n, heads * d).to(dtype)

    q, k = unit(10.0), unit(1.0)
    v = torch.randn(rows, n, heads * d, device="cuda", generator=g).to(dtype)
    bias = 16 * torch.sigmoid(
        2 * torch.randn(heads, n, n, device="cuda", generator=g))
    if side is None:
        return q, k, v, bias, None
    window = math.isqrt(n)
    mask = torch.from_numpy(
        shift_attention_mask(side, side, window, window // 2)).cuda()
    if mask.shape != (w0, n, n):
        raise RuntimeError(f"shift mask {tuple(mask.shape)} for W0 = {w0}")
    return q, k, v, bias, mask


def window_scores_lse(q, k, bias, mask, heads):
    """torch.logsumexp of the plain fp32 biased, masked scores: (W0·B, H, N)."""
    rows, n, e = q.shape
    w0 = 1 if mask is None else mask.shape[0]
    qh, kh = (t.reshape(w0, rows // w0, n, heads, e // heads).float()
              for t in (q, k))
    s = torch.einsum("wbnhd,wbmhd->wbhnm", qh, kh) + bias
    if mask is not None:
        s = s + mask[:, None, None]
    return torch.logsumexp(s, -1).reshape(rows, heads, n)


def check_k5(fa, plain, w0, b, n, heads, dtype, side, timed):
    """K5 through the wrapper the model calls, and its log-sum-exp variant,
    against the plain version on the same inputs; returns its record."""
    q, k, v, bias, mask = window_inputs(w0, b, n, heads, dtype, side,
                                        SEED + 50 + n + heads)
    out = fa.flash_attention_bias_flat(q, k, v, bias, mask, heads)
    torch.cuda.synchronize()
    out_l, lse, out32 = fa.window_attention_lse_cuda(q, k, v, bias, mask, heads)
    torch.cuda.synchronize()
    same = torch.equal(out, out_l) and torch.equal(out32.to(dtype), out_l)
    want = plain(q, k, v, bias, mask, heads)
    err = float((out.float() - want.float()).abs().max())
    lse_err = float((lse - window_scores_lse(q, k, bias, mask, heads)).abs().max())
    atol = K5_ATOL[dtype]
    shape = f"(W0 {w0}, B {b}, N {n}, H {heads}, d 32) {short(dtype)}"
    log(f"[k5] {shape}, mask {None if mask is None else tuple(mask.shape)}: "
        f"max_abs_err {err!r} (tolerance {atol!r}); lse variant bit-identical: "
        f"{same}, lse max_abs_err {lse_err!r} (tolerance {K5_LSE_ATOL!r})")
    if out.shape != q.shape or out.dtype != dtype or \
            not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"K5 {shape}: bad output")
    if not (err <= atol and same and lse_err <= K5_LSE_ATOL):
        raise RuntimeError(f"K5 {shape} disagrees with its plain version")
    rec = {"shape": {"W0": w0, "B": b, "N": n, "H": heads, "d": 32},
           "max_abs_err": err}
    if timed:
        rows = w0 * b
        views = [t.view(rows, n, heads, 32).transpose(1, 2) for t in (q, k, v)]
        added = bias[None] if mask is None else bias[None] + mask[:, None]
        attn_mask = added.to(dtype)[:, None].expand(
            added.shape[0], rows // added.shape[0], heads, n, n).reshape(
            rows, heads, n, n)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec["ms"] = cuda_ms(
            lambda: fa.flash_attention_bias_flat(q, k, v, bias, mask, heads),
            iters=8, warmup=2)
        rec["plain_ms"] = cuda_ms(lambda: plain(q, k, v, bias, mask, heads),
                                  iters=4, warmup=1)
        rec["library_ms"] = cuda_ms(
            lambda: sdpa(*views, attn_mask=attn_mask, scale=1.0),
            iters=8, warmup=2)
        nbytes = (4 * q.numel() * q.element_size() + bias.numel() * 4
                  + (0 if mask is None else mask.numel() * 4))
        flops = 4.0 * rows * heads * n * n * 32          # q·kᵀ and p·v
        rec.update(bound(nbytes, flops, dtype))
        log(f"[k5] kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r} ms, sdpa "
            f"{rec['library_ms']!r} ms (bias + mask as attn_mask), bound "
            f"{rec['bound_ms']!r} ms by {rec['bound_by']} ({nbytes} B, "
            f"{flops:.4g} flop)")
    return rec


def swin_phase(fa, ln, smi, trace):
    """Phase 7; returns K5's record (the stage-2 shape's numbers, the other
    stage shapes under "stages") with its launches in the serving run."""
    from fedvit_torch.core.config import (Config, DataConfig, ModelConfig,
                                          TrainingConfig)
    from fedvit_torch.data.pipeline import canvas_size, make_device_augment
    from fedvit_torch.eval.serve import (_evaluate, evaluate_with_tta,
                                         make_eval_step)
    from fedvit_torch.models import build_model
    from fedvit_torch.ops.attention import windowed_attention_flat as plain

    # 7a. K5 against its plain version
    for w0, b, n, heads in ((4, 3, 49, 2), (9, 2, 16, 3)):
        check_k5(fa, plain, w0, b, n, heads, torch.float32, math.isqrt(n) * math.isqrt(w0),
                 timed=False)
    check_k5(fa, plain, 1, 5, 64, 6, torch.float32, None, timed=False)
    stages = [check_k5(fa, plain, w0, b, n, heads, torch.bfloat16, side, True)
              for w0, b, n, heads, side, _ in SWIN_STAGES]
    per_forward = sum(r["ms"] * st[5] for r, st in zip(stages, SWIN_STAGES))
    log(f"[k5] a SwinV2-L@384 forward of {SWIN_BATCH} launches it "
        f"{[st[5] for st in SWIN_STAGES]} times: {per_forward!r} ms of K5")
    torch.cuda.empty_cache()

    # 7b. serving at batch 32, ragged last batch
    cfg = Config(
        data=DataConfig(use_segmentation_mask=True),
        model=ModelConfig(backbone=SWIN, image_size=SWIN_SIZE,
                          compute_dtype="bfloat16", drop_path_rate=0.0),
        training=TrainingConfig(batch_size=SWIN_BATCH))
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    perturb(model, SEED)
    log(f"[swin] {SWIN} built and perturbed in {time.perf_counter() - t0!r} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    canvas = canvas_size(SWIN_SIZE)
    source = serving_inputs(SWIN_IMAGES, canvas)
    augment = make_device_augment(cfg, False)
    step = make_eval_step(model, cfg, augment=augment)
    _evaluate(step, serving_inputs(SWIN_BATCH, canvas), SWIN_BATCH,
              cfg.num_classes)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocks = sum(SWIN_DEPTHS)

    def expect(name, forwards):
        got = launch_counts(fa, ln)
        want = {k: 0 for k in got} | {"K5": blocks * forwards}
        log(f"[{name}] launches for {forwards} forwards: {got} (want {want})")
        if got != want:
            raise RuntimeError(f"{name}: the SwinV2 forward did not launch the "
                               f"kernels as it should")
        return got["K5"]

    reset_counts(fa, ln)
    t0 = time.perf_counter()
    served = _evaluate(step, source, SWIN_BATCH, cfg.num_classes)
    serve_s = time.perf_counter() - t0
    launches = expect("swin-serve", math.ceil(SWIN_IMAGES / SWIN_BATCH))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    with window_attention_replaced_by(plain):
        plain_out = _evaluate(step, source, SWIN_BATCH, cfg.num_classes)
    compare_logits("swin-serve", served["logits"], plain_out["logits"],
                   SWIN_LOGITS_RTOL_BF16)
    # the control: without the relative-position bias the logits must leave
    # the limit
    with window_attention_replaced_by(
            lambda q, k, v, bias, mask, h: plain(q, k, v, bias * 0, mask, h)):
        no_bias = _evaluate(step, source, SWIN_BATCH, cfg.num_classes)
    control = rel_rms(no_bias["logits"], plain_out["logits"])
    log(f"[swin-serve] control, plain attention without the relative-position "
        f"bias: RMS error {control!r} x RMS logit (must exceed "
        f"{SWIN_LOGITS_RTOL_BF16!r})")
    if not control > SWIN_LOGITS_RTOL_BF16:
        raise RuntimeError("the logits check cannot tell a dropped "
                           "relative-position bias")
    log(f"[swin-serve] SwinV2-L@384 bf16 4ch+meta bs {SWIN_BATCH}: "
        f"{SWIN_IMAGES} images in {serve_s!r} s = {SWIN_IMAGES / serve_s!r} "
        f"img/s, peak {peak_gb!r} GiB ({smi})")

    # 7c. 8-view TTA at batch 8
    tta_source = serving_inputs(SWIN_TTA_IMAGES, canvas)
    reset_counts(fa, ln)
    t0 = time.perf_counter()
    _, _, tta_logits = evaluate_with_tta(cfg, model, tta_source,
                                         batch_size=SWIN_TTA_BATCH)
    tta_s = time.perf_counter() - t0
    expect("swin-tta", math.ceil(SWIN_TTA_IMAGES / SWIN_TTA_BATCH))
    with window_attention_replaced_by(plain):
        _, _, tta_plain = evaluate_with_tta(cfg, model, tta_source,
                                            batch_size=SWIN_TTA_BATCH)
    compare_logits("swin-tta", tta_logits, tta_plain, SWIN_LOGITS_RTOL_BF16)
    log(f"[swin-tta] 8 views bs {SWIN_TTA_BATCH}: {SWIN_TTA_IMAGES} images in "
        f"{tta_s!r} s = {SWIN_TTA_IMAGES / tta_s!r} img/s ({smi})")

    if trace:
        trace_serving(model, step, augment, source, cfg, smi, SWIN_BATCH,
                      kernel=("K5", ("window_attention",)), tag="-swin")
    return {"launches": launches, **stages[2], "stages": stages}


def check_k6(fa, plain, w0, b, n, heads, dtype, side, timed):
    """K6 through the autograd Function the model calls (K5's log-sum-exp
    entry forward, K6 backward) against autograd of the plain version on the
    same inputs and the same seeded dout; returns K6's record and, when
    timed, the log-sum-exp entry's."""
    q, k, v, bias, mask = window_inputs(w0, b, n, heads, dtype, side,
                                        SEED + 60 + n + heads)
    dout = seeded(q.shape, dtype, SEED + 61 + n + heads)
    shape = f"(W0 {w0}, B {b}, N {n}, H {heads}, d 32) {short(dtype)}"

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        out = fn(*leaves, mask, heads)
        return out, leaves, torch.autograd.grad(out, leaves, dout,
                                                retain_graph=True)

    before = launch_counts(fa, None)
    out, _, got = grads(fa.flash_attention_bias_flat)
    torch.cuda.synchronize()
    after = launch_counts(fa, None)
    launched = {key: after[key] - before[key] for key in after}
    if launched != {key: 0 for key in after} | {"K5_lse": 1, "K6": 1}:
        raise RuntimeError(f"K6 {shape}: under grad the wrapper launched "
                           f"{launched}")
    out_p, leaves_p, want = grads(plain)
    names = ("dq", "dk", "dv", "dbias")
    if dtype == torch.float32:
        errs = [rel_max(g, w) for g, w in zip(got, want)]
        tol, how = K6_TOL_FP32, "of the largest |value|"
    else:
        errs = [rel_rms(g.float().cpu().numpy(), w.float().cpu().numpy())
                for g, w in zip(got, want)]
        tol, how = K6_RTOL_BF16, "RMS error / RMS gradient"
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got[:3], want[:3]))
    log(f"[k6] {shape}, mask {None if mask is None else tuple(mask.shape)}: "
        f"{dict(zip(names, errs))} {how} (tolerance {tol!r}); dq, dk, dv "
        f"max_abs_err {err!r}, max |dbias| {float(want[3].abs().max())!r}")
    ok = all(e <= tol for e in errs) and all(
        bool(torch.isfinite(g).all()) and g.shape == w.shape
        for g, w in zip(got, want))
    if not ok or any(g.dtype != dtype for g in got[:3]) or \
            got[3].dtype != torch.float32:
        raise RuntimeError(f"K6 {shape} disagrees with its plain version")
    rec = {"shape": {"W0": w0, "B": b, "N": n, "H": heads, "d": 32},
           "max_abs_err": err}
    if not timed:
        return rec, None
    rows = w0 * b
    _, lse, o32 = fa.window_attention_lse_cuda(q, k, v, bias, mask, heads)
    rec["ms"] = cuda_ms(lambda: fa.window_attention_bwd_cuda(
        q, k, v, bias, mask, o32, dout, lse, heads), iters=6, warmup=1)
    rec["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
        out_p, leaves_p, dout, retain_graph=True), iters=3, warmup=1)
    # the library yardstick: SDPA with the summed bias and mask as attn_mask,
    # gradients of q, k and v only (the attn_mask gets none)
    views = [t.view(rows, n, heads, 32).transpose(1, 2).detach().requires_grad_()
             for t in (q, k, v)]
    added = bias[None] if mask is None else bias[None] + mask[:, None]
    attn_mask = added.to(dtype)[:, None].expand(
        added.shape[0], rows // added.shape[0], heads, n, n).reshape(
        rows, heads, n, n)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out_s = sdpa(*views, attn_mask=attn_mask, scale=1.0)
    dout_s = dout.view(rows, n, heads, 32).transpose(1, 2)
    rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        out_s, views, dout_s, retain_graph=True), iters=6, warmup=1)
    extra = (bias.numel() + (0 if mask is None else mask.numel())) * 4
    nbytes = (7 * q.numel() * q.element_size() + extra
              + (o32.numel() + lse.numel() + bias.numel()) * 4)
    flops = 10.0 * rows * heads * n * n * 32       # five products
    rec.update(bound(nbytes, flops, dtype))
    log(f"[k6] kernel {rec['ms']!r} ms, plain autograd backward "
        f"{rec['plain_ms']!r} ms, sdpa backward {rec['library_ms']!r} ms (bias "
        f"+ mask as attn_mask, which gets no gradient), bound "
        f"{rec['bound_ms']!r} ms by {rec['bound_by']} ({nbytes} B, "
        f"{flops:.4g} flop)")
    # the forward of the pair, K5's log-sum-exp entry, at the same shape
    fwd = {"shape": rec["shape"],
           "max_abs_err": float((out.float() - out_p.float()).abs().max())}
    fwd["ms"] = cuda_ms(lambda: fa.window_attention_lse_cuda(
        q, k, v, bias, mask, heads), iters=6, warmup=1)
    fwd["plain_ms"] = cuda_ms(lambda: plain(q, k, v, bias, mask, heads),
                              iters=3, warmup=1)
    with torch.no_grad():
        fwd["library_ms"] = cuda_ms(
            lambda: sdpa(*views, attn_mask=attn_mask, scale=1.0), iters=6,
            warmup=1)
    fwd.update(bound(4 * q.numel() * q.element_size() + extra
                     + (lse.numel() + o32.numel()) * 4,
                     4.0 * rows * heads * n * n * 32, dtype))
    log(f"[k5-lse] same shape: kernel {fwd['ms']!r} ms, plain {fwd['plain_ms']!r}"
        f" ms, sdpa {fwd['library_ms']!r} ms, bound {fwd['bound_ms']!r} ms by "
        f"{fwd['bound_by']}; out max_abs_err {fwd['max_abs_err']!r}")
    return rec, fwd


def k6_without_dbias(fa):
    """K5's log-sum-exp entry forward and K6 backward with K6's bias gradient
    replaced by zeros: the control of 8c, in the model's place of
    ``flash_attention_bias_flat``."""

    class WithoutDbias(fa.WindowAttention):
        @staticmethod
        def backward(ctx, dout):
            dq, dk, dv, dbias, _, _ = fa.WindowAttention.backward(ctx, dout)
            return dq, dk, dv, torch.zeros_like(dbias), None, None

    return WithoutDbias.apply


def swin_train_phase(fa, ln, smi, trace):
    """Phase 8; returns (K6's record, the log-sum-exp entry's, K4's at the
    SwinV2-L widths, the launch counts of the timed steps)."""
    from fedvit_torch.ops.attention import windowed_attention_flat as plain
    from fedvit_torch.ops.layer_norm import LayerNorm

    # 8a. K6 against its plain version; K4 at SwinV2-L's widths
    for w0, b, n, heads in ((4, 3, 49, 2), (9, 2, 16, 3)):
        check_k6(fa, plain, w0, b, n, heads, torch.float32,
                 math.isqrt(n) * math.isqrt(w0), timed=False)
    check_k6(fa, plain, 1, 5, 144, 2, torch.float32, None, timed=False)
    stages = [check_k6(fa, plain, w0, b, n, heads, torch.bfloat16, side, True)
              for w0, b, n, heads, side, _ in SWIN_TRAIN_STAGES]
    torch.cuda.empty_cache()
    for name, i in (("K5's log-sum-exp entry", 1), ("K6", 0)):
        per_micro = sum(r[i]["ms"] * st[5]
                        for r, st in zip(stages, SWIN_TRAIN_STAGES))
        log(f"[k6] a SwinV2-L@384 micro-batch of {SWIN_MICRO} launches {name} "
            f"{[st[5] for st in SWIN_TRAIN_STAGES]} times: {per_micro!r} ms")
    k6 = {**stages[2][0], "stages": [r[0] for r in stages]}
    k5_lse = {**stages[2][1], "stages": [r[1] for r in stages]}
    tokens = (SWIN_SIZE // 4) ** 2
    k4 = [check_k4(ln, (SWIN_MICRO, tokens // 4 ** s, 192 * 2 ** s),
                   torch.bfloat16, True) for s in (0, 1, 3)]
    check_k4(ln, (SWIN_MICRO, tokens // 4 ** 3, 1536), torch.float32, False)

    # 8b. the step at macro batch 16
    cfg, model, state, step, batches = training_setup(
        SWIN, SWIN_SIZE, SWIN_MICRO, SWIN_ACCUM, SWIN_DROP_PATH, SWIN_LLRD)
    blocks = sum(SWIN_DEPTHS)
    norms = sum(isinstance(m, LayerNorm) for m in model.modules())
    log(f"[swin-train] {SWIN}: {blocks} blocks, {norms} LayerNorms")
    if norms != 1 + 2 * blocks + (len(SWIN_DEPTHS) - 1) + 1:
        raise RuntimeError(f"{norms} LayerNorms: want the patch norm, two a "
                           f"block, one a merging and the final norm")
    state = warm_up_step("swin-train", cfg, model, state, step, batches[0])

    # 8c. one macro batch's gradients, kernels against the plain path, before
    # the timed steps (see SWIN_GRAD_RTOL_BF16)
    def plain_fp32(q, k, v, bias, mask, heads):
        return plain(q.float(), k.float(), v.float(), bias, mask, heads).to(q.dtype)

    got = grads_by_path(model, state, step, batches[1], {
        "kernel": (), "again": (),
        "plain": (window_attention_replaced_by(plain),
                  layer_norm_backward_replaced_by(ln.ln_bwd_plain)),
        "fp32": (window_attention_replaced_by(plain_fp32),
                 layer_norm_backward_replaced_by(ln.ln_bwd_plain)),
        "control": (window_attention_replaced_by(k6_without_dbias(fa)),)})
    differ = [n for n, g in got["kernel"][0].items()
              if not torch.equal(g, got["again"][0][n])]
    log(f"[swin-train] the kernel path run twice from the same state: "
        f"{len(differ)} of {len(got['kernel'][0])} leaves differ in their "
        f"bits, by kind {group_max({n: 1.0 for n in differ})}")
    for grads, _ in got.values():      # the q, k and v rows of each qkv weight
        for n in [n for n in grads if n.endswith("attn.qkv.weight")]:
            for part, rows in zip("qkv", grads[n].chunk(3, dim=0)):
                grads[f"{n}[{part}]"] = rows
    compare_grads("swin-train", got, SWIN_GRAD_RTOL_BF16,
                  [n for n in got["plain"][0] if ".cpb_mlp." in n],
                  "K6's dbias zeroed (the cpb_mlp leaves)",
                  report=("cpb_mlp.0.weight", "cpb_mlp.0.bias",
                          "cpb_mlp.2.weight", "logit_scale", "q_bias", "v_bias",
                          "qkv.weight[q]", "qkv.weight[k]", "qkv.weight[v]",
                          "downsample.reduction.weight"))
    del got

    # 8b, the timed steps
    micro_batches = TIMED_STEPS * SWIN_ACCUM
    want = {k: 0 for k in counted(fa, ln)} | {
        "K5_lse": micro_batches * blocks, "K6": micro_batches * blocks,
        "K4": micro_batches * norms}
    state, counts = timed_steps("swin-train", "SwinV2-L@384 bf16 4ch+meta", fa,
                                ln, state, step, batches[1:], want, smi)
    if trace:
        trace_training("profile-swin-train", step, state, batches[2], smi, {
            "K5 log-sum-exp entry": ("window_attention_fwd_kernel",),
            "K6": ("delta_kernel", "dkdv_kernel", "dq_dbias_kernel",
                   "group_sum_kernel"),
            "K4": K4_NAMES})
    return k6, k5_lse, k4, counts


# ---------------------------------------------------------------------------
# 9. The train augment (K7, K8) and the fold trainer
# ---------------------------------------------------------------------------

def shift_inputs(shape, axis, seed):
    """An image and the shift field of a rotation by up to 30° along
    ``axis`` (2: each row along W, 1: each column along H), with ties and
    shifts past the image's extent in its first row."""
    b, h, w, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand(shape, device="cuda", generator=g)
    extent, n = (w, h) if axis == 2 else (h, w)
    theta = (torch.rand(b, 1, device="cuda", generator=g) - 0.5) * math.radians(60)
    coord = torch.arange(n, device="cuda") - (n - 1) / 2.0
    shift = (-torch.tan(theta / 2) if axis == 2 else torch.sin(theta)) * coord
    shift[0, :6] = torch.tensor([0.5, -0.5, 1.5, -2.5, extent + 0.5,
                                 -extent - 0.5], device="cuda")
    return img, shift, extent


def check_k7(rs, shape, axis, seed, timed):
    """K7 through the wrapper the augment calls against its plain version:
    bit for bit; returns its record."""
    img, shift, extent = shift_inputs(shape, axis, seed)
    kernel = rs.row_shift if axis == 2 else rs.col_shift
    plain = rs.row_shift_plain if axis == 2 else rs.col_shift_plain
    got = kernel(img, shift)
    torch.cuda.synchronize()
    want = plain(img, shift)
    err = float((got - want).abs().max())
    kind = "rows" if axis == 2 else "columns"
    log(f"[k7] {kind} {tuple(shape)}: bit-equal to the plain version "
        f"{torch.equal(got, want)}, max_abs_err {err!r}")
    if not torch.equal(got, want):
        raise RuntimeError(f"K7 {kind} {tuple(shape)} disagrees with its plain version")
    rec = {"shape": list(shape), "axis": kind, "max_abs_err": err}
    if timed:
        s = rs._shift_amount(shift, extent)
        src = (torch.arange(extent, device="cuda").view(
            (1, 1, extent) if axis == 2 else (1, extent, 1))
            + (s.view(shape[0], shape[1], 1) if axis == 2
               else s.view(shape[0], 1, shape[2])))
        # one int64 index per pixel, broadcast over the channels with stride
        # 0: the least index torch.gather takes
        idx = src.clamp(0, extent - 1).unsqueeze(-1).expand(shape)
        rec["ms"] = cuda_ms(lambda: rs.shift_cuda(img, s, axis))
        rec["plain_ms"] = cuda_ms(lambda: plain(img, shift), iters=5, warmup=1)
        rec["library_ms"] = cuda_ms(lambda: torch.gather(img, axis, idx))
        nbytes = 2 * img.numel() * 4 + s.numel() * 4
        lib_bytes = 2 * img.numel() * 4 + src.numel() * 8
        rec.update(bound(nbytes, 0.0, torch.float32))
        log(f"[k7] kernel {rec['ms']!r} ms ({nbytes} B, "
            f"{nbytes / rec['ms'] / 1e9!r} TB/s), plain {rec['plain_ms']!r} ms, "
            f"torch.gather (clamped int64 index per pixel, no zero fill) "
            f"{rec['library_ms']!r} ms ({lib_bytes} B, "
            f"{lib_bytes / rec['library_ms'] / 1e9!r} TB/s), bound "
            f"{rec['bound_ms']!r} ms by {rec['bound_by']}")
    return rec


def check_k8(ra, shape, seed, timed):
    """K8 through ``equalize`` against ``equalize_plain``: bit for bit, with
    one constant channel (step 0, passed through) and one of a single value
    but for six pixels."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand(shape, device="cuda", generator=g)
    img[0, ..., 0] = 0.5
    img[-1, ..., 1] = 0.25
    img[-1, :2, :3, 1] = 0.9
    got = ra.equalize(img)
    torch.cuda.synchronize()
    want = ra.equalize_plain(img)
    err = float((got - want).abs().max())
    passed = torch.equal(got[0, ..., 0], img[0, ..., 0])
    log(f"[k8] {tuple(shape)}: bit-equal to the plain version "
        f"{torch.equal(got, want)}, max_abs_err {err!r}; constant channel "
        f"passed through: {passed}")
    if not (torch.equal(got, want) and passed):
        raise RuntimeError(f"K8 {tuple(shape)} disagrees with its plain version")
    rec = {"shape": list(shape), "max_abs_err": err}
    if timed:
        rec["ms"] = cuda_ms(lambda: ra.equalize_cuda(img))
        rec["plain_ms"] = cuda_ms(lambda: ra.equalize_plain(img), iters=5,
                                  warmup=1)
        rec["library_ms"] = None        # no one PyTorch call computes it
        nbytes = 2 * img.numel() * 4
        rec.update(bound(nbytes, 0.0, torch.float32))
        log(f"[k8] kernel {rec['ms']!r} ms ({shape[0] * shape[3]} blocks), "
            f"plain {rec['plain_ms']!r} ms, bound {rec['bound_ms']!r} ms by "
            f"{rec['bound_by']} ({nbytes} B)")
    return rec


def augment_kernels_replaced_by_plain(rs, ra):
    """Run the augment's shifts and equalize through their plain versions."""
    stack = contextlib.ExitStack()
    stack.enter_context(rebound(rs, "row_shift", rs.row_shift_plain))
    stack.enter_context(rebound(rs, "col_shift", rs.col_shift_plain))
    stack.enter_context(rebound(ra, "equalize", ra.equalize_plain))
    return stack


def augment_phase(rs, ra, smi):
    """9c: the train augment at ViT-B@224 and SwinV2-L@384 macro batches."""
    from fedvit_torch.core.config import Config, DataConfig, ModelConfig
    from fedvit_torch.data.pipeline import make_device_augment
    from fedvit_torch.eval.serve import _to_device
    from fedvit_torch.ops import image as I

    records = {}
    for name, backbone, macro, canvas, size in AUG_CASES:
        cfg = Config(data=DataConfig(use_segmentation_mask=True),
                     model=ModelConfig(backbone=backbone, image_size=size))
        augment = make_device_augment(cfg, train=True)
        batch = _to_device(serving_inputs(macro, canvas, SEED + 90).gather(
            np.arange(macro)), torch.device("cuda"))
        g = torch.Generator(device="cuda").manual_seed(SEED + 9)
        start = g.get_state()
        augment(batch, g)                                      # warm-up
        torch.cuda.synchronize()
        g.set_state(start)
        before = (rs.shift_cuda.launches, ra.equalize_cuda.launches)
        out = augment(batch, g)["image"]
        torch.cuda.synchronize()
        launched = (rs.shift_cuda.launches - before[0],
                    ra.equalize_cuda.launches - before[1])
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            augment(batch, g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        g.set_state(start)
        with augment_kernels_replaced_by_plain(rs, ra):
            t0 = time.perf_counter()
            plain = augment(batch, g)["image"]
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        g.set_state(start)
        aug = cfg.augmentation.train
        cj = aug.color_jitter
        draws = I.draw_train(g, macro, canvas, canvas,
                             aug.random_resized_crop.scale,
                             aug.random_resized_crop.ratio, aug.horizontal_flip,
                             aug.vertical_flip, aug.rotation,
                             (cj.brightness, cj.contrast, cj.saturation, cj.hue),
                             aug.randaugment.n)
        ops = sorted(set(torch.cat([op for op, _ in draws.randaugment]).tolist()))
        mask = sorted(out[..., 3].unique().tolist())
        ms = float(np.median(times))
        log(f"[augment-{name}] ({macro}, {canvas}, {canvas}, 4) uint8 → "
            f"{tuple(out.shape)}: {ms!r} ms a call synchronised (median of 5, "
            f"{times}), through the plain shifts and equalize {plain_ms!r} ms "
            f"({smi}); launches a call K7 {launched[0]}, K8 {launched[1]} (want "
            f"12, 3); bit-equal to the plain path {torch.equal(out, plain)}; "
            f"RandAugment ops chosen {ops}; mask values {mask}")
        if launched != (12, 3) or not torch.equal(out, plain):
            raise RuntimeError(f"the {name} train augment did not launch K7 and "
                               f"K8 as it should or disagrees with the plain path")
        if out.shape != (macro, size, size, 4) or not bool(torch.isfinite(out).all()) \
                or not set(mask) <= {-1.0, 1.0}:
            raise RuntimeError(f"the {name} train augment's output is wrong")
        records[name] = {"ms": ms, "plain_ms": plain_ms, "ops": ops}
    if records["vit"]["ops"] != list(range(14)):
        raise RuntimeError("a RandAugment op was chosen by no sample of 384")
    return records


def fold_config(epochs):
    from fedvit_torch.core.config import (AugmentationConfig, Config,
                                          DataConfig, EMAConfig, LLRDConfig,
                                          LossConfig, ModelConfig,
                                          OptimizerConfig, SchedulerConfig,
                                          TrainingConfig)
    return Config(
        data=DataConfig(use_segmentation_mask=True),
        model=ModelConfig(backbone="vit_base_patch16_224", image_size=224,
                          compute_dtype="bfloat16", drop_path_rate=0.1),
        training=TrainingConfig(
            epochs=epochs, batch_size=MICRO, gradient_accumulation_steps=ACCUM,
            optimizer=OptimizerConfig(lr=1e-4),
            scheduler=SchedulerConfig(warmup_epochs=0),
            llrd=LLRDConfig(decay_rate=0.75, head_lr_mult=10.0),
            grad_clip=1.0, ema=EMAConfig(decay=0.9995)),
        augmentation=AugmentationConfig(),      # the default train recipe
        loss=LossConfig(type="asymmetric"))


def expect_restored(path, state) -> None:
    """Every tensor of ``state`` equals the checkpoint's at ``path``."""
    saved = torch.load(Path(path) / "state.pt", map_location="cuda",
                       weights_only=True)
    pairs = [(saved["model"], state.model.state_dict()), (saved["ema"], state.ema),
             (saved["opt_state"]["mu"], state.opt_state["mu"]),
             (saved["opt_state"]["nu"], state.opt_state["nu"])]
    differ = [k for a, b in pairs for k in a if not torch.equal(a[k], b[k])]
    same = (not differ and saved["step"] == state.step
            and torch.equal(saved["generator"].cpu(), state.generator.get_state())
            and saved["np_rng"] == state.np_rng.bit_generator.state)
    log(f"[fold] restored from {Path(path).name}: {sum(len(a) for a, _ in pairs)} "
        f"tensors, step {state.step}, both generators; bit-equal: {same} "
        f"{differ[:3]}")
    if not same:
        raise RuntimeError("the checkpoint did not restore the state bit for bit")


def fold_phase(fa, ln, rs, ra, smi, trace):
    """9d: train_fold on ViT-B/16@224 with the train augment — 2 epochs,
    resumed into a third, tested with TTA — then the batch-size probe."""
    import dataclasses
    import shutil

    from fedvit_torch.data.pipeline import canvas_size
    from fedvit_torch.train import checkpoint, loop
    from fedvit_torch.train.probe import auto_batch_size

    cfg = fold_config(epochs=2)
    canvas = canvas_size(cfg.model.image_size)
    train, val, test = (serving_inputs(n, canvas, SEED + 91 + i)
                        for i, n in enumerate(FOLD_IMAGES))
    fns = counted(fa, ln) | {"K7": rs.shift_cuda, "K8": ra.equalize_cuda}
    macro = MICRO * ACCUM
    epochs, evals, saves = [], [], []

    def timed_epoch(step, state, source, macro_bs, *args):
        torch.cuda.synchronize()
        before = {k: fn.launches for k, fn in fns.items()}
        t0 = time.perf_counter()
        state, loss = train_epoch(step, state, source, macro_bs, *args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = len(source) // macro_bs
        per_step = {k: (fn.launches - before[k]) / steps for k, fn in fns.items()}
        epochs.append({"s": dt, "img_s": steps * macro_bs / dt,
                       "per_step": per_step})
        return state, loss

    def timed_evaluate(step, source, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(step, source, *args, **kwargs)
        torch.cuda.synchronize()
        evals.append(len(source) / (time.perf_counter() - t0))
        return out

    def timed_save(path, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(path, *args, **kwargs)
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        saves.append((time.perf_counter() - t0, nbytes))

    def checked_load(path, state):
        meta = load(path, state)
        expect_restored(path, state)
        return meta

    train_epoch, evaluate = loop._train_epoch, loop._evaluate
    save, load = checkpoint.save_checkpoint, checkpoint.load_checkpoint
    lines = []
    want = {k: 0.0 for k in fns} | {"K7": 12.0, "K8": 3.0, "K2": ACCUM * BLOCKS,
                                      "K3": ACCUM * BLOCKS, "K4": ACCUM * NORMS}
    try:
        with contextlib.ExitStack() as stack:
            for module, name, fn in ((loop, "_train_epoch", timed_epoch),
                                     (loop, "_evaluate", timed_evaluate),
                                     (checkpoint, "save_checkpoint", timed_save),
                                     (checkpoint, "load_checkpoint", checked_load)):
                stack.enter_context(rebound(module, name, fn))
            torch.cuda.reset_peak_memory_stats()
            for fn in fns.values():
                fn.launches = 0
            t0 = time.perf_counter()
            first = loop.train_fold(cfg, 0, train, val, test,
                                    workdir=str(FOLD_WORKDIR), log=lines.append)
            fold_s = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in fns.items()}
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            resumed = []
            t0 = time.perf_counter()
            second = loop.train_fold(
                cfg.replace(training=dataclasses.replace(cfg.training, epochs=3)),
                0, train, val, test, workdir=str(FOLD_WORKDIR),
                log=resumed.append, resume=True)
            resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(FOLD_WORKDIR, ignore_errors=True)
    for line in lines + resumed:
        if line.startswith("  E") or "Resumed" in line or "best" in line \
                or "Test" in line:
            log(f"[fold] {line.strip()}")
    epoch_lines = [ln_[:5] for ln_ in resumed if ln_.startswith("  E0")]
    log(f"[fold] launches in the first run (2 epochs of "
        f"{FOLD_IMAGES[0] // macro} steps, validation, TTA test): {counts}")
    for i, e in enumerate(epochs):
        log(f"[fold] epoch {i + 1}: {e['s']!r} s = {e['img_s']!r} train img/s "
            f"synchronised (gather, augment and step, macro batch {macro}); "
            f"launches a step {e['per_step']}")
    steady = epochs[1:]
    log(f"[fold] fold rate over epochs 2 and 3 (the first warms up): "
        f"{sum(FOLD_IMAGES[0] for _ in steady) / sum(e['s'] for e in steady)!r} "
        f"train img/s ({smi})")
    log(f"[fold] validation {[round(v, 2) for v in evals]} img/s; checkpoint "
        f"writes {[(round(t, 3), b) for t, b in saves]} (s, bytes); peak "
        f"{peak_gb!r} GiB; first run {fold_s!r} s, resumed run {resume_s!r} s "
        f"({smi})")
    for name, res in (("first", first), ("resumed", second)):
        log(f"[fold] {name} run's test (8-view TTA): logits {res.logits.shape}, "
            f"finite {bool(np.isfinite(res.logits).all())}, metrics "
            f"{ {k: round(float(v), 4) for k, v in res.metrics.items() if k != 'confusion_matrix' and np.ndim(v) == 0} }")
        if res.logits.shape != (FOLD_IMAGES[2], 8) or \
                not np.isfinite(res.logits).all() or \
                not {"accuracy", "balanced_accuracy", "macro_f1", "auroc",
                     "confusion_matrix"} <= set(res.metrics):
            raise RuntimeError(f"the {name} fold's test result is wrong")
    if not any("Resumed from epoch 2" in x for x in resumed) or \
            epoch_lines != ["  E03"]:
        raise RuntimeError(f"the resumed fold did not run epoch 3 alone: "
                           f"{epoch_lines}")
    if len(epochs) != 3 or any(e["per_step"] != want for e in epochs):
        raise RuntimeError(f"a fold step did not launch the kernels as it "
                           f"should: want {want} a step")
    if counts["K7"] == 0 or counts["K8"] == 0:
        raise RuntimeError("the fold launched no K7 or K8")

    t0 = time.perf_counter()
    probed = auto_batch_size(cfg, log=lambda s: None)
    log(f"[fold] auto_batch_size at its defaults (8 to 64 by 2): {probed} in "
        f"{time.perf_counter() - t0!r} s")
    if trace:
        trace_fold_step(cfg, train, rs, ra, smi)
    return counts, {"epochs": epochs, "val_img_s": evals, "saves": saves,
                    "peak_gib": peak_gb}


def trace_fold_step(cfg, train, rs, ra, smi) -> None:
    """One fold step, augment included: the augment's and the step's
    synchronised times, then a profile of both by kernel."""
    from fedvit_torch.data.pipeline import DeviceDataSource, make_device_augment
    from fedvit_torch.train.loop import init_model_state
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.step import make_train_step

    _, state = init_model_state(cfg, SEED, device="cuda", steps_per_epoch=2)
    step = make_train_step(cfg, build_loss(cfg))
    augment = make_device_augment(cfg, train=True)
    batch = DeviceDataSource(train, "cuda").gather(np.arange(MICRO * ACCUM))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    stages = {"augment": [], "step": []}
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aug = augment(batch, g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = step(state, aug)
        torch.cuda.synchronize()
        if i:                                          # the first warms up
            stages["augment"].append((t1 - t0) * 1e3)
            stages["step"].append((time.perf_counter() - t1) * 1e3)
    a, s = (float(np.median(v)) for v in stages.values())
    log(f"[stages-fold] median of 3 ({smi}): augment {a!r} ms, step {s!r} ms; "
        f"the augment is {100 * a / (a + s):.1f}% of a fold step")
    trace_training("profile-fold", lambda st, b: step(st, augment(b, g)), state,
                   batch, smi, {
                       "K7": ("shift_kernel",), "K8": ("equalize_kernel",),
                       "K2": K2_NAMES, "K3": K3_NAMES, "K4": K4_NAMES})


def train_augment_phase(fa, ln, smi, trace):
    """Phase 9; returns the records of K7 and K8 with the fold's launches."""
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs

    # 9a. K7: small cases (ragged W, C of 1, 3, 4, ties, shifts past the
    # extent, H ≠ W), then the four shapes of the two configurations
    for c in (1, 3, 4):
        for axis in (2, 1):
            check_k7(rs, (3, 14, 19, c), axis, SEED + c, timed=False)
    k7 = []
    for _, _, macro, _, size in AUG_CASES:
        rot, chain = shift_shapes(macro, size)
        for shape in (rot, chain):
            for axis in (2, 1):
                k7.append(check_k7(rs, shape, axis, SEED + shape[1], timed=True))
    per_call = [2 * k7[i]["ms"] + k7[i + 1]["ms"] + 6 * k7[i + 2]["ms"]
                + 3 * k7[i + 3]["ms"] for i in (0, 4)]
    log(f"[k7] a train augment call (the rotation's 2 row and 1 column shifts, "
        f"RandAugment's 6 and 3): ViT-B {per_call[0]!r} ms, SwinV2-L "
        f"{per_call[1]!r} ms of K7")
    # 9b. K8
    check_k8(ra, (2, 24, 20, 3), SEED, timed=False)
    k8 = [check_k8(ra, (macro, size, size, 3), SEED + size, timed=True)
          for _, _, macro, _, size in AUG_CASES]
    torch.cuda.empty_cache()
    # 9c, 9d
    augmented = augment_phase(rs, ra, smi)
    torch.cuda.empty_cache()
    counts, fold = fold_phase(fa, ln, rs, ra, smi, trace)
    return ({"launches": counts["K7"], **k7[0], "shapes": k7},
            {"launches": counts["K8"], **k8[0], "shapes": k8},
            augmented, fold)


# ---------------------------------------------------------------------------
# 10. ViT-B/16@224 with attention_impl packed (K10) and mega (K11)
# ---------------------------------------------------------------------------

def check_k10(fa, b, n, heads, d, dtype, entries, timed):
    """K10's ``entries`` (of "fwd", "lse", "bwd") through their wrappers
    against the plain version on the same seeded inputs; returns a record per
    entry, timed when ``timed``."""
    from fedvit_torch.ops.attention import attention_from_qkv as plain

    e = heads * d
    qkv = seeded((b, n, 3 * e), dtype, SEED + 40 + n + d)
    dout = seeded((b, n, e), dtype, SEED + 41 + n + d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4.0 * b * heads * n * n * d
    tag = f"[k10] qkv {tuple(qkv.shape)} {short(dtype)} heads {heads} (d {d})"
    atol = K1_ATOL_FP32 if dtype == torch.float32 else K1_ATOL_BF16
    recs = {}
    if "fwd" in entries:
        out = fa.flash_attention_qkv(qkv, heads)
        torch.cuda.synchronize()
        err = float((out.float() - plain(qkv, heads).float()).abs().max())
        log(f"{tag}: forward max_abs_err {err!r} (tolerance {atol!r})")
        if not (err <= atol and bool(torch.isfinite(out).all())):
            raise RuntimeError("K10 disagrees with its plain version")
        rec = recs["fwd"] = {"max_abs_err": err}
        if timed:
            rec["ms"] = cuda_ms(lambda: fa.flash_attention_qkv(qkv, heads))
            rec["plain_ms"] = cuda_ms(lambda: plain(qkv, heads))
            rec["library_ms"] = cuda_ms(lambda: sdpa(*qkv_views(qkv, heads)))
            nbytes = (qkv.numel() + out.numel()) * qkv.element_size()
            rec.update(bound(nbytes, flops, dtype))
    if "lse" in entries:
        out, lse = fa.qkv_attention_lse_cuda(qkv, heads)
        torch.cuda.synchronize()
        q, k, _ = (t.float() for t in qkv_views(qkv, heads))
        want_lse = torch.logsumexp(q @ k.transpose(-1, -2) / math.sqrt(d), -1)
        same = torch.equal(out, fa.qkv_attention_cuda(qkv, heads))
        err = float((out.float() - plain(qkv, heads).float()).abs().max())
        lse_err = float((lse - want_lse).abs().max())
        log(f"{tag}: log-sum-exp entry max_abs_err {err!r}, bit-identical to "
            f"the forward: {same}; lse max_abs_err {lse_err!r} (tolerance "
            f"{K2_LSE_ATOL!r})")
        if not (same and err <= atol and lse_err <= K2_LSE_ATOL):
            raise RuntimeError("K10's log-sum-exp entry disagrees")
        rec = recs["lse"] = {"max_abs_err": err}
        if timed:
            rec["ms"] = cuda_ms(lambda: fa.qkv_attention_lse_cuda(qkv, heads))
            rec["plain_ms"] = cuda_ms(lambda: plain(qkv, heads))
            rec["library_ms"] = cuda_ms(lambda: sdpa(*qkv_views(qkv, heads)))
            nbytes = (qkv.numel() + out.numel()) * qkv.element_size() + lse.numel() * 4
            rec.update(bound(nbytes, flops, dtype))
    if "bwd" in entries:
        qkv_g = qkv.clone().requires_grad_()
        (dqkv,) = torch.autograd.grad(fa.flash_attention_qkv(qkv_g, heads),
                                      qkv_g, dout)
        torch.cuda.synchronize()
        qkv_p = qkv.clone().requires_grad_()
        out_p = plain(qkv_p, heads)
        (want,) = torch.autograd.grad(out_p, qkv_p, dout, retain_graph=True)
        err = float((dqkv.float() - want.float()).abs().max())
        rel = rel_max(dqkv, want)
        log(f"{tag}: backward dqkv max_abs_err {err!r}, {rel!r} of max |dqkv| "
            f"(tolerance {K3_TOL[dtype]!r})")
        if not (rel <= K3_TOL[dtype] and bool(torch.isfinite(dqkv).all())
                and dqkv.dtype == dtype):
            raise RuntimeError("K10's backward disagrees with its plain version")
        rec = recs["bwd"] = {"max_abs_err": err}
        if timed:
            o, lse = fa.qkv_attention_lse_cuda(qkv, heads)
            rec["ms"] = cuda_ms(
                lambda: fa.qkv_attention_bwd_cuda(qkv, o, dout, lse, heads))
            rec["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_p, qkv_p, dout, retain_graph=True))
            qkv_s = qkv.clone().requires_grad_()
            out_s = sdpa(*qkv_views(qkv_s, heads))
            dout_s = dout.view(b, n, heads, d).transpose(1, 2)
            rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_s, qkv_s, dout_s, retain_graph=True))
            nbytes = ((2 * qkv.numel() + 2 * o.numel()) * qkv.element_size()
                      + lse.numel() * 4)
            rec.update(bound(nbytes, 2.5 * flops, dtype))
    for name, rec in recs.items():
        if "ms" in rec:
            log(f"{tag}: {name} kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r}"
                f" ms, sdpa {rec['library_ms']!r} ms, bound {rec['bound_ms']!r} "
                f"ms by {rec['bound_by']}")
    return recs


def x_inputs(b, n, dim, e, dtype, seed):
    """x of unit entries, W (D, 3E) of N(0, 1/D), so that qkv is of unit size,
    and a bias of 0.5, all in ``dtype``."""
    return (seeded((b, n, dim), dtype, seed),
            seeded((dim, 3 * e), dtype, seed + 1, 1.0 / math.sqrt(dim)),
            seeded((3 * e,), dtype, seed + 2, 0.5))


def linear_sdpa(x, w, bias, heads):
    """K11's library yardstick: ``F.linear`` then SDPA on the q/k/v views."""
    qkv = torch.nn.functional.linear(x, w.t(), bias)
    b, n, _ = x.shape
    out = torch.nn.functional.scaled_dot_product_attention(*qkv_views(qkv, heads))
    return out.transpose(1, 2).reshape(b, n, -1)


def check_k11(fa, b, n, dim, heads, d, dtype, entries, timed):
    """K11's ``entries`` (of "fwd", "lse", "bwd") through their wrappers
    against the plain version on the same seeded inputs; the backward's dx,
    dW and db each against autograd of the plain version (dW there is the
    fp32 product xᵀ·dqkv, rounded once), and run twice for the same bits.
    Returns a record per entry, timed when ``timed``."""
    from fedvit_torch.ops.attention import attention_from_x as plain

    e = heads * d
    x, w, bias = x_inputs(b, n, dim, e, dtype, SEED + 50 + n + d)
    dout = seeded((b, n, e), dtype, SEED + 53 + n + d)
    proj = 2.0 * b * n * dim * 3 * e
    attn = 4.0 * b * heads * n * n * d
    io = (x.numel() + w.numel() + bias.numel() + b * n * e) * x.element_size()
    tag = (f"[k11] x {tuple(x.shape)} w {tuple(w.shape)} {short(dtype)} heads "
           f"{heads} (d {d})")
    atol = K11_ATOL[dtype]
    recs = {}
    if "fwd" in entries:
        out = fa.flash_attention_xqkv(x, w, bias, heads)
        torch.cuda.synchronize()
        err = float((out.float() - plain(x, w, bias, heads).float()).abs().max())
        log(f"{tag}: forward max_abs_err {err!r} (tolerance {atol!r})")
        if not (err <= atol and bool(torch.isfinite(out).all())):
            raise RuntimeError("K11 disagrees with its plain version")
        rec = recs["fwd"] = {"max_abs_err": err}
        if timed:
            rec["ms"] = cuda_ms(lambda: fa.flash_attention_xqkv(x, w, bias, heads))
            rec["plain_ms"] = cuda_ms(lambda: plain(x, w, bias, heads))
            rec["library_ms"] = cuda_ms(lambda: linear_sdpa(x, w, bias, heads))
            rec.update(bound(io, proj + attn, dtype))
    if "lse" in entries:
        out, lse = fa.xqkv_attention_lse_cuda(x, w, bias, heads)
        torch.cuda.synchronize()
        same = torch.equal(out, fa.xqkv_attention_cuda(x, w, bias, heads))
        err = float((out.float() - plain(x, w, bias, heads).float()).abs().max())
        log(f"{tag}: log-sum-exp entry max_abs_err {err!r}, bit-identical to "
            f"the forward: {same}, lse finite {bool(torch.isfinite(lse).all())}")
        if not (same and err <= atol and bool(torch.isfinite(lse).all())):
            raise RuntimeError("K11's log-sum-exp entry disagrees")
        rec = recs["lse"] = {"max_abs_err": err}
        if timed:
            rec["ms"] = cuda_ms(lambda: fa.xqkv_attention_lse_cuda(x, w, bias, heads))
            rec["plain_ms"] = cuda_ms(lambda: plain(x, w, bias, heads))
            rec["library_ms"] = cuda_ms(lambda: linear_sdpa(x, w, bias, heads))
            rec.update(bound(io + lse.numel() * 4, proj + attn, dtype))
    if "bwd" in entries:
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        got = torch.autograd.grad(fa.flash_attention_xqkv(*leaves, heads), leaves,
                                  dout)
        torch.cuda.synchronize()
        plain_leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        out_p = plain(*plain_leaves, heads)
        want = torch.autograd.grad(out_p, plain_leaves, dout, retain_graph=True)
        rels = [rel_max(g, wt) for g, wt in zip(got, want)]
        o, lse = fa.xqkv_attention_lse_cuda(x, w, bias, heads)
        again = [fa.xqkv_attention_bwd_cuda(x, w, bias, o, dout, lse, heads)
                 for _ in range(2)]
        same = all(torch.equal(a, b_) for a, b_ in zip(*again))
        err = float((got[0].float() - want[0].float()).abs().max())
        log(f"{tag}: backward as shares of the largest |value|: dx {rels[0]!r}, "
            f"dW {rels[1]!r} (against the plain fp32 product), db {rels[2]!r} "
            f"(tolerance {K11_TOL[dtype]!r}); dx max_abs_err {err!r}; the "
            f"backward twice gives the same bits: {same}")
        if not (max(rels) <= K11_TOL[dtype] and same
                and all(bool(torch.isfinite(g).all()) and g.dtype == dtype
                        for g in got)):
            raise RuntimeError("K11's backward disagrees with its plain version")
        rec = recs["bwd"] = {"max_abs_err": err, "dw_rel_err": rels[1],
                             "db_rel_err": rels[2]}
        if timed:
            rec["ms"] = cuda_ms(
                lambda: fa.xqkv_attention_bwd_cuda(x, w, bias, o, dout, lse, heads))
            rec["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_p, plain_leaves, dout, retain_graph=True))
            lib_leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
            out_l = linear_sdpa(*lib_leaves, heads)
            rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_l, lib_leaves, dout, retain_graph=True))
            # x, w, b, out and dout read; dx, dw and db written
            nbytes = 2 * io + lse.numel() * 4
            rec.update(bound(nbytes, 3 * proj + 2.5 * attn, dtype))
    for name, rec in recs.items():
        if "ms" in rec:
            log(f"{tag}: {name} kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r}"
                f" ms, F.linear + sdpa {rec['library_ms']!r} ms, bound "
                f"{rec['bound_ms']!r} ms by {rec['bound_by']}")
    return recs


IMPL_KERNELS = {"packed": ("K10", "flash_attention_qkv"),
                "mega": ("K11", "flash_attention_xqkv")}
# the groups of each impl's --trace profiles: serving, then a training step
IMPL_TRACE = {
    "packed": (("K10", K10_NAMES),
               {"K10 log-sum-exp entry": K10_LSE_NAMES,
                "K10 backward": K10_BWD_NAMES, "K4": K4_NAMES}),
    "mega": (("K11", K11_GEMM_NAMES + K10_NAMES),
             {"K11 products (gemm.cuh)": K11_GEMM_NAMES,
              "K11 attention, log-sum-exp entry": K10_LSE_NAMES,
              "K11 attention backward and db": K11_BWD_NAMES,
              "K4": K4_NAMES})}


def impl_replaced_by(impl, fn):
    """Run the ViT's ``impl`` attention through ``fn`` instead of its kernel."""
    from fedvit_torch.models import layers
    return rebound(layers, IMPL_KERNELS[impl][1], fn)


@contextlib.contextmanager
def qkv_bias_zeroed(model):
    """Every ``attn.qkv`` Dense of the model without its bias inside the
    block: the control of ``packed``'s logits check."""
    biases = [m.qkv.bias for m in model.modules() if hasattr(m, "qkv")]
    saved = [b.detach().clone() for b in biases]
    with torch.no_grad():
        for b in biases:
            b.zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(biases, saved):
                b.copy_(v)


def plain_attention(impl, fp32=False):
    """``impl``'s plain attention in the model's place; with ``fp32``
    computed in fp32 and cast back (the rounding-noise reference of 10c)."""
    from fedvit_torch.ops.attention import attention_from_qkv, attention_from_x

    if impl == "packed":
        if fp32:
            return lambda qkv, h: attention_from_qkv(qkv.float(), h).to(qkv.dtype)
        return attention_from_qkv
    if fp32:
        return lambda x, w, b, h: attention_from_x(
            x.float(), w.float(), b.float(), h).to(x.dtype)
    return attention_from_x


def logits_control(impl, model):
    """The control of 10b's logits check, as context managers: for
    ``packed`` the qkv Dense without its bias, for ``mega`` the plain K11
    with its bias zeroed."""
    plain = plain_attention(impl)
    if impl == "packed":
        return [qkv_bias_zeroed(model), impl_replaced_by(impl, plain)]
    return [impl_replaced_by(impl, lambda x, w, b, h: plain(x, w, b * 0, h))]


def impl_serving(fa, impl, smi, auto, trace):
    """10b: ViT-B/16@224 serving and TTA with ``impl``: the launches, the
    logits against the plain attention and the control, with ``trace`` the
    profile; returns (the serving run's launch count, img/s, peak GiB)."""
    from fedvit_torch.core.config import (Config, DataConfig, ModelConfig,
                                          TrainingConfig)
    from fedvit_torch.data.pipeline import canvas_size, make_device_augment
    from fedvit_torch.eval.serve import (_evaluate, evaluate_with_tta,
                                         make_eval_step)
    from fedvit_torch.models import build_model

    kernel = IMPL_KERNELS[impl][0]
    tag = f"serve-{impl}"
    cfg = Config(
        data=DataConfig(use_segmentation_mask=True),
        model=ModelConfig(backbone="vit_base_patch16_224", image_size=224,
                          compute_dtype="bfloat16", drop_path_rate=0.0,
                          attention_impl=impl),
        training=TrainingConfig(batch_size=SERVE_BATCH))
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    perturb(model, SEED)
    canvas = canvas_size(cfg.model.image_size)
    source = serving_inputs(SERVE_IMAGES, canvas)
    augment = make_device_augment(cfg, False)
    step = make_eval_step(model, cfg, augment=augment)
    _evaluate(step, serving_inputs(SERVE_BATCH, canvas), SERVE_BATCH,
              cfg.num_classes)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run(what, fn, forwards):
        reset_counts(fa, None)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts(fa, None)
        want = {k: 0 for k in counts} | {kernel: BLOCKS * forwards}
        log(f"[{tag}] {what}: launches {counts} for {forwards} forwards")
        if counts != want:
            raise RuntimeError(f"{tag}: {what} did not launch {kernel} alone, "
                               f"{BLOCKS} times a forward")
        return out, seconds, counts[kernel]

    def through(managers, fn):
        with contextlib.ExitStack() as stack:
            for ctx in managers:
                stack.enter_context(ctx)
            return fn()

    serve = lambda: _evaluate(step, source, SERVE_BATCH, cfg.num_classes)["logits"]
    served, serve_s, launches = run("serving", serve,
                                    math.ceil(SERVE_IMAGES / SERVE_BATCH))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = through([impl_replaced_by(impl, plain_attention(impl))], serve)
    compare_logits(tag, served, want)
    ctrl = rel_rms(through(logits_control(impl, model), serve), want)
    log(f"[{tag}] control, {'the qkv Dense without its bias' if impl == 'packed' else 'the plain K11 with its bias zeroed'}: "
        f"RMS error {ctrl!r} x RMS logit (must exceed {LOGITS_RTOL_BF16!r})")
    if not ctrl > LOGITS_RTOL_BF16:
        raise RuntimeError(f"{tag}: the logits check cannot tell the control")
    rate = SERVE_IMAGES / serve_s
    log(f"[{tag}] ViT-B/16@224 bf16 4ch+meta attention_impl {impl} bs "
        f"{SERVE_BATCH}: {SERVE_IMAGES} images in {serve_s!r} s = {rate!r} img/s, "
        f"peak {peak_gb!r} GiB; auto in this run {auto['img_s']!r} img/s, peak "
        f"{auto['peak_gib']!r} GiB ({smi})")

    tta_source = serving_inputs(TTA_IMAGES, canvas)
    tta = lambda: evaluate_with_tta(cfg, model, tta_source,
                                    batch_size=TTA_BATCH)[2]
    tta_logits, tta_s, _ = run("tta", tta, math.ceil(TTA_IMAGES / TTA_BATCH))
    compare_logits(f"tta-{impl}", tta_logits, through(
        [impl_replaced_by(impl, plain_attention(impl))], tta))
    log(f"[tta-{impl}] 8 views bs {TTA_BATCH}: {TTA_IMAGES} images in {tta_s!r}"
        f" s = {TTA_IMAGES / tta_s!r} img/s; auto in this run "
        f"{auto['tta_img_s']!r} img/s ({smi})")
    if trace:
        trace_serving(model, step, augment, source, cfg, smi,
                      kernel=IMPL_TRACE[impl][0], tag=f"-{impl}")
    return launches, rate, peak_gb


def impl_control_grads(fa, impl):
    """The gradient check's control of ``impl``: for ``mega`` K11 with dW
    zeroed, for ``packed`` K10 with the k third of dqkv zeroed."""
    if impl == "mega":
        class WithoutDw(fa.XqkvAttention):
            @staticmethod
            def backward(ctx, dout):
                dx, dw, db, _ = fa.XqkvAttention.backward(ctx, dout)
                return dx, torch.zeros_like(dw), db, None

        return WithoutDw.apply, "K11 with dW zeroed (every qkv.weight leaf)"

    class WithoutDk(fa.QkvAttention):
        @staticmethod
        def backward(ctx, dout):
            dqkv, _ = fa.QkvAttention.backward(ctx, dout)
            e = dqkv.shape[-1] // 3
            dqkv[..., e:2 * e] = 0
            return dqkv, None

    return WithoutDk.apply, ("K10 with the k third of dqkv zeroed (the k rows "
                             "of every qkv.weight)")


def impl_train(fa, ln, impl, smi, trace):
    """10c: the phase-6 recipe with ``impl``: a warm-up step, 5 timed steps
    with their launches, then one macro batch's gradients against the plain
    path with a control, and with ``trace`` the profile of a step; returns
    the launch counts.

    Each leaf is held to GRAD_RTOL_BF16 of the plain path's gradient, as
    phase 6c holds K1-K3. The q, k and v rows of every qkv weight are judged
    apart as well (the packed control zeroes only the k rows), each allowed
    GRAD_RTOL_BF16 plus twice its own rounding noise, how far the plain path
    is from the plain path with its attention in fp32, as phase 8c does. The
    q and k rows carry dq and dk, sums that cancel (a row of dS sums to 0);
    bf16 rounding moves them by about a tenth of their size, and the kernel
    path is about as far from the fp32 plain path as from the bf16 one
    (measured: 0.101-0.103 and 0.106-0.110 at blocks 10 and 11, against the
    plain paths' 0.076 from each other), so neither reference holds them to
    the flat limit. How far the kernel path is from each is printed."""
    kernel = IMPL_KERNELS[impl][0]
    tag = f"train-{impl}"
    cfg, model, state, step, batches = training_setup(
        "vit_base_patch16_224", 224, MICRO, ACCUM, 0.1, 0.75, attention_impl=impl)
    state = warm_up_step(tag, cfg, model, state, step, batches[0])
    micro_batches = TIMED_STEPS * ACCUM
    want = {k: 0 for k in counted(fa, ln)} | {
        f"{kernel}_lse": micro_batches * BLOCKS,
        f"{kernel}_bwd": micro_batches * BLOCKS, "K4": micro_batches * NORMS}
    state, counts = timed_steps(tag, f"ViT-B/16@224 bf16 4ch+meta {impl}", fa,
                                ln, state, step, batches[1:], want, smi)
    control, control_name = impl_control_grads(fa, impl)
    plain_ln = layer_norm_backward_replaced_by
    got = grads_by_path(model, state, step, batches[1], {
        "kernel": (),
        "plain": (impl_replaced_by(impl, plain_attention(impl)),
                  plain_ln(ln.ln_bwd_plain)),
        "fp32": (impl_replaced_by(impl, plain_attention(impl, fp32=True)),
                 plain_ln(ln.ln_bwd_plain)),
        "control": (impl_replaced_by(impl, control),)})
    for grads, _ in got.values():      # the q, k and v rows of each qkv weight
        for n in [n for n in grads if n.endswith("attn.qkv.weight")]:
            for part, rows in zip("qkv", grads[n].chunk(3, dim=0)):
                grads[f"{n}[{part}]"] = rows
    report = ("qkv.weight[q]", "qkv.weight[k]", "qkv.weight[v]",
              "attn.qkv.bias")
    kernel_g, fp32_g = got["kernel"][0], got["fp32"][0]
    for suffix in report:
        off = [rel_rms(kernel_g[n].cpu().numpy(), fp32_g[n].cpu().numpy())
               for n in fp32_g if n.endswith(suffix)]
        log(f"[{tag}]   {suffix}: the kernel path vs the plain path with fp32 "
            f"attention, median {float(np.median(off))!r}, largest {max(off)!r}")
    suffix = "attn.qkv.weight" if impl == "mega" else "attn.qkv.weight[k]"
    compare_grads(tag, got, GRAD_RTOL_BF16,
                  [n for n in got["plain"][0] if n.endswith(suffix)],
                  control_name, report=report,
                  noisy=lambda name: name.endswith("]"))
    if trace:
        trace_training(f"profile-train-{impl}", step, state, batches[2], smi,
                       IMPL_TRACE[impl][1])
    return counts


# K11's three products alone (gemm.cuh through ``gemm_product``), against the
# fp32 torch.matmul of the same bf16 operands rounded once (``product_plain``):
# both sum in fp32 and round once, so a value differs by at most one bf16 ulp
# (2^-7 of it) where the two sums straddle a rounding boundary, plus
# GEMM_ATOL_BF16 near zero, where sums of up to 12,608 unit products in another order differ
# by ~1e-5.
GEMM_RTOL_BF16 = 2.0 ** -7
GEMM_ATOL_BF16 = 1e-3


def check_gemm_products(fa):
    """Phase 10a: x·W at the serving shape, dqkv·Wᵀ and xᵀ·dqkv at the
    micro-batch of 64, each against its plain version, twice for the same
    bits, timed beside torch.matmul's bf16 product. Returns a record per
    product."""
    from fedvit_torch.ops.attention import product_plain

    n, dim, e3 = (224 // 16) ** 2 + 1, 768, 2304
    cases = (("x_W", SERVE_BATCH * n, e3, dim, False, False, True),
             ("dqkv_Wt", MICRO * n, dim, e3, False, True, False),
             ("xt_dqkv", dim, e3, MICRO * n, True, False, False))
    recs = {}
    for name, m, nn_, k, ta, tb, with_bias in cases:
        a = seeded((k, m) if ta else (m, k), torch.bfloat16, SEED + 70 + m)
        b = seeded((nn_, k) if tb else (k, nn_), torch.bfloat16, SEED + 71 + k,
                   1.0 / math.sqrt(k))
        bias = seeded((nn_,), torch.bfloat16, SEED + 72, 0.5) if with_bias else None
        op_a, op_b = (a.t() if ta else a), (b.t() if tb else b)

        def run():
            return fa.gemm_product(a, b, bias, transpose_a=ta, transpose_b=tb)

        got, again = run(), run()
        torch.cuda.synchronize()
        want = product_plain(op_a, op_b, bias).float()
        diff = (got.float() - want).abs()
        err = float((diff - GEMM_RTOL_BF16 * want.abs()).max())
        same = torch.equal(got, again)
        rec = {"max_abs_err": float(diff.max()), "same_bits": same}
        rec["ms"] = cuda_ms(run)
        rec["matmul_ms"] = cuda_ms(lambda: torch.matmul(op_a, op_b))
        flops = 2.0 * m * nn_ * k
        rec["tflop_s"] = flops / rec["ms"] / 1e9
        rec["peak_share"] = flops / rec["ms"] / 1e-3 / PEAK_FLOPS[torch.bfloat16]
        nbytes = (a.numel() + b.numel() + got.numel()
                  + (bias.numel() if bias is not None else 0)) * 2
        rec.update(bound(nbytes, flops, torch.bfloat16))
        log(f"[gemm] {name} ({m} x {nn_} x {k}{', bias' if with_bias else ''})"
            f": max_abs_err {rec['max_abs_err']!r}, beyond one bf16 ulp {err!r} "
            f"(tolerance {GEMM_ATOL_BF16!r}), the same bits twice: {same}; "
            f"{rec['ms']!r} ms = {rec['tflop_s']!r} TFLOP/s, "
            f"{rec['peak_share']!r} of the bf16 peak; torch.matmul bf16 "
            f"{rec['matmul_ms']!r} ms; bound {rec['bound_ms']!r} ms by "
            f"{rec['bound_by']}")
        if not (err <= GEMM_ATOL_BF16 and same and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"gemm.cuh's {name} disagrees with its plain version")
        recs[name] = rec
    return recs


def packed_mega_phase(fa, ln, attention_from_qkvb, smi, auto, trace):
    """Phase 10; returns the six records of K10's and K11's entries for the
    kernels line."""
    # 10a. the kernels: small fp32 cases (ragged N, several rows, d 64 and 80)
    for n, d, heads in ((37, 64, 2), (197, 64, 12), (37, 80, 2), (197, 80, 2)):
        check_k10(fa, 3, n, heads, d, torch.float32, ("fwd", "lse", "bwd"), False)
        check_k11(fa, 3, n, heads * d, heads, d, torch.float32,
                  ("fwd", "lse", "bwd"), False)
    check_k11(fa, 2, 37, 128, 2, 80, torch.float32, ("fwd", "bwd"), False)  # D ≠ E
    n = (224 // 16) ** 2 + 1
    recs = {"K10": check_k10(fa, SERVE_BATCH, n, 12, 64, torch.bfloat16, ("fwd",),
                             True),
            "K11": check_k11(fa, SERVE_BATCH, n, 768, 12, 64, torch.bfloat16,
                             ("fwd",), True)}
    recs["K10"] |= check_k10(fa, MICRO, n, 12, 64, torch.bfloat16,
                             ("lse", "bwd"), True)
    recs["K11"] |= check_k11(fa, MICRO, n, 768, 12, 64, torch.bfloat16,
                             ("lse", "bwd"), True)
    recs["K11"]["fwd"]["gemm"] = check_gemm_products(fa)
    torch.cuda.empty_cache()
    # 10b, 10c
    for impl in IMPL_KERNELS:
        kernel = IMPL_KERNELS[impl][0]
        launches, rate, peak = impl_serving(fa, impl, smi, auto, trace)
        recs[kernel]["fwd"] |= {"launches": launches, "serve_img_s": rate,
                                "serve_peak_gib": peak}
        torch.cuda.empty_cache()
        counts = impl_train(fa, ln, impl, smi, trace)
        recs[kernel]["lse"]["launches"] = counts[f"{kernel}_lse"]
        recs[kernel]["bwd"]["launches"] = counts[f"{kernel}_bwd"]
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# 11. The op-level attention: K9 (flat q, k, v) and K12 (scaled cosine)
# ---------------------------------------------------------------------------

def flat_views(q, k, v, heads):
    """(B, H, N, d) views of flat (B, N, E) q, k, v, for SDPA."""
    b, n, e = q.shape
    return [t.view(b, n, heads, e // heads).transpose(1, 2) for t in (q, k, v)]


def check_k9(fa, b, n, heads, d, dtype, entries, timed):
    """K9's ``entries`` (of "fwd", "lse", "bwd") through their wrappers
    against the plain version (``dot_product_attention_flat(impl="xla")``) on
    the same seeded inputs; returns a record per entry, timed when
    ``timed``."""
    from fedvit_torch.ops.attention import dot_product_attention_flat

    def plain(*t):
        return dot_product_attention_flat(*t, heads, impl="xla")

    e = heads * d
    q, k, v = (seeded((b, n, e), dtype, SEED + 70 + n + d + i) for i in range(3))
    dout = seeded((b, n, e), dtype, SEED + 73 + n + d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4.0 * b * heads * n * n * d
    io = 4 * q.numel() * q.element_size()           # q, k, v read, out written
    tag = f"[k9] q, k, v {tuple(q.shape)} {short(dtype)} heads {heads} (d {d})"
    atol = K1_ATOL_FP32 if dtype == torch.float32 else K1_ATOL_BF16
    recs = {}
    if "fwd" in entries:
        out = fa.flash_attention_flat(q, k, v, heads)
        torch.cuda.synchronize()
        err = float((out.float() - plain(q, k, v).float()).abs().max())
        log(f"{tag}: forward max_abs_err {err!r} (tolerance {atol!r})")
        if not (err <= atol and bool(torch.isfinite(out).all())
                and out.dtype == dtype):
            raise RuntimeError("K9 disagrees with its plain version")
        rec = recs["fwd"] = {"max_abs_err": err}
        if timed:
            rec["ms"] = cuda_ms(lambda: fa.flash_attention_flat(q, k, v, heads))
            rec["plain_ms"] = cuda_ms(lambda: plain(q, k, v))
            rec["library_ms"] = cuda_ms(lambda: sdpa(*flat_views(q, k, v, heads)))
            rec.update(bound(io, flops, dtype))
    if "lse" in entries:
        out, lse = fa.flat_attention_lse_cuda(q, k, v, heads)
        torch.cuda.synchronize()
        qh, kh, _ = (t.float() for t in flat_views(q, k, v, heads))
        want_lse = torch.logsumexp(qh @ kh.transpose(-1, -2) / math.sqrt(d), -1)
        same = torch.equal(out, fa.flat_attention_cuda(q, k, v, heads))
        err = float((out.float() - plain(q, k, v).float()).abs().max())
        lse_err = float((lse - want_lse).abs().max())
        log(f"{tag}: log-sum-exp entry max_abs_err {err!r}, bit-identical to "
            f"the forward: {same}; lse max_abs_err {lse_err!r} (tolerance "
            f"{K2_LSE_ATOL!r})")
        if not (same and err <= atol and lse_err <= K2_LSE_ATOL):
            raise RuntimeError("K9's log-sum-exp entry disagrees")
        rec = recs["lse"] = {"max_abs_err": err}
        if timed:
            rec["ms"] = cuda_ms(lambda: fa.flat_attention_lse_cuda(q, k, v, heads))
            rec["plain_ms"] = cuda_ms(lambda: plain(q, k, v))
            rec["library_ms"] = cuda_ms(lambda: sdpa(*flat_views(q, k, v, heads)))
            rec.update(bound(io + lse.numel() * 4, flops, dtype))
    if "bwd" in entries:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(fa.flash_attention_flat(*leaves, heads), leaves,
                                  dout)
        torch.cuda.synchronize()
        plain_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out_p = plain(*plain_leaves)
        want = torch.autograd.grad(out_p, plain_leaves, dout, retain_graph=True)
        rels = [rel_max(g, w) for g, w in zip(got, want)]
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        log(f"{tag}: backward dq, dk, dv {rels!r} of the largest |value| "
            f"(tolerance {K3_TOL[dtype]!r}); max_abs_err {err!r}")
        if not (max(rels) <= K3_TOL[dtype] and all(
                bool(torch.isfinite(g).all()) and g.dtype == dtype for g in got)):
            raise RuntimeError("K9's backward disagrees with its plain version")
        rec = recs["bwd"] = {"max_abs_err": err}
        if timed:
            o, lse = fa.flat_attention_lse_cuda(q, k, v, heads)
            rec["ms"] = cuda_ms(
                lambda: fa.flat_attention_bwd_cuda(q, k, v, o, dout, lse, heads))
            rec["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_p, plain_leaves, dout, retain_graph=True))
            lib_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out_s = sdpa(*flat_views(*lib_leaves, heads))
            dout_s = dout.view(b, n, heads, d).transpose(1, 2)
            rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_s, lib_leaves, dout_s, retain_graph=True))
            # q, k, v, dout read, dq, dk, dv written (the TPU kernel
            # recomputes the softmax: out and lse are no bytes it needs)
            rec.update(bound(7 * q.numel() * q.element_size(), 2.5 * flops,
                             dtype))
    for name, rec in recs.items():
        if "ms" in rec:
            log(f"{tag}: {name} kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r}"
                f" ms, sdpa {rec['library_ms']!r} ms, bound {rec['bound_ms']!r} "
                f"ms by {rec['bound_by']}")
    return recs


def check_k9_is_k10(fa, b, n, heads, d, dtype):
    """K9 on three contiguous (B, N, E) tensors against K10 on their
    concatenation: the same output, lse and (dq | dk | dv) bits."""
    e = heads * d
    qkv = seeded((b, n, 3 * e), dtype, SEED + 76 + n)
    dout = seeded((b, n, e), dtype, SEED + 77 + n)
    q, k, v = (t.contiguous() for t in qkv.split(e, dim=-1))
    out, lse = fa.flat_attention_lse_cuda(q, k, v, heads)
    out_p, lse_p = fa.qkv_attention_lse_cuda(qkv, heads)
    same = {"fwd": torch.equal(fa.flat_attention_cuda(q, k, v, heads),
                               fa.qkv_attention_cuda(qkv, heads)),
            "lse": torch.equal(out, out_p) and torch.equal(lse, lse_p),
            "bwd": torch.equal(
                torch.cat(fa.flat_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                     heads), dim=-1),
                fa.qkv_attention_bwd_cuda(qkv, out_p, dout, lse_p, heads))}
    torch.cuda.synchronize()
    log(f"[k9] against K10 on the same values, {tuple(qkv.shape)} "
        f"{short(dtype)} heads {heads}: bit-identical {same}")
    if not all(same.values()):
        raise RuntimeError("K9 and K10 give other bits on the same values")


def k9_control(fa, dtype):
    """K9 launched with the score scale 1 instead of 1/√d must fail the
    forward check."""
    from fedvit_torch.ops.attention import dot_product_attention_flat

    b, n, heads, d = 8, 197, 12, 64
    q, k, v = (seeded((b, n, heads * d), dtype, SEED + 78 + i) for i in range(3))
    out = torch.empty_like(q)
    fa._raise_on(fa._library().flat_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n,
        heads * d, heads, fa._DTYPES[dtype], 1.0, fa._stream(q)),
        "flat_attention_fwd")
    want = dot_product_attention_flat(q, k, v, heads, impl="xla")
    err = float((out.float() - want.float()).abs().max())
    log(f"[k9] control, the score scale 1: max_abs_err {err!r} (must exceed "
        f"{K1_ATOL_BF16!r})")
    if not err > K1_ATOL_BF16:
        raise RuntimeError("the K9 check cannot tell a wrong score scale")


def cosine_inputs(w0, b, n, heads, dtype, side, seed, zero_rows=False):
    """K12's inputs: raw q, k, v of normal entries, each head's scale
    exp(U[ln 10, ln 100]) as SwinV2's logit_scale, a bias of 16·sigmoid size
    and the real shift mask of a ``side``² map (None: no mask). With
    ``zero_rows``, some rows of q and k of norm 0 and below 1e-6."""
    from fedvit_torch.models.swin import shift_attention_mask

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows, e = w0 * b, 32 * heads
    q, k, v = (torch.randn(rows, n, e, device="cuda", generator=g)
               for _ in range(3))
    if zero_rows:
        q[:, :3] = 0
        q[:, 3] *= 1e-8
        k[:, 2:5] = 0
        k[:, 6] = 1e-7 / math.sqrt(32)
    lo, hi = math.log(10), math.log(100)
    scale = torch.exp(lo + (hi - lo) * torch.rand(heads, device="cuda",
                                                  generator=g))
    bias = 16 * torch.sigmoid(
        2 * torch.randn(heads, n, n, device="cuda", generator=g))
    mask = None
    if side is not None:
        window = math.isqrt(n)
        mask = torch.from_numpy(
            shift_attention_mask(side, side, window, window // 2)).cuda()
        if mask.shape != (w0, n, n):
            raise RuntimeError(f"shift mask {tuple(mask.shape)} for W0 = {w0}")
    return q.to(dtype), k.to(dtype), v.to(dtype), scale, bias, mask


def cosine_scores_lse(q, k, scale, bias, mask, heads):
    """torch.logsumexp of the plain version's fp32 scores: (W0·B, H, N)."""
    rows, n, e = q.shape
    w0 = 1 if mask is None else mask.shape[0]

    def unit(t):
        t = t.reshape(w0, rows // w0, n, heads, e // heads).float()
        return t / t.norm(dim=-1, keepdim=True).clamp(min=1e-6)

    qh = (unit(q) * scale.reshape(1, 1, 1, heads, 1)).to(q.dtype).float()
    kh = unit(k).to(q.dtype).float()
    s = torch.einsum("wbnhd,wbmhd->wbhnm", qh, kh) + bias
    if mask is not None:
        s = s + mask[:, None, None]
    return torch.logsumexp(s, -1).reshape(rows, heads, n)


def held(got, want, dtype) -> float:
    """K12's measure: fp32, max |difference| over max(1, max |plain|); bf16,
    the RMS of the difference over the RMS of the plain value."""
    if dtype == torch.float32:
        return rel_max(got, want)
    return rel_rms(got.float().cpu().numpy(), want.float().cpu().numpy())


def times_norm(g, x, heads):
    """g times max(‖x‖, 1e-6) of each row's head slice of x, fp32."""
    rows, n, e = x.shape
    split = (rows, n, heads, e // heads)
    norm = torch.linalg.vector_norm(x.float().reshape(split), dim=-1,
                                    keepdim=True).clamp(min=1e-6)
    return (g.float().reshape(split) * norm).reshape(x.shape)


def cosine_library(q, k, v, scale, attn_mask, heads):
    """K12's library yardstick: ``F.normalize`` of q and k, q times its
    head's scale, then SDPA with the summed bias and mask as ``attn_mask``."""
    rows, n, e = q.shape
    split = [t.view(rows, n, heads, e // heads) for t in (q, k, v)]
    qn = (torch.nn.functional.normalize(split[0].float(), dim=-1, eps=1e-6)
          * scale.view(1, 1, heads, 1)).to(q.dtype)
    kn = torch.nn.functional.normalize(split[1].float(), dim=-1,
                                       eps=1e-6).to(q.dtype)
    return torch.nn.functional.scaled_dot_product_attention(
        qn.transpose(1, 2), kn.transpose(1, 2), split[2].transpose(1, 2),
        attn_mask=attn_mask, scale=1.0)


def check_k12(fa, w0, b, n, heads, dtype, side, entries, timed,
              zero_rows=False):
    """K12's ``entries`` (of "fwd", "lse", "bwd") through their wrappers
    against the plain version (``windowed_cosine_attention_flat(impl=
    "xla")``) on the same seeded inputs; the backward's five gradients each,
    and run twice for the same bits. Returns a record per entry, timed when
    ``timed``."""
    from fedvit_torch.ops.attention import (windowed_cosine_attention_flat,
                                            windowed_cosine_dscale)

    def plain(*t):
        return windowed_cosine_attention_flat(*t, mask, heads, impl="xla")

    q, k, v, scale, bias, mask = cosine_inputs(
        w0, b, n, heads, dtype, side, SEED + 80 + n + heads + w0, zero_rows)
    dout = seeded(q.shape, dtype, SEED + 81 + n + heads)
    rows, e = w0 * b, heads * 32
    shape = (f"(W0 {w0}, B {b}, N {n}, H {heads}, d 32) {short(dtype)}"
             f"{', zero rows' if zero_rows else ''}")
    tag = f"[k12] {shape}, mask {None if mask is None else tuple(mask.shape)}"
    f32 = dtype == torch.float32
    tol = K12_TOL_FP32 if f32 else K12_RTOL_BF16
    how = "of the largest |value|" if f32 else "RMS error / RMS value"
    extra = (bias.numel() + (0 if mask is None else mask.numel())
             + scale.numel()) * 4
    io = 4 * q.numel() * q.element_size() + extra
    flops = 4.0 * rows * heads * n * n * 32 + 4.0 * 2 * rows * n * e  # + norms
    attn_mask = None
    if timed:
        added = bias[None] if mask is None else bias[None] + mask[:, None]
        attn_mask = added.to(dtype)[:, None].expand(
            added.shape[0], b, heads, n, n).reshape(rows, heads, n, n)
    recs = {}
    if "fwd" in entries:
        out = fa.flash_attention_cosine_flat(q, k, v, scale, bias, mask, heads)
        torch.cuda.synchronize()
        want = plain(q, k, v, scale, bias)
        max_err = float((out.float() - want.float()).abs().max())
        err = max_err if f32 else held(out, want, dtype)
        atol = K12_ATOL_FP32 if f32 else K12_RTOL_BF16
        log(f"{tag}: forward {'max_abs_err' if f32 else how} {err!r} "
            f"(tolerance {atol!r})")
        if not (err <= atol and bool(torch.isfinite(out).all())
                and out.dtype == dtype):
            raise RuntimeError(f"K12 {shape} disagrees with its plain version")
        rec = recs["fwd"] = {"max_abs_err": max_err}
        if timed:
            rec["ms"] = cuda_ms(lambda: fa.flash_attention_cosine_flat(
                q, k, v, scale, bias, mask, heads), iters=8, warmup=2)
            rec["plain_ms"] = cuda_ms(lambda: plain(q, k, v, scale, bias),
                                      iters=4, warmup=1)
            rec["library_ms"] = cuda_ms(lambda: cosine_library(
                q, k, v, scale, attn_mask, heads), iters=8, warmup=2)
            rec.update(bound(io, flops, dtype))
    if "lse" in entries:
        out, lse, out32 = fa.cosine_window_attention_lse_cuda(
            q, k, v, scale, bias, mask, heads)
        torch.cuda.synchronize()
        same = (torch.equal(out, fa.cosine_window_attention_cuda(
            q, k, v, scale, bias, mask, heads))
            and torch.equal(out32.to(dtype), out))
        diff = (lse - cosine_scores_lse(q, k, scale, bias, mask, heads)).abs()
        lse_err, lse_mean = float(diff.max()), float(diff.mean())
        ok = lse_err <= K12_LSE_ATOL_FP32 if f32 else lse_mean <= K12_LSE_MEAN_BF16
        log(f"{tag}: log-sum-exp entry bit-identical to the forward: {same}; "
            f"lse max_abs_err {lse_err!r}, mean {lse_mean!r} (tolerance "
            f"{K12_LSE_ATOL_FP32 if f32 else K12_LSE_MEAN_BF16!r}, "
            f"{'max' if f32 else 'mean'})")
        if not (same and ok and bool(torch.isfinite(lse).all())):
            raise RuntimeError(f"K12's log-sum-exp entry disagrees at {shape}")
        want = plain(q, k, v, scale, bias)
        rec = recs["lse"] = {"max_abs_err": float(
            (out.float() - want.float()).abs().max()), "lse_max_abs_err": lse_err}
        if timed:
            rec["ms"] = cuda_ms(lambda: fa.cosine_window_attention_lse_cuda(
                q, k, v, scale, bias, mask, heads), iters=6, warmup=1)
            rec["plain_ms"] = cuda_ms(lambda: plain(q, k, v, scale, bias),
                                      iters=3, warmup=1)
            with torch.no_grad():
                rec["library_ms"] = cuda_ms(lambda: cosine_library(
                    q, k, v, scale, attn_mask, heads), iters=6, warmup=1)
            # the forward's bytes and lse; out32, the port's own leftover
            # for its backward, is no byte the function needs
            rec.update(bound(io + lse.numel() * 4, flops, dtype))
    if "bwd" in entries:
        leaves = [t.clone().requires_grad_() for t in (q, k, v, scale, bias)]
        before = launch_counts(fa, None)
        got = torch.autograd.grad(fa.flash_attention_cosine_flat(
            *leaves, mask, heads), leaves, dout)
        torch.cuda.synchronize()
        after = launch_counts(fa, None)
        launched = {key: after[key] - before[key] for key in after}
        if launched != {key: 0 for key in after} | {"K12_lse": 1, "K12_bwd": 1}:
            raise RuntimeError(f"K12 {shape}: under grad the wrapper launched "
                               f"{launched}")
        plain_leaves = [t.clone().requires_grad_() for t in (q, k, v, scale, bias)]
        out_p = plain(*plain_leaves)
        want = torch.autograd.grad(out_p, plain_leaves, dout, retain_graph=True)
        if not f32:      # dscale in the TPU kernel's order, dS rounded
            leaves32 = [t.detach().float().requires_grad_()
                        for t in (q, k, v, scale, bias)]
            want32 = torch.autograd.grad(plain(*leaves32), leaves32,
                                         dout.float())[3]
            log(f"{tag}: dscale from the plain version in fp32: kernel "
                f"{held(got[3], want32, dtype)!r}, plain bf16 "
                f"{held(want[3], want32, dtype)!r}")
            del leaves32, want32
            want = (*want[:3], windowed_cosine_dscale(
                q, k, v, scale, bias, mask, dout, heads), want[4])
        names = ("dq", "dk", "dv", "dscale", "dbias")
        errs = {nm: held(g, w, dtype) for nm, g, w in zip(names, got, want)}
        if zero_rows:    # on x̂'s scale: a clamped row's dq, dk are 1e6·dx̂
            errs["dq"], errs["dk"] = (held(times_norm(g, x, heads),
                                           times_norm(w, x, heads), dtype)
                                      for g, w, x in zip(got, want, (q, k)))
        limits = dict.fromkeys(names, tol)
        o, lse, o32 = fa.cosine_window_attention_lse_cuda(q, k, v, scale, bias,
                                                          mask, heads)
        again = [fa.cosine_window_attention_bwd_cuda(
            q, k, v, scale, bias, mask, o32, dout, lse, heads) for _ in range(2)]
        same = all(torch.equal(x, y) for x, y in zip(*again))
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got[:3], want[:3]))
        log(f"{tag}: backward {errs} {how} (tolerance {limits}); dq, dk, dv "
            f"max_abs_err {err!r}; dscale {got[3].tolist()!r}; the backward "
            f"twice gives the same bits: {same}")
        ok = all(errs[nm] <= limits[nm] for nm in names) and same and all(
            bool(torch.isfinite(g).all()) and g.shape == w.shape
            for g, w in zip(got, want))
        if not ok or any(g.dtype != dtype for g in got[:3]):
            raise RuntimeError(f"K12's backward {shape} disagrees with its "
                               f"plain version")
        # the control: dscale zeroed must fail the same check
        zeroed = held(torch.zeros_like(got[3]), want[3], dtype)
        if not zeroed > limits["dscale"]:
            raise RuntimeError("the K12 check cannot tell a zeroed dscale")
        rec = recs["bwd"] = {"max_abs_err": err, **{
            f"{nm}_err": x for nm, x in errs.items()}}
        if timed:
            rec["ms"] = cuda_ms(lambda: fa.cosine_window_attention_bwd_cuda(
                q, k, v, scale, bias, mask, o32, dout, lse, heads),
                iters=6, warmup=1)
            rec["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_p, plain_leaves, dout, retain_graph=True), iters=3, warmup=1)
            lib_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out_s = cosine_library(*lib_leaves, scale, attn_mask, heads)
            dout_s = dout.view(rows, n, heads, 32).transpose(1, 2)
            rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_s, lib_leaves, dout_s, retain_graph=True), iters=6, warmup=1)
            # q, k, v, dout read and dq, dk, dv written; bias, mask, scale
            # read, dbias and dscale written (the TPU kernel recomputes the
            # softmax: out and lse are no bytes the function needs)
            nbytes = (7 * q.numel() * q.element_size() + extra
                      + (bias.numel() + scale.numel()) * 4)
            rec.update(bound(nbytes, 10.0 * rows * heads * n * n * 32
                             + 12.0 * 2 * rows * n * e, dtype))
    for name, rec in recs.items():
        if "ms" in rec:
            log(f"{tag}: {name} kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r}"
                f" ms, F.normalize + sdpa {rec['library_ms']!r} ms (bias + mask"
                f" as attn_mask{'; no dbias or dscale' if name == 'bwd' else ''})"
                f", bound {rec['bound_ms']!r} ms by {rec['bound_by']}")
    return recs


def k12_control(fa):
    """K12 with each head's scale taken as 1 must fail the forward check."""
    from fedvit_torch.ops.attention import windowed_cosine_attention_flat

    w0, b, n, heads, side, _ = SWIN_STAGES[1]
    q, k, v, scale, bias, mask = cosine_inputs(w0, 2, n, heads, torch.bfloat16,
                                               side, SEED + 88)
    out = fa.cosine_window_attention_cuda(q, k, v, torch.ones_like(scale), bias,
                                          mask, heads)
    want = windowed_cosine_attention_flat(q, k, v, scale, bias, mask, heads,
                                          impl="xla")
    err = held(out, want, torch.bfloat16)
    log(f"[k12] control, each head's scale 1: RMS error / RMS value {err!r} "
        f"(must exceed {K12_RTOL_BF16!r})")
    if not err > K12_RTOL_BF16:
        raise RuntimeError("the K12 check cannot tell a wrong per-head scale")


def op_level_entries(fa, ln):
    """11c: the op-level entries on CUDA tensors with impl="auto" at the
    widths of 11a and 11b, forward and under autograd, with every count set
    to 0 just before; returns the counts, each checked against the calls."""
    from fedvit_torch.ops import attention as ops

    n = (224 // 16) ** 2 + 1
    reset_counts(fa, ln)
    with torch.no_grad():
        q, k, v = (seeded((SERVE_BATCH, n, 768), torch.bfloat16, SEED + 90 + i)
                   for i in range(3))
        outs = [ops.dot_product_attention_flat(q, k, v, 12)]
        split = [t.view(SERVE_BATCH, n, 12, 64) for t in (q, k, v)]
        outs.append(ops.dot_product_attention(*split, scale=0.5).reshape(q.shape))
        biased = ops.dot_product_attention(
            *[t[:8] for t in split], bias=torch.zeros(12, n, n, device="cuda"))
        del q, k, v, split
    b, n, heads, d = VIT_L_ATTENTION
    leaves = [seeded((b, n, heads * d), torch.bfloat16, SEED + 93 + i)
              .requires_grad_() for i in range(3)]
    ops.dot_product_attention_flat(*leaves, heads).float().square().sum().backward()
    views = [t.detach().view(b, n, heads, d).requires_grad_() for t in leaves]
    ops.dot_product_attention(*views).float().square().sum().backward()
    for w0, batch, n, heads, side, _ in SWIN_STAGES:
        with torch.no_grad():    # serving's batch of 32
            outs.append(ops.windowed_cosine_attention_flat(*cosine_inputs(
                w0, batch, n, heads, torch.bfloat16, side, SEED + 95 + heads),
                heads))
        *grad_leaves, mask = cosine_inputs(w0, SWIN_MICRO, n, heads,
                                           torch.bfloat16, side,
                                           SEED + 96 + heads)
        for t in grad_leaves:    # training's micro-batch of 8
            t.requires_grad_()
        ops.windowed_cosine_attention_flat(*grad_leaves, mask, heads).float() \
            .square().sum().backward()
        if not all(bool(torch.isfinite(t.grad).all()) for t in grad_leaves):
            raise RuntimeError("11c: a gradient of K12 is not finite")
        del grad_leaves
    torch.cuda.synchronize()
    got = launch_counts(fa, ln)
    want = {key: 0 for key in got} | {
        "K9": 2, "K9_lse": 2, "K9_bwd": 2, "K12": len(SWIN_STAGES),
        "K12_lse": len(SWIN_STAGES), "K12_bwd": len(SWIN_STAGES)}
    log(f"[op-level] launches: {got} (want {want}); the biased "
        f"dot_product_attention ran the plain body, finite "
        f"{bool(torch.isfinite(biased).all())}")
    if got != want or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError("11c: the op-level entries did not launch the "
                           "kernels as they should")
    return got


def flat_cosine_phase(fa, ln):
    """Phase 11; returns the records of K9's and K12's entries for the
    kernels line."""
    # 11a. K9
    for n, d, heads in ((37, 64, 2), (197, 64, 12), (37, 80, 2), (197, 80, 2)):
        check_k9(fa, 3, n, heads, d, torch.float32, ("fwd", "lse", "bwd"), False)
    check_k9_is_k10(fa, 3, 197, 12, 64, torch.bfloat16)
    check_k9_is_k10(fa, 2, 37, 2, 80, torch.float32)
    n = (224 // 16) ** 2 + 1
    k9 = check_k9(fa, SERVE_BATCH, n, 12, 64, torch.bfloat16, ("fwd",), True)
    k9 |= check_k9(fa, MICRO, n, 12, 64, torch.bfloat16, ("lse", "bwd"), True)
    b, n_l, heads_l, d_l = VIT_L_ATTENTION
    vit_l = check_k9(fa, b, n_l, heads_l, d_l, torch.bfloat16,
                     ("fwd", "lse", "bwd"), True)
    for entry, rec in vit_l.items():
        k9[entry]["vit_l_384"] = rec
    k9_control(fa, torch.bfloat16)
    torch.cuda.empty_cache()

    # 11b. K12
    for w0, b, n, heads, side in ((4, 3, 49, 2, 14), (9, 2, 16, 3, 12)):
        check_k12(fa, w0, b, n, heads, torch.float32, side,
                  ("fwd", "lse", "bwd"), False)
    check_k12(fa, 1, 5, 144, 6, torch.float32, None, ("fwd", "lse", "bwd"),
              False, zero_rows=True)
    check_k12(fa, 2, 3, 33, 2, torch.float32, None, ("fwd", "lse", "bwd"), False)
    stages = []
    for (w0, b, n, heads, side, _), (_, micro, *_unused) in zip(
            SWIN_STAGES, SWIN_TRAIN_STAGES):
        rec = check_k12(fa, w0, b, n, heads, torch.bfloat16, side, ("fwd",), True)
        rec |= check_k12(fa, w0, micro, n, heads, torch.bfloat16, side,
                         ("lse", "bwd"), True)
        stages.append(rec)
        torch.cuda.empty_cache()
    k12_control(fa)
    k12 = {entry: {**stages[2][entry], "stages": [st[entry] for st in stages]}
           for entry in ("fwd", "lse", "bwd")}
    torch.cuda.empty_cache()

    # 11c. the op-level entries, through which a user reaches both
    counts = op_level_entries(fa, ln)
    for key, rec in (("K9", k9["fwd"]), ("K9_lse", k9["lse"]),
                     ("K9_bwd", k9["bwd"]), ("K12", k12["fwd"]),
                     ("K12_lse", k12["lse"]), ("K12_bwd", k12["bwd"])):
        rec["launches"] = counts[key]
    torch.cuda.empty_cache()
    return {"K9": k9, "K12": k12}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", action="store_true",
                        help="also break the time of a serving batch (phases 5 "
                             "and 7), of a training step (phases 6 and 8) and "
                             "of a fold step (phase 9) down")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fedvit_torch.core import kernels
    from fedvit_torch.core.config import (Config, DataConfig, ModelConfig,
                                          TrainingConfig)
    from fedvit_torch.data.pipeline import canvas_size, make_device_augment
    from fedvit_torch.eval.serve import (_evaluate, evaluate_with_tta,
                                         make_eval_step)
    from fedvit_torch.models import build_model
    from fedvit_torch.ops import flash_attention as fa
    from fedvit_torch.ops import layer_norm as ln
    from fedvit_torch.ops.attention import attention_from_qkvb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card and the build
    smi = card()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = kernels.build_all()
    log(f"[build] {', '.join(built)} in {time.perf_counter() - t0!r} s")
    for name, text in built.items():
        for line in text.splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                log(f"[build] {name}: {line.strip()}")

    # 2. K1 against its plain version, at the serving shape and a small fp32 one
    e = 768
    n = (224 // 16) ** 2 + 1
    check_k1(fa, attention_from_qkvb, 4, n, 12, 64, torch.float32,
             K1_ATOL_FP32, timed=False)
    k1 = check_k1(fa, attention_from_qkvb, SERVE_BATCH, n, 12, e // 12,
                  torch.bfloat16, K1_ATOL_BF16, timed=True)
    # ViT-H's head width, d = 80, at a small batch
    k1["d80_max_abs_err"] = max(
        check_k1(fa, attention_from_qkvb, 3, n, 2, 80, torch.float32,
                 K1_ATOL_FP32, timed=False)["max_abs_err"],
        check_k1(fa, attention_from_qkvb, 8, n, 16, 80, torch.bfloat16,
                 K1_ATOL_BF16, timed=False)["max_abs_err"])

    # 3. serving: eval augment + forward at batch 256, ragged last batch
    cfg = Config(
        data=DataConfig(use_segmentation_mask=True),
        model=ModelConfig(backbone="vit_base_patch16_224", image_size=224,
                          compute_dtype="bfloat16", drop_path_rate=0.0),
        training=TrainingConfig(batch_size=SERVE_BATCH))
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    perturb(model, SEED)
    source = serving_inputs(SERVE_IMAGES, canvas_size(cfg.model.image_size))
    augment = make_device_augment(cfg, False)
    step = make_eval_step(model, cfg, augment=augment)
    warm = serving_inputs(SERVE_BATCH, canvas_size(cfg.model.image_size))
    _evaluate(step, warm, SERVE_BATCH, cfg.num_classes)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.flash_attention_qkvb.launches = 0
    t0 = time.perf_counter()
    served = _evaluate(step, source, SERVE_BATCH, cfg.num_classes)
    serve_s = time.perf_counter() - t0
    launches = expect_launches("serve", fa, math.ceil(SERVE_IMAGES / SERVE_BATCH))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    with attention_replaced_by(attention_from_qkvb):
        plain = _evaluate(step, source, SERVE_BATCH, cfg.num_classes)
    compare_logits("serve", served["logits"], plain["logits"])
    # the control: without the qkv bias the logits must leave the limit
    with attention_replaced_by(
            lambda qkv, bias, h: attention_from_qkvb(qkv, bias * 0, h)):
        no_bias = _evaluate(step, source, SERVE_BATCH, cfg.num_classes)
    control = rel_rms(no_bias["logits"], plain["logits"])
    log(f"[serve] control, plain attention without the qkv bias: RMS error "
        f"{control!r} x RMS logit (must exceed {LOGITS_RTOL_BF16!r})")
    if not control > LOGITS_RTOL_BF16:
        raise RuntimeError("the logits check cannot tell a dropped qkv bias")
    log(f"[serve] ViT-B/16@224 bf16 4ch+meta bs {SERVE_BATCH}: {SERVE_IMAGES} "
        f"images in {serve_s!r} s = {SERVE_IMAGES / serve_s!r} img/s, peak "
        f"{peak_gb!r} GiB ({smi})")

    # 4. 8-view TTA at batch 32
    tta_source = serving_inputs(TTA_IMAGES, canvas_size(cfg.model.image_size))
    fa.flash_attention_qkvb.launches = 0
    t0 = time.perf_counter()
    _, _, tta_logits = evaluate_with_tta(cfg, model, tta_source,
                                         batch_size=TTA_BATCH)
    tta_s = time.perf_counter() - t0
    expect_launches("tta", fa, math.ceil(TTA_IMAGES / TTA_BATCH))
    with attention_replaced_by(attention_from_qkvb):
        _, _, tta_plain = evaluate_with_tta(cfg, model, tta_source,
                                            batch_size=TTA_BATCH)
    compare_logits("tta", tta_logits, tta_plain)
    log(f"[tta] 8 views bs {TTA_BATCH}: {TTA_IMAGES} images in {tta_s!r} s = "
        f"{TTA_IMAGES / tta_s!r} img/s ({smi})")
    auto = {"img_s": SERVE_IMAGES / serve_s, "peak_gib": peak_gb,
            "tta_img_s": TTA_IMAGES / tta_s}

    # 5. where a serving batch's time goes
    if args.trace:
        trace_serving(model, step, augment, source, cfg, smi)

    # 6a. K2, K3, K4 at the training micro-batch's shapes and small fp32 ones
    for nn_ in (37, n):
        check_k2(fa, attention_from_qkvb, 3, nn_, 12, torch.float32, False)
        check_k3(fa, attention_from_qkvb, 3, nn_, 12, torch.float32, False)
    check_k4(ln, (3, 37, e), torch.float32, False)
    k2 = check_k2(fa, attention_from_qkvb, MICRO, n, 12, torch.bfloat16, True)
    k3 = check_k3(fa, attention_from_qkvb, MICRO, n, 12, torch.bfloat16, True)
    for check, rec in ((check_k2, k2), (check_k3, k3)):    # d = 80 (ViT-H)
        rec["d80_max_abs_err"] = max(
            check(fa, attention_from_qkvb, 3, 37, 2, torch.float32, False,
                  d=80)["max_abs_err"],
            check(fa, attention_from_qkvb, 8, n, 16, torch.bfloat16, False,
                  d=80)["max_abs_err"])
    k4 = check_k4(ln, (MICRO, n, e), torch.bfloat16, True)

    # 6b, 6c. the training step
    counts = train_phase(fa, ln, attention_from_qkvb, smi, args.trace)

    # 7. SwinV2-L@384 serving
    del model, step
    torch.cuda.empty_cache()
    k5 = swin_phase(fa, ln, smi, args.trace)

    # 8. SwinV2-L@384 training
    torch.cuda.empty_cache()
    k6, k5_lse, k4_swin, swin_counts = swin_train_phase(fa, ln, smi, args.trace)

    # 9. the train augment (K7, K8) and the fold trainer
    torch.cuda.empty_cache()
    k7, k8, _, _ = train_augment_phase(fa, ln, smi, args.trace)

    # 10. ViT-B/16@224 with attention_impl packed (K10) and mega (K11)
    torch.cuda.empty_cache()
    k10_k11 = packed_mega_phase(fa, ln, attention_from_qkvb, smi, auto,
                                args.trace)
    k10, k11 = k10_k11["K10"], k10_k11["K11"]

    # 11. the op-level attention: K9 and K12
    torch.cuda.empty_cache()
    k9_k12 = flat_cosine_phase(fa, ln)
    k9, k12 = k9_k12["K9"], k9_k12["K12"]
    extra = [{"name": name, "route": "cuda", "source": f"fedvit_torch/csrc/{src}",
              "replaces": f"fedvit_tpu/ops/flash_attention.py:{line}", **rec}
             for name, src, line, rec in (
                 ("qkv_attention_fwd", "qkvb_attention.cu", 129, k10["fwd"]),
                 ("qkv_attention_fwd_lse", "qkvb_attention.cu", 129, k10["lse"]),
                 ("qkv_attention_bwd", "qkvb_attention_bwd.cu", 143, k10["bwd"]),
                 ("xqkv_attention_fwd", "xqkv_attention.cu", 748, k11["fwd"]),
                 ("xqkv_attention_fwd_lse", "xqkv_attention.cu", 748, k11["lse"]),
                 ("xqkv_attention_bwd", "xqkv_attention_bwd.cu", 766,
                  k11["bwd"]),
                 ("flat_attention_fwd", "qkvb_attention.cu", 91, k9["fwd"]),
                 ("flat_attention_fwd_lse", "qkvb_attention.cu", 91, k9["lse"]),
                 ("flat_attention_bwd", "qkvb_attention_bwd.cu", 103,
                  k9["bwd"]),
                 ("cosine_window_attention_fwd", "window_attention.cu", 1466,
                  k12["fwd"]),
                 ("cosine_window_attention_fwd_lse", "window_attention.cu", 1466,
                  k12["lse"]),
                 ("cosine_window_attention_bwd", "window_attention_bwd.cu", 1494,
                  k12["bwd"]))]

    log(smi)
    log(json.dumps({"kernels": [
        {"name": "qkvb_attention_fwd", "route": "cuda",
         "source": "fedvit_torch/csrc/qkvb_attention.cu",
         "replaces": "fedvit_tpu/ops/flash_attention.py:367",
         "launches": launches, **k1},
        {"name": "qkvb_attention_fwd_lse", "route": "cuda",
         "source": "fedvit_torch/csrc/qkvb_attention.cu",
         "replaces": "fedvit_tpu/ops/flash_attention.py:466",
         "launches": counts["K2"], **k2},
        {"name": "qkvb_attention_bwd", "route": "cuda",
         "source": "fedvit_torch/csrc/qkvb_attention_bwd.cu",
         "replaces": "fedvit_tpu/ops/flash_attention.py:391",
         "launches": counts["K3"], **k3},
        {"name": "layer_norm_bwd", "route": "cuda",
         "source": "fedvit_torch/csrc/layer_norm_bwd.cu",
         "replaces": "fedvit_tpu/ops/layer_norm.py:90",
         "launches": counts["K4"], **k4,
         "launches_swin_train": swin_counts["K4"], "swin_shapes": k4_swin},
        {"name": "window_attention_fwd", "route": "cuda",
         "source": "fedvit_torch/csrc/window_attention.cu",
         "replaces": "fedvit_tpu/ops/flash_attention.py:992", **k5},
        {"name": "window_attention_fwd_lse", "route": "cuda",
         "source": "fedvit_torch/csrc/window_attention.cu",
         "replaces": "fedvit_tpu/ops/flash_attention.py:1168",
         "launches": swin_counts["K5_lse"], **k5_lse},
        {"name": "window_attention_bwd", "route": "cuda",
         "source": "fedvit_torch/csrc/window_attention_bwd.cu",
         "replaces": "fedvit_tpu/ops/flash_attention.py:1028",
         "launches": swin_counts["K6"], **k6},
        {"name": "row_shift", "route": "cuda",
         "source": "fedvit_torch/csrc/row_shift.cu",
         "replaces": "fedvit_tpu/ops/row_shift.py:80", **k7},
        {"name": "equalize", "route": "cuda",
         "source": "fedvit_torch/csrc/equalize.cu",
         "replaces": "fedvit_tpu/ops/randaugment.py:206", **k8},
        *extra]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
