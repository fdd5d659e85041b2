#!/usr/bin/env python3
"""Smoke run of fedvit_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --trace    # and where the time of a serving batch
                                     # and of a training step goes

Phases, one line of output each (or a few). Every gate on launch counts
holds the LayerNorm forward kernel's count too ("LN" beside K1-K12): one
launch a LayerNorm forward, 25 a ViT-B forward (26 or 27 with the
HybridViT's head and cross-attention), 53 a SwinV2-L one, and again for the
blocks' two each in a forward that remat recomputes.

1. the card (``nvidia-smi`` name and power limit, ``torch.cuda``), which of
   PIL, pandas, PyYAML and OpenCV import (in a process of their own; phase 13
   needs PIL, pandas and PyYAML), whether the host compiler finds libjpeg's
   and libpng's headers (``jpeglib.h``, ``png.h``; nothing here uses them),
   then the build of every hand-written kernel from ``fedvit_torch/csrc``
   with ``nvcc`` (one compiler per source, all at once);
2. each kernel against its plain PyTorch version on the card, at the shape
   the serving path gives it (and a small fp32 case, and ViT-H's head width
   d = 80 at a small batch), with its time, the plain version's, one PyTorch
   library call's for the same function, and the least time the card could
   take (the bound);
3. serving: a ViT-B/16@224 ``ISICClassifier`` (4 channels, metadata, bf16,
   seeded random weights) takes seeded 272² uint8 canvases through the eval
   augment and forward (``eval/serve.py::_evaluate``) at batch 256, with a
   ragged last batch; the kernel's launch count must be 12 per forward, the
   LayerNorm forward kernel's 25, and the logits must match the same model
   run with the plain attention;
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
      launch counts (2 × (12 K2, 12 K3, 25 K4, 25 LayerNorm forwards) a step,
      no K1), the parameters
      and the EMA shadow must move as the update says;
   c. the gradients of one macro batch through the kernels against the same
      step through the plain attention and LayerNorm backward, leaf by leaf,
      and a control with K3's bias gradient zeroed that must fail the check;
   with ``--trace``, a ``torch.profiler`` trace of one training step;
   d. the LayerNorm forward kernel (``csrc/layer_norm_fwd.cu``) against
      ``layer_norm_plain`` in the four (input, output) dtype pairs at small
      and odd shapes, then timed at the cells' shapes (a SwinV2-L serving
      batch of 32 at its four widths, ViT-B's 128 x 197 rows of 768) and the
      HybridViT's fp32 rows, beside its byte bound, the plain forward and
      ``F.layer_norm``;
7. SwinV2-L@384 serving (``swinv2_large_window12to24_192to384``):
   a. K5 (the windowed attention with a relative-position bias and a shift
      mask) against its plain version: small fp32 cases with a ragged N,
      several windows and several rows a window, then bf16 at the four stage
      shapes a batch of 32 gives it, with the real shift mask where the stage
      has one; its time, the plain version's, SDPA's with the summed bias and
      mask as ``attn_mask``, the bound and the exponentials' floor; the
      output against the plain version in the kernel's order
      (``window_attention_fwd_plain``); the log-sum-exp variant's output
      bit-equal to K5's and its LSE against ``torch.logsumexp``;
   b. serving: the ``ISICClassifier`` on SwinV2-L (4 channels, metadata, bf16,
      seeded perturbed weights) takes seeded 448² uint8 canvases through
      ``_evaluate`` at batch 32 with a ragged last batch; 24 K5 launches per
      forward, 53 of the LayerNorm forward and none of K1-K4; the logits against the same model with the
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
      plain autograd backward's, SDPA's backward and the bound; the
      log-sum-exp entry's time and its out32 against the kernel-order plain
      forward; K4 at SwinV2-L's four widths (D = 192, 384, 768, 1536 in
      bf16, 1536 in fp32), timed, and its time a micro-batch weighted by the
      launches at each width (5, 5, 37, 6);
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
      small fp32 cases (C of 1, 2, 3, 4, 5, a ragged W, an odd W at C = 4,
      C = 3 rows that start off 16 bytes, rows shorter than 4 floats, H ≠ W,
      ties, shifts past the extent, an image at a storage offset off 16
      bytes), then the rotation's and RandAugment's shapes at a ViT-B@224
      macro batch of 128 and a SwinV2-L@384 macro batch of 16, rows and
      columns, with the time, the plain version's, ``torch.gather``'s and the
      bound, K7's ratio to ``torch.gather`` and its share of the bound;
   b. K8 (equalize) the same way at (128, 224, 224, 3) and (16, 384, 384, 3),
      with a constant channel and a nearly constant one, and its share of the
      bound; untimed first at C of 1, 2, 4 and 5, B = 1, samples that its
      blocks' spans do not divide, samples too large for its blocks' shared
      memory and an image off 16 bytes, each also with a run of one bin
      through the first block's span and a channel whose only non-zero bin
      lies in the last block's;
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
      logit_scale; the forward and the log-sum-exp entry against the plain
      version in the kernel's order; the backward twice for the same bits;
      the time, the plain version's, ``F.normalize`` then SDPA's and the
      bound;
   c. the entries on CUDA tensors with ``impl="auto"`` at those widths,
      forward and under autograd, with every count set to 0 before: one
      launch a call of the right kernel entry, none for
      ``dot_product_attention`` with a bias (its plain body, as JAX's);
   with controls that must fail the checks: K9 with the score scale 1, K12
   with each head's scale 1, K12 with dscale zeroed.
12. federated training (``fed/server.py::train_federated``) of ViT-B/16@224
   (the recipe of 6b, local batch 32) on 2,048 synthetic 224² images
   (``data/synthetic.py``, the mask as a 4th channel: 1,792 training images
   resident on the card, 256 evaluated each round at batch 64), 4 clients
   by Dirichlet α 0.5, all taking part, the train augment in every local
   step, 8 local steps, 3 rounds:
   a. each round's synchronised time and img/s, the aggregation's device ms,
      the evaluation's img/s, the checkpoint's seconds and bytes, the run's
      peak memory; launches a round 4 × 8 × (12 K2, 12 K3, 25 K4, 12 K7,
      3 K8) and 12 K1 a forward of the evaluation, no call of their plain
      versions; the history finite, the caller's model unchanged; then, at
      the shapes this path gives them, each kernel against its plain
      version with its time (K1 at the evaluation batch of 64, K2-K4 at the
      local batch of 32, K7 and K8 at the shapes the train augment takes
      from the run's first gathered local batch, which it prints), that
      batch's augment bit-equal to the plain shifts and equalize, one local
      step's gradients against the plain path (6c's gate and control) and
      the evaluation's logits against the plain attention (phase 3's gate);
   b. the same run cut to 2 rounds: round 2's global parameters and
      BatchNorm statistics against θ + η(Σ wᵢθᵢ − θ) computed in fp64 from
      the clients' own leaves, and a control with equal weights that must
      fail the check;
   c. client 0's first local step of round 2 bit-equal to one step of a
      freshly made local optimizer;
   d. that run resumed to round 3: round 3 alone, every tensor and the numpy
      state restored bit for bit, round 3's indices the uninterrupted run's;
   e. ``python -m fedvit_torch.cli.train_federated --synthetic 256 --rounds
      1`` on the JAX defaults: one finite history entry, one checkpoint
      generation;
   f. with ``--trace``, round 2 of a 2-round run in stages (each ended by a
      synchronise) and a profile of round 2 of another: busy share, top
      kernels, K1-K4, K7 and K8's shares.

13. the user's ISIC path through its entry points' ``main(argv)``, in this
   process, on the card, under a temporary directory of the run's own
   (phases 15 and 16 read its layout after phase 14):
   a. a seeded ISIC-2019 layout written with PIL and pandas: the one-hot
      ground truth with UNK rows (dropped), metadata with NaN ages,
      mixed-case sex, ``anatom_site_general`` and lesions of 1-4 images,
      1,600 smooth lesion-like training JPEGs of 600x450 and 1024x1024 (a
      few CSV rows without one), a labelled test split of 256, a mask PNG
      an image; ``load_isic_data``'s seconds and ``HostDataSource``'s decode
      img/s (cold, then cached);
   b. ``cli.import_weights`` on a seeded timm-layout ViT-B/16@224 backbone
      ``.pt``: the 4th patch-embed channel the mean of the RGB kernels, every
      other backbone tensor the file's;
   c. ``cli.train --fold 0`` (5 folds, macro batch 128 as 2 x 64, bf16, the
      default train augment and TTA, 2 epochs, from b's output): fold 0's
      training and validation lesions disjoint, every step 12 K7, 3 K8 and
      2 x (12 K2, 12 K3, 25 K4), every evaluation forward 12 K1, no plain
      version called, the best and resume checkpoints, ``ensemble_logits.npy``
      (256, 8) and finite, the pretrained init logged; train img/s an epoch,
      validation and TTA img/s; K1's outputs in the run against its plain
      version on the run's own inputs, one qkv of each shape (the
      validation's and the TTA test's 8 views of 16), and K1 at the TTA
      test's (128, 197, 2304) against its plain version, timed;
   d. ``cli.predict --isic_dir --tta`` on the fold's best checkpoint: 12 K1 a
      forward, its logits against ``ensemble_logits.npy`` (bit-equality
      stated, phase 3's limit: the batch sizes differ), 256 CSV rows in the
      test frame's order, the classification report; K1 on the run's own
      inputs and at (512, 197, 2304), timed, as in c;
   e. ``cli.train_federated`` on the same files (4 clients x 8 local steps of
      64, 2 rounds, the whole training split decoded to uint8 canvases): the
      launches a round as phase 12 holds them, the history written; the
      run's first gathered local batch (64 uint8 canvases) through the train
      augment bit-equal to the plain shifts and equalize from the same
      generator state, and K7 and K8 against their plain versions, timed, at
      the shapes that call gave them, which it prints;
   with each CLI's seconds from start to end and peak memory.
14. lesion masks segmented on the card (``ops/cvseg.py``,
   ``data.on_device_masks``), in this process, under a temporary directory
   of the run's own:
   a. ``segment_lesion_batch`` at (64, 272, 272, 3), the ViT-B/16@224 fold's
      canvases, and (16, 448, 448, 3), SwinV2-L@384's, drawn as phase 13's
      lesions, under PyTorch's default TF32 flags (cuDNN's on, cuBLAS's
      off), put back after: each stage's median ms and the whole's; the
      component loop's sweeps and its host syncs as
      ``torch.cuda.set_sync_debug_mode`` counts them (8 at most); against
      the same function on the CPU on the same input, the blur's max |Δ|
      (1e-3 at most), the gray levels and thresholds that differ, each
      mask's pixel agreement (0.999 at least); the CPU's gray levels and
      binary image fed to the card's Otsu, morphology and component labels,
      bit for bit; the masks unchanged with cuBLAS's TF32 on as well; the
      blur without its fp32 guard, for information;
   b. ``cli.precompute_masks --image_size 224`` on a seeded layout as phase
      13's (1,856 JPEGs): a 0/255 224² PNG for every JPEG, seconds, img/s,
      peak memory, the mean IoU against the layout's drawn masks (for
      information);
   c. ``cli.train --fold 0`` with phase 13's YAML without the mask
      directory, ``data.on_device_masks: true`` and no TTA: every step 12
      K7, 3 K8 and 2 x (12 K2, 12 K3, 25 K4), every evaluation forward 12
      K1, no plain version called, finite losses, one segmenter call a step
      and one an evaluation forward, and the segmenter's share of a step;
   d. ``cli.predict --isic_dir`` without TTA on c's checkpoint (12 K1 and a
      segmenter call a forward, finite logits), ``cli.predict --tta``
      refused with the TTA step's ``ValueError``, and one
      ``cli.train_federated`` round on the ISIC files (2 clients x 2 local
      steps) with its launches and segmenter calls counted.
15. the old generation (``models/unet.py``, ``models/fusion.py``,
   ``MetadataEmbedding``, the LayerNorm head, JointLoss, named-view TTA): a
   HybridViT of ViT-B/16@224, bf16, the Attention U-Net at its default
   channels, ``metadata.style: embedding`` and ``classifier.layer_norm``,
   seeded perturbed weights:
   a. serving, for each fusion (``attention``, ``concat``,
      ``cross_attention``): 256 seeded 3-channel 272² canvases through
      ``_evaluate`` at batch 64 (the U-Net's BatchNorm statistics first set
      from one batch, as training leaves them), 12 K1 a forward, the logits
      against the plain attention path with phase 3's no-qkv-bias control,
      the seg mask of the two paths bit-equal (or within 1e-3 of its RMS),
      img/s and peak memory;
   b. the JointLoss step (``loss.seg_weight`` 0.3, the mask a target) with
      the attention fusion at macro batch 128 as 2 x 64 of 4-channel uint8
      canvases through the fused train augment: 1 warm-up and 5 timed steps,
      each 12 K7, 3 K8 and 2 x (12 K2, 12 K3, 26 K4); every leaf's gradient
      against the plain attention and LayerNorm backward (phase 8's rounding
      noise allowance) with the no-K3-dbias control; the seg term equal to
      ``bce_dice_loss`` recomputed on the step's own mask and target; a step
      built with ``seg_weight`` 0 gives the U-Net's last conv a gradient of
      exactly 0; then one cross-attention step at 2 x 32 (27 K4 a
      micro-batch) and its peak memory; with ``--trace``, a profile of one
      JointLoss step;
   c. on phase 13's layout: ``cli.train --fold 0`` with JointLoss and the
      two-stage schedule (1 epoch with the backbone frozen, then 1) and the
      8-view TTA test on 4-channel canvases, ``cli.predict --isic_dir
      --tta`` on its best checkpoint, and ``cli.predict --tta`` with six
      named views on 3-channel canvases from a ``.pt`` state dict: launches
      a step and a forward, no plain version called, finite logits (6 views
      a row);
   d. K4 at the old generation's widths, (64, 512) and (64, 768), fp32 and
      bf16, against ``ln_bwd_plain``, timed, with their bounds.
16. what a JAX YAML reached that the port refused before:
   a. ``model.remat``: ViT-B/16@224 at 2 x 64, the JointLoss HybridViT of
      15b at 2 x 64 and SwinV2-L@384 at 8 x 2 and 16 x 1, each built with
      ``model.remat: true`` (drop-path 0.1) and run with its blocks
      rematerialised and not: one macro batch's loss, every gradient and the
      generator's state after it from one state, bit-equal (else each leaf
      within phase 8's limit, the leaves that differ printed); a warm-up and
      3 timed steps each way, ms/step, peak memory (remat's below the peak
      without at each shape; SwinV2-L at 16 x 1 without remat is tried and
      whether it fits is printed), launches a step (remat runs the forward
      kernel under grad twice: 24 K2 a ViT-B micro-batch, 48 of K5's entry a
      SwinV2-L one, and the blocks' LayerNorm forwards twice; K3, K4, K6,
      K7, K8 as without); serving the remat ViT-B launches 12 K1 and 25
      LayerNorm forwards a forward and no K2;
   b. the plain attention options on the weights of ``auto``: ViT-B with
      ``attention_impl: xla``, SwinV2-L with ``packed`` and ``xla``, one
      serving batch (256, 32) and one training step after a warm-up each: no
      attention kernel launched (K4 and the LayerNorm forward as on the
      kernel path), the logits
      within the model's serving gate of ``auto``'s, the step's loss too;
      img/s and peak memory beside ``auto``'s, whose launches are held as
      before;
   c. ``python -m fedvit_torch.cli.verify --device cuda`` in a process of
      its own: exit 0, 14 PASS, no FAIL;
   d. ``cli.train --fold 0 --profile DIR`` on phase 13's layout and YAML:
      one trace of optimizer steps 2-4, naming the port's K2, K3, K4, K7 and
      K8; its seconds beside phase 13c's run without ``--profile``.
17. data parallelism and the federated meshes on two ranks that share the
   card (processes of their own, a gloo group joined through a file; the
   one-process references first, on this process):
   a. the data-parallel SwinV2-L@384 bf16 step (the model's default drop
      path, metadata and its BatchNorm, MixUp/CutMix) at macro batch 16 as
      2 x 8 rows against 16 x 1 on one process: the loss and every leaf's
      gradient within phase 8's limits, the control without the gradient
      all-reduce failing them, the ranks bit-equal after 2 steps, launches
      a rank (24 K5 entry, 24 K6, 53 K4 a step), peak and ms/step a rank;
   b. phase 13's ``cli.train --fold 0`` with ``training.data_parallel`` (1
      epoch) on both ranks against one process: exit 0, the validation
      loss and the test logits within their limits, rank 1 writing no
      checkpoint and printing nothing, the parameters after each epoch
      bit-equal, launches a rank;
   c. a FedAvg round of ViT-B/16@224 (4 clients x 4 local steps of 32) on a
      client mesh of the two ranks against one process: each client's
      leaves bit-equal, the global leaves within fp32 summation order, the
      control where rank 1 drops its clients' sum failing, launches a rank;
   d. the fp32 round of one client, one local step of 32, on a 1 x 2
      client x data mesh against the 1-D round: JAX's contract (the loss
      within 1e-4 (1 + |loss|), the parameters within 3 lr steps);
   e. ``torch.distributed.is_nccl_available()`` and one NCCL all-reduce at
      world 1 on the card.
   No time of phase 17 measures scaling: two ranks halve one card and gloo
   stages every collective through the host.
18. EVA-02-L/14@448 (``models/eva.py``), in this process:
   a. the rotary kernel (``csrc/rotary.cu``, counted as "RoPE" in every
      gate) on q and k by +θ and −θ against ``rotate_plain``, bit for bit:
      small fp32 and bf16 cases, 3 heads, a batch of 9 rows, then the cell's
      micro-batch, (32, 1025, 1024) bf16 in 16 heads, timed beside its byte
      bound and the plain version; under grad one launch forward and one
      back, the gradient the output's turned by −θ;
   b. the ragged LayerNorm forward and K4's ragged pass (rows off 16 bytes
      or over D 2048) against their plain versions at small and odd shapes
      in each dtype pair, each launch counted by ``ragged_launches``, then
      timed at the SwiGLU norm's (32 x 1,025, 2,730) bf16;
   c. K9's three entries against their plain versions at the cell's
      (32, 1025, 1024) bf16, 16 heads, timed;
   d. the step of 8b on EVA-02-L at macro batch 64 as 2 x 32: 1 warm-up
      step then 5 timed ones, img/s and peak memory, per micro-batch 24 of
      K9's log-sum-exp entry, 24 K9 backwards, 48 RoPE, 73 LayerNorm
      forwards and 73 K4 (24 of each ragged), none of any other kernel;
   with ``--trace``, a profile of one EVA-02-L training step.
   Its gradients are held to the plain reference by the benchmark's
   ``eva02l448-train-4x32`` cell, not here.

Any failure raises and exits non-zero. The second-to-last line is a JSON
object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
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
# K4's launches a SwinV2-L micro-batch at each stage's width D = 192 * 2^s:
# two norms a block, the patch norm at stage 0, the merging norm into each
# later stage (at its width) and the final norm at stage 3
SWIN_NORMS = (1 + 2 * 2, 1 + 2 * 2, 1 + 2 * 18, 1 + 2 * 2 + 1)
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


def k1_atol_bf16(vmax: float) -> float:
    """K1_ATOL_BF16's rule, one bf16 ulp of the largest |v|, on inputs whose
    |v| may pass 8 (a model's own activations): 2^(⌊log2 max|v|⌋ − 7), not
    below K1_ATOL_BF16."""
    if not vmax > 0:
        return K1_ATOL_BF16
    return max(K1_ATOL_BF16, 2.0 ** (math.floor(math.log2(vmax)) - 7))
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
# bf16, four bf16 ulps of the largest value — autograd of the plain forward
# rounds P, dP and dS to bf16 at each cast of its forward, the tensor-core
# kernel (as the TPU kernel) rounds P and dS before their products and keeps
# dP fp32.
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
# The LayerNorm forward kernel against layer_norm_plain: the same roundings
# in the same order but for the fp32 sums of x and x² (another order), each
# output rounded once. fp32 output: max |difference| over max |value| (or 1);
# bf16 output: one bf16 ulp of the larger of the two values, or that share
# of the largest value at elements near zero (fp32 noise, where an ulp is
# smaller than it).
LN_FWD_TOL = 1e-6
# The forward kernel at the cells' shapes, bf16 to bf16, (rows, D): a
# SwinV2-L serving batch of 32 at its four widths (stage 3 also at 8
# images) and a ViT-B training micro-batch of 128 (the benchmark's 1 x 128);
# then the HybridViT head's and fusion's fp32 rows, 64 a micro-batch.
LN_FWD_SHAPES = ((294912, 192), (73728, 384), (18432, 768), (4608, 1536),
                 (1152, 1536), (25216, 768))
LN_FWD_OLD_SHAPES = ((64, 512), (64, 768))
# The gradient of each parameter over one macro batch, kernel path against
# the plain attention and LayerNorm backward, as the RMS of the difference
# over the RMS of the plain gradient. As for the logits: bf16 roundings that
# differ by an ulp (K2 rounds P to bf16 before normalising where the plain
# forward rounds it after, K3 rounds P and dS where autograd rounds P, dP
# and dS) pass through 12
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
# order and __expf over up to 576 keys; bf16, both round the softmax weights
# to bf16 before P·V, the plain version after normalising them (the XLA
# branch's cast, as the TPU kernel does) and the tensor-core kernel before
# (its online softmax divides the fp32 sum at the end), so each weight
# differs by a bf16 rounding and the two may round the output one ulp (2^-5
# of outputs below 8) apart. The log-sum-exp (values up to ~40, where an
# fp32 ulp is 4e-6) against torch.logsumexp of the plain fp32 scores.
K5_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -5}
K5_LSE_ATOL = 1e-4
# K5's and K12's forwards are also held to their plain version in the
# tensor-core kernel's order (``window_attention_fwd_plain``: the online
# softmax over 64-key tiles, the unnormalised P rounded before P·V), as the
# RMS of the difference over the RMS of the plain output. bf16 2^-8: the two
# differ by fp32 summation order and ex2.approx against exp, which move an
# occasional weight or output across a bf16 rounding boundary, one ulp (2^-8
# of it) apart. fp32 (the SIMT kernel, whose chunks of 32 keys and fp32 P
# are that order without roundings) 1e-5: summation order and __expf. A wrong
# mask, tail, bias or rounding place moves whole rows by their own size.
FWD_ORDER_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
# The special-function units' rate of ex2 on an H100 SXM: 16 a clock on each
# of 132 SMs at the 1.98 GHz boost clock (NVIDIA's CUDA programming guide,
# throughput of arithmetic instructions, compute capability 9.0). One
# exponential a score: the windowed forwards' other floor beside their bytes.
EX2_PER_S = 16 * 132 * 1.98e9
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
# Every attention backward (K3, K6, and K9's, K10's, K11's and K12's) is
# also held to its plain version in the kernels' own order, which
# is the TPU kernels' (``ops/flash_attention.py``'s ``*_bwd_plain``), on the
# kernel entry's own inputs (the kernel forward's out and lse): P and dS
# rounded to the operands' type before their products, fp32 sums. Each
# gradient as the RMS of the difference over the RMS of the plain value.
# The two differ by fp32 summation order and ex2.approx against exp: fp32
# 1e-4, as the fp32 gates (K12's dscale, a sum that cancels, reads 1.3e-5
# with zero rows, the rest below 4e-6); in bf16 that moves an occasional P,
# dS or stored gradient across a rounding boundary, one bf16 ulp (2^-8 of
# the value) apart, so 2^-9 of the RMS, eight times under the autograd
# gates' 2^-6. K11's plain version recomputes qkv with another GEMM, whose
# fp32 sums in another order put some qkv elements on the other side of a
# bf16 rounding, each moving its row's scores: 2^-8 for its dx, dW and db.
# A wrong mask, tail, bias or rounding place moves whole rows by their own
# size.
ORDER_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -9}
ORDER_RTOL_K11_BF16 = 2.0 ** -8
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


def serving_want(fns, forwards, norms=NORMS) -> dict:
    """The launches of ``forwards`` ViT-B serving forwards, by each kernel of
    ``fns``: 12 K1 and ``norms`` LayerNorm forwards a forward, nothing else."""
    return {k: 0 for k in fns} | {"K1": BLOCKS * forwards,
                                  "LN": norms * forwards}


def expect_launches(name, fa, ln, forwards, norms=NORMS):
    """K1's launches (BLOCKS a forward) and the LayerNorm forward kernel's
    (``norms`` a forward) since both counts were zeroed; returns K1's."""
    got = (fa.flash_attention_qkvb.launches, ln.layer_norm_fwd_cuda.launches)
    want = (BLOCKS * forwards, norms * forwards)
    log(f"[{name}] K1 and LayerNorm forward launches {got} for {forwards} "
        f"forwards (want {want})")
    if got != want:
        raise RuntimeError(f"{name}: {got} K1 and LayerNorm forward launches, "
                           f"want {want}")
    return got[0]


# The names of the ViT attention kernels in a device profile: the demangled
# instances of attention_fwd.cuh's fwd_kernel<D, kBias, kLse> (bf16, the
# tensor-core forward) and attention_bwd.cuh's kernels (bf16
# dkdv_mma_kernel<D, kBias, kSum> and dq_mma_kernel, the tensor-core
# backward; fp32 dkdv_kernel<T, D, kBias, kSum> and dq_kernel), which K1-K3,
# K10 and K11 share, told apart by their flags. K11 adds gemm.cuh's bf16
# products (wgmma_kernel).
K1_NAMES = (r"attn_fwd::fwd_kernel<[^>]*, true, false>",)
K2_NAMES = (r"attn_fwd::fwd_kernel<[^>]*, true, true>",)
K3_NAMES = (r"attn_bwd::delta_kernel<",
            r"attn_bwd::(dkdv|dq)(_mma)?_kernel<[^>]*, true, true>",
            r"column_sum_kernel<")
K10_NAMES = (r"attn_fwd::fwd_kernel<[^>]*, false, false>",)
K10_LSE_NAMES = (r"attn_fwd::fwd_kernel<[^>]*, false, true>",)
K10_BWD_NAMES = (r"attn_bwd::delta_kernel<",
                 r"attn_bwd::(dkdv|dq)(_mma)?_kernel<[^>]*, false, false>")
K11_GEMM_NAMES = (r"gemm::wgmma_kernel<",)
K11_BWD_NAMES = (r"attn_bwd::delta_kernel<",
                 r"attn_bwd::(dkdv|dq)(_mma)?_kernel<[^>]*, false, true>",
                 r"column_sum_kernel<")
K4_NAMES = ("ln_bwd_rows_kernel", "ln_bwd_columns_kernel")
# K5's bf16 forward and its log-sum-exp entry in window_attention.cu:
# window_mma_fwd_kernel<kLse, kCosine, kSlab>, the tensor-core forward
K5_NAMES = (r"window_mma_fwd_kernel<false, false, ",)
K5_LSE_NAMES = (r"window_mma_fwd_kernel<true, false, ",)
# K6's bf16 passes in window_attention_bwd.cu (the fp32 ones are delta_kernel,
# dkdv_kernel, dq_dbias_kernel and group_sum_kernel)
K6_NAMES = ("delta_kernel", "dkdv_mma_kernel", "dq_mma_kernel",
            "dbias_mma_kernel")


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


def check_fwd_order(tag, got, want, dtype) -> float:
    """A windowed forward's output against its kernel-order plain version
    (FWD_ORDER_RTOL), on the card; returns the error."""
    got, want = got.float(), want.float()
    err = float(((got - want).square().mean() / want.square().mean()).sqrt())
    log(f"{tag}: against the kernel-order plain forward, RMS error / RMS "
        f"value {err!r} (tolerance {FWD_ORDER_RTOL[dtype]!r})")
    if not err <= FWD_ORDER_RTOL[dtype]:
        raise RuntimeError(f"{tag}: the forward disagrees with its plain "
                           f"version in the kernel's order")
    return err


def exp_bound_ms(rows, heads, n) -> float:
    """The windowed forward's exponentials, one a score, at EX2_PER_S."""
    return rows * heads * n * n / EX2_PER_S * 1e3


def check_order(tag, names, got, want, dtype, tol=None) -> float:
    """Each of ``got`` against the same gradient of the kernel-order plain
    version (ORDER_RTOL unless ``tol``); returns the largest error."""
    errs = {nm: rel_rms(g.float().cpu().numpy(), w.float().cpu().numpy())
            for nm, g, w in zip(names, got, want)}
    tol = ORDER_RTOL[dtype] if tol is None else tol
    log(f"{tag}: against the plain version in the kernels' order {errs} RMS "
        f"error / RMS value (tolerance {tol!r})")
    if not all(e <= tol for e in errs.values()):
        raise RuntimeError(f"{tag}: disagrees with the plain version in the "
                           f"kernels' order")
    return max(errs.values())


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
    o, lse = fa.qkvb_attention_lse_cuda(qkv, bias, heads)
    rec = {"max_abs_err": err, "order_err": check_order(
        f"[k3] qkv {tuple(qkv.shape)} {short(dtype)}", ("dqkv", "dbias"),
        (dqkv, dbias), fa.qkvb_attention_bwd_plain(qkv, bias, o, dout, lse, heads),
        dtype)}
    if timed:
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
        # qkv, dout and the bias read, dqkv and dbias written (the TPU
        # kernel recomputes the softmax: out and lse are no bytes it needs)
        nbytes = ((2 * qkv.numel() + dout.numel() + bias.numel())
                  * qkv.element_size() + dbias.numel() * 4)
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


def ln_fwd_error(got, want) -> tuple:
    """(max |got − want|, whether every element is within the forward's
    tolerance: ``LN_FWD_TOL``)."""
    diff = (got.float() - want.float()).abs()
    scale = max(1.0, float(want.float().abs().max()))
    if got.dtype == torch.float32:
        return float(diff.max()), float(diff.max()) <= LN_FWD_TOL * scale
    big = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
    ok = bool(((diff <= ulp) | (diff <= LN_FWD_TOL * scale)).all())
    return float(diff.max()), ok


def check_ln_fwd(ln, shape, xdt, ydt, timed):
    """The LayerNorm forward kernel through ``layer_norm_fwd`` against
    ``layer_norm_plain``; timed, against its byte bound (x read and y
    written once), the plain forward and ``F.layer_norm`` (weights in x's
    dtype), each on enough copies of its inputs, in turn, to exceed the 50 MB
    L2 cache, as a caller finds it after the kernels before."""
    d = shape[-1]
    x = (seeded(shape, torch.float32, SEED + 40 + d, 2.0) + 0.5).to(xdt)
    w = 1.0 + seeded((d,), torch.float32, SEED + 41 + d, 0.3)
    b = seeded((d,), torch.float32, SEED + 42 + d, 0.2)
    before = ln.layer_norm_fwd_cuda.launches
    got = ln.layer_norm_fwd(x, w, b, 1e-6, ydt)
    again = ln.layer_norm_fwd(x, w, b, 1e-6, ydt)
    torch.cuda.synchronize()
    launched = ln.layer_norm_fwd_cuda.launches - before
    want = ln.layer_norm_plain(x, w, b, 1e-6, ydt)
    err, ok = ln_fwd_error(got, want)
    log(f"[ln-fwd] x {shape} {short(xdt)} -> {short(ydt)}: max_abs_err "
        f"{err!r}, within one bf16 ulp or {LN_FWD_TOL!r} of the largest value: "
        f"{ok}; launches {launched} for 2 calls; the same bits twice "
        f"{torch.equal(got, again)}")
    if not ok or launched != 2 or not torch.equal(got, again) or \
            got.dtype != ydt:
        raise RuntimeError("the LayerNorm forward kernel disagrees with its "
                           "plain version or did not launch once a call")
    rec = {"max_abs_err": err}
    if not timed:
        return rec
    nbytes = x.numel() * (x.element_size() + got.element_size()) + 2 * d * 4
    copies = max(1, math.ceil(100e6 / nbytes))
    xs = [x.clone() for _ in range(copies)]

    def cycling(fn):
        it = itertools.cycle(xs)
        return lambda: fn(next(it))

    rec["ms"] = cuda_ms(cycling(lambda xi: ln.layer_norm_fwd(xi, w, b, 1e-6,
                                                             ydt)))
    rec["plain_ms"] = cuda_ms(cycling(lambda xi: ln.layer_norm_plain(
        xi, w, b, 1e-6, ydt)))
    if xdt == ydt:
        wl, bl = w.to(xdt), b.to(xdt)
        rec["library_ms"] = cuda_ms(cycling(
            lambda xi: torch.nn.functional.layer_norm(xi, (d,), wl, bl, 1e-6)))
    # per element: the two sums 3, (x − mu) r g + b 4, the cast 1
    rec.update(bound(nbytes, 8.0 * x.numel(), torch.float32))
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    log(f"[ln-fwd] x {shape} {short(xdt)} -> {short(ydt)}: kernel "
        f"{rec['ms']!r} ms, {100 * rec['share_of_bound']!r}% of its bound "
        f"{rec['bound_ms']!r} ms by {rec['bound_by']} ({nbytes} B); plain "
        f"{rec['plain_ms']!r} ms; F.layer_norm {rec.get('library_ms')!r} ms; "
        f"{copies} copies of x in turn")
    return rec


def ln_fwd_phase(ln) -> dict:
    """6d: the LayerNorm forward kernel against its plain version in each
    (input, output) dtype pair at small and odd row counts, then timed at the
    cells' shapes (``LN_FWD_SHAPES``) and the HybridViT's fp32 rows."""
    for xdt, ydt in ((torch.float32, torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.float32, torch.bfloat16),
                     (torch.bfloat16, torch.float32)):
        for shape in ((1, 192), (7, 384), (9, 768), (3, 37, 1536), (5, 2048),
                      (65, 8), (33, 64)):
            check_ln_fwd(ln, shape, xdt, ydt, False)
    recs = {f"{rows}x{d}": check_ln_fwd(ln, (rows, d), torch.bfloat16,
                                        torch.bfloat16, True)
            for rows, d in LN_FWD_SHAPES}
    recs |= {f"{rows}x{d} float32": check_ln_fwd(ln, (rows, d), torch.float32,
                                                 torch.float32, True)
             for rows, d in LN_FWD_OLD_SHAPES}
    slow = {k: r for k, r in recs.items() if "library_ms" in r
            and r["ms"] > r["library_ms"]}
    log(f"[ln-fwd] shapes where F.layer_norm is faster: {sorted(slow)}")
    return recs


def counted(fa, ln) -> dict:
    """Every kernel wrapper that counts its launches, by kernel, the
    LayerNorm forward kernel as "LN" and the rotary kernel as "RoPE" (the
    attention kernels only when ``ln`` is None)."""
    from fedvit_torch.ops import rotary
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
    return fns if ln is None else fns | {"K4": ln.layer_norm_bwd_cuda,
                                         "LN": ln.layer_norm_fwd_cuda,
                                         "RoPE": rotary.rotary_qk_cuda}


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
                   attention_impl="auto", remat=False, n_batches=1 + TIMED_STEPS):
    """The current-generation recipe on ``backbone``: (cfg, model, state,
    step, ``n_batches`` macro batches)."""
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
                          attention_impl=attention_impl, remat=remat),
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
    batches = training_batches(cfg, n_batches, micro * accum)
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
                  noisy=lambda name: True, zero_grad=ZERO_GRAD):
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
    are left out, the ZERO_GRAD ones required among them. ``zero_grad``
    names the leaves of the model at hand that take ZERO_GRAD's place."""
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
        if not set(zero_grad) <= set(left_out):
            raise RuntimeError(f"a bias before a training-mode BatchNorm is not "
                               f"all noise: {({n: noise[n] for n in zero_grad})}")
    else:
        rms = {n: float(g.square().mean().sqrt()) for n, g in plain.items()}
        median = float(np.median(list(rms.values())))
        left_out = {n: r for n, r in rms.items() if r <= NOISE_SHARE * median}
        log(f"[{tag}] leaves with a noise-sized plain gradient (RMS <= "
            f"{NOISE_SHARE!r} x the median leaf's {median!r}), left out of the "
            f"check: RMS gradient {left_out}; the smallest leaves kept: "
            f"{sorted((r, n) for n, r in rms.items() if n not in left_out)[:3]}")
        if not set(zero_grad) <= set(left_out):
            raise RuntimeError(f"a bias before a training-mode BatchNorm has "
                               f"more than a noise-sized gradient: "
                               f"{({n: rms[n] for n in zero_grad})}")
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
        "K4": TIMED_STEPS * ACCUM * NORMS, "LN": TIMED_STEPS * ACCUM * NORMS}
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
    order = check_fwd_order(f"[k5] {shape}", out, fa.window_attention_fwd_plain(
        q, k, v, bias, mask, heads)[0], dtype)
    rec = {"shape": {"W0": w0, "B": b, "N": n, "H": heads, "d": 32},
           "max_abs_err": err, "order_err": order}
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
        rec["exp_bound_ms"] = exp_bound_ms(rows, heads, n)
        log(f"[k5] kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r} ms, sdpa "
            f"{rec['library_ms']!r} ms (bias + mask as attn_mask), bound "
            f"{rec['bound_ms']!r} ms by {rec['bound_by']} ({nbytes} B, "
            f"{flops:.4g} flop), exponentials {rec['exp_bound_ms']!r} ms; "
            f"{rec['ms'] / rec['library_ms']!r}x sdpa")
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
        want = {k: 0 for k in got} | {"K5": blocks * forwards,
                                      "LN": sum(SWIN_NORMS) * forwards}
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
                      kernel=("K5", K5_NAMES), tag="-swin")
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
    _, lse, o32 = fa.window_attention_lse_cuda(q, k, v, bias, mask, heads)
    rec = {"shape": {"W0": w0, "B": b, "N": n, "H": heads, "d": 32},
           "max_abs_err": err, "order_err": check_order(
               f"[k6] {shape}", names, got, fa.window_attention_bwd_plain(
                   q, k, v, bias, mask, o32, dout, lse, heads), dtype)}
    if not timed:
        return rec, None
    rows = w0 * b
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
    # q, k, v, dout, bias and mask read, dq, dk, dv and dbias written (the
    # TPU kernel recomputes the softmax: out32 and lse are no bytes it needs)
    nbytes = 7 * q.numel() * q.element_size() + extra + bias.numel() * 4
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
    # q, k, v, bias and mask read, out and lse written (the TPU's
    # _wflat_fwd_stats_kernel writes its row statistics too; out32 is the
    # port's own leftover for K6)
    fwd.update(bound(4 * q.numel() * q.element_size() + extra
                     + lse.numel() * 4,
                     4.0 * rows * heads * n * n * 32, dtype))
    fwd["exp_bound_ms"] = exp_bound_ms(rows, heads, n)
    fwd["order_err"] = check_fwd_order(
        f"[k5-lse] {shape}", o32, fa.window_attention_fwd_plain(
            q, k, v, bias, mask, heads)[2], dtype)
    log(f"[k5-lse] same shape: kernel {fwd['ms']!r} ms, plain {fwd['plain_ms']!r}"
        f" ms, sdpa {fwd['library_ms']!r} ms, bound {fwd['bound_ms']!r} ms by "
        f"{fwd['bound_by']}, exponentials {fwd['exp_bound_ms']!r} ms; "
        f"{fwd['ms'] / fwd['library_ms']!r}x sdpa; out max_abs_err "
        f"{fwd['max_abs_err']!r}")
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
                   torch.bfloat16, True) for s in range(len(SWIN_DEPTHS))]
    check_k4(ln, (SWIN_MICRO, tokens // 4 ** 3, 1536), torch.float32, False)
    per_micro = sum(r["ms"] * c for r, c in zip(k4, SWIN_NORMS))
    log(f"[k4] a SwinV2-L@384 micro-batch of {SWIN_MICRO} launches K4 "
        f"{list(SWIN_NORMS)} times at D {[192 * 2 ** s for s in range(4)]}: "
        f"{per_micro!r} ms ({sum(SWIN_NORMS)} launches)")

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
        "K4": micro_batches * norms, "LN": micro_batches * norms}
    state, counts = timed_steps("swin-train", "SwinV2-L@384 bf16 4ch+meta", fa,
                                ln, state, step, batches[1:], want, smi)
    if trace:
        trace_training("profile-swin-train", step, state, batches[2], smi, {
            "K5 log-sum-exp entry": K5_LSE_NAMES,
            "K6": K6_NAMES,
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
    ties = torch.tensor([0.5, -0.5, 1.5, -2.5, extent + 0.5, -extent - 0.5],
                        device="cuda")[:n]
    shift[0, :len(ties)] = ties
    return img, shift, extent


def off_16_bytes(img):
    """A contiguous copy of ``img`` at a storage offset of one float, 4 bytes
    past a 16-byte boundary."""
    view = torch.empty(img.numel() + 1, device=img.device)[1:].view(img.shape)
    view.copy_(img)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def check_k7(rs, shape, axis, seed, timed, offset=False):
    """K7 through the wrapper the augment calls against its plain version:
    bit for bit (with ``offset``, on a copy off 16 bytes); returns its
    record."""
    img, shift, extent = shift_inputs(shape, axis, seed)
    kernel = rs.row_shift if axis == 2 else rs.col_shift
    plain = rs.row_shift_plain if axis == 2 else rs.col_shift_plain
    got = kernel(off_16_bytes(img) if offset else img, shift)
    torch.cuda.synchronize()
    want = plain(img, shift)
    err = float((got - want).abs().max())
    kind = "rows" if axis == 2 else "columns"
    log(f"[k7] {kind} {tuple(shape)}{' off 16 bytes' if offset else ''}: "
        f"bit-equal to the plain version {torch.equal(got, want)}, "
        f"max_abs_err {err!r}")
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
            f"{rec['bound_ms']!r} ms by {rec['bound_by']}; kernel / gather "
            f"{rec['ms'] / rec['library_ms']!r}, bound / kernel "
            f"{rec['bound_ms'] / rec['ms']!r}")
    return rec


def check_k8(ra, shape, seed, timed, spans=False, offset=False):
    """K8 through ``equalize`` against ``equalize_plain``: bit for bit, with
    one constant channel (step 0, passed through) and one of a single value
    but for six pixels; with ``spans`` instead, a run of one bin through the
    first ⌈P/16⌉ pixels of sample 0, channel 0, and the last sample's last
    channel zero but for its last P − 15⌈P/16⌉ pixels (a cluster has at most
    16 blocks: these lie in its first and its last block's span); with
    ``offset``, on a copy off 16 bytes."""
    b, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand(shape, device="cuda", generator=g)
    if spans:
        p = h * w
        edge = -(-p // 16)
        flat = img.view(b, p, c)
        flat[0, :edge, 0] = 0.5
        flat[-1, :, -1] = 0.0
        flat[-1, 15 * edge:, -1] = 0.7
    else:
        img[0, ..., 0] = 0.5
        if b > 1 or c > 1:
            near = (b - 1, min(1, c - 1)) if b > 1 else (0, 1)
            img[near[0], ..., near[1]] = 0.25
            img[near[0], :2, :3, near[1]] = 0.9
    got = ra.equalize(off_16_bytes(img) if offset else img)
    torch.cuda.synchronize()
    want = ra.equalize_plain(img)
    err = float((got - want).abs().max())
    passed = spans or torch.equal(got[0, ..., 0], img[0, ..., 0])
    log(f"[k8] {tuple(shape)}{' spans' if spans else ''}"
        f"{' off 16 bytes' if offset else ''}: bit-equal to the plain version "
        f"{torch.equal(got, want)}, max_abs_err {err!r}"
        + ("" if spans else f"; constant channel passed through: {passed}"))
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
        log(f"[k8] kernel {rec['ms']!r} ms ({nbytes / rec['ms'] / 1e9!r} "
            f"TB/s), plain {rec['plain_ms']!r} ms, bound {rec['bound_ms']!r} "
            f"ms by {rec['bound_by']} ({nbytes} B); bound / kernel "
            f"{rec['bound_ms'] / rec['ms']!r}")
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
                                      "K3": ACCUM * BLOCKS, "K4": ACCUM * NORMS,
                                      "LN": ACCUM * NORMS}
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
    # extent, H ≠ W; an odd W at C = 4, C = 3 rows off 16 bytes, rows shorter
    # than 4 floats, C of 2 and 5, images off 16 bytes), then the four
    # shapes of the two configurations
    for axis in (2, 1):
        for c in (1, 3, 4):
            check_k7(rs, (3, 14, 19, c), axis, SEED + c, timed=False)
        for shape in ((2, 9, 31, 4), (3, 11, 25, 3), (2, 6, 3, 1),
                      (2, 5, 3, 2), (2, 7, 9, 5)):
            check_k7(rs, shape, axis, SEED + shape[1], timed=False)
        for shape in ((2, 37, 29, 4), (3, 11, 25, 3), (4, 250, 250, 3)):
            check_k7(rs, shape, axis, SEED, timed=False, offset=True)
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
    # 9b. K8: small cases, C of 1, 2, 4, 5, B = 1, spans that do not divide
    # the sample, spans counted tile by tile and read twice, images off 16
    # bytes; then the two configurations' shapes
    check_k8(ra, (2, 24, 20, 3), SEED, timed=False)
    for shape in ((2, 40, 33, 1), (3, 50, 47, 4), (2, 33, 35, 2),
                  (2, 30, 31, 5), (1, 97, 89, 3), (2, 97, 89, 3),
                  (1, 1000, 1000, 3), (1, 2000, 2000, 1)):
        for spans in (False, True):
            check_k8(ra, shape, SEED + shape[1], timed=False, spans=spans)
    for shape in ((2, 37, 41, 3), (1, 97, 89, 4)):
        check_k8(ra, shape, SEED, timed=False, offset=True)
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
        o, lse = fa.qkv_attention_lse_cuda(qkv, heads)
        rec = recs["bwd"] = {"max_abs_err": err, "order_err": check_order(
            f"{tag}: backward", ("dqkv",), (dqkv,),
            fa.qkvb_attention_bwd_plain(qkv, None, o, dout, lse, heads)[:1],
            dtype)}
        if timed:
            rec["ms"] = cuda_ms(
                lambda: fa.qkv_attention_bwd_cuda(qkv, o, dout, lse, heads))
            rec["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_p, qkv_p, dout, retain_graph=True))
            qkv_s = qkv.clone().requires_grad_()
            out_s = sdpa(*qkv_views(qkv_s, heads))
            dout_s = dout.view(b, n, heads, d).transpose(1, 2)
            rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_s, qkv_s, dout_s, retain_graph=True))
            # qkv and dout read, dqkv written (out and lse are the port's
            # own leftovers, no bytes the function needs)
            nbytes = (2 * qkv.numel() + dout.numel()) * qkv.element_size()
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
        rec = recs["bwd"] = {
            "max_abs_err": err, "dw_rel_err": rels[1], "db_rel_err": rels[2],
            "order_err": check_order(
                f"{tag}: backward", ("dx", "dW", "db"), again[0],
                fa.xqkv_attention_bwd_plain(x, w, bias, o, dout, lse, heads),
                dtype, None if dtype == torch.float32 else ORDER_RTOL_K11_BF16)}
        if timed:
            rec["ms"] = cuda_ms(
                lambda: fa.xqkv_attention_bwd_cuda(x, w, bias, o, dout, lse, heads))
            rec["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_p, plain_leaves, dout, retain_graph=True))
            lib_leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
            out_l = linear_sdpa(*lib_leaves, heads)
            rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out_l, lib_leaves, dout, retain_graph=True))
            # x, w, b and dout read, dx, dw and db written (out and lse are
            # the port's own leftovers, no bytes the function needs)
            nbytes = 2 * io - b * n * e * x.element_size()
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
        f"{kernel}_bwd": micro_batches * BLOCKS, "K4": micro_batches * NORMS,
        "LN": micro_batches * NORMS}
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
        o, lse = fa.flat_attention_lse_cuda(q, k, v, heads)
        rec = recs["bwd"] = {"max_abs_err": err, "order_err": check_order(
            f"{tag}: backward", ("dq", "dk", "dv"), got,
            fa.flat_attention_bwd_plain(q, k, v, o, dout, lse, heads), dtype)}
        if timed:
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
        rec = recs["fwd"] = {"max_abs_err": max_err, "order_err": check_fwd_order(
            f"{tag}: forward", out, fa.window_attention_fwd_plain(
                q, k, v, bias, mask, heads, scale)[0], dtype)}
        if timed:
            rec["ms"] = cuda_ms(lambda: fa.flash_attention_cosine_flat(
                q, k, v, scale, bias, mask, heads), iters=8, warmup=2)
            rec["plain_ms"] = cuda_ms(lambda: plain(q, k, v, scale, bias),
                                      iters=4, warmup=1)
            rec["library_ms"] = cuda_ms(lambda: cosine_library(
                q, k, v, scale, attn_mask, heads), iters=8, warmup=2)
            rec.update(bound(io, flops, dtype))
            rec["exp_bound_ms"] = exp_bound_ms(rows, heads, n)
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
            (out.float() - want.float()).abs().max()), "lse_max_abs_err": lse_err,
            "order_err": check_fwd_order(
                f"{tag}: log-sum-exp entry's out32", out32,
                fa.window_attention_fwd_plain(q, k, v, bias, mask, heads,
                                              scale)[2], dtype)}
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
            rec["exp_bound_ms"] = exp_bound_ms(rows, heads, n)
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
            f"{nm}_err": x for nm, x in errs.items()},
            "order_err": check_order(
                f"{tag}: backward", names, again[0],
                fa.cosine_window_attention_bwd_plain(
                    q, k, v, scale, bias, mask, o32, dout, lse, heads), dtype)}
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


# ---------------------------------------------------------------------------
# 12. Federated training (fed/server.py::train_federated) on ViT-B/16@224
# ---------------------------------------------------------------------------

# Phase 12: the synthetic fixture (data/synthetic.py) at 224² with its mask
# as a 4th channel: 1,792 training images (resident on the card: 1.44 GB of
# float32) and 256 evaluated each round at batch 64; 4 clients by Dirichlet
# α 0.5, all 4 each round, 8 local steps of 32 images, 3 rounds (the first
# warms up).
FED_IMAGES, FED_EVAL, FED_EVAL_BATCH = 2048, 256, 64
FED_CLIENTS, FED_STEPS, FED_BATCH, FED_ROUNDS = 4, 8, 32, 3
FED_WORKDIR = Path(__file__).resolve().parent / "build" / "chip_smoke_fed"
# 12b: each global leaf after a round against θ + η(Σ wᵢθᵢ − θ) computed in
# fp64 from the clients' own fp32 leaves, elementwise, as a share of
# |θ| + Σ wᵢ|θᵢ|: the fp32 round rounds each of the 4 products and 4 sums,
# the difference, the product by η and the step once, each within 2^-24 of
# the terms it combines, so the 11 roundings stay below 2^-20.
AGG_RTOL = 2.0 ** -20


def fed_config(rounds):
    """The phase-6 recipe with federated rounds: local batch 32, no
    accumulation, the train augment in every local step."""
    import dataclasses

    from fedvit_torch.core.config import FederatedConfig
    cfg = fold_config(epochs=1)
    return cfg.replace(
        training=dataclasses.replace(cfg.training, batch_size=FED_BATCH,
                                     gradient_accumulation_steps=1),
        federated=FederatedConfig(
            enabled=True, num_clients=FED_CLIENTS, rounds=rounds,
            local_steps=FED_STEPS, partition="dirichlet",
            dirichlet_alpha=0.5, augment=True))


def fed_data():
    """(train, eval) numpy dicts of the synthetic fixture with its mask as
    the 4th channel: float32 images in [0, 1] at 224²."""
    from fedvit_torch.data.synthetic import make_synthetic_dataset
    data = make_synthetic_dataset(n=FED_IMAGES, image_size=224, seed=SEED)
    data["image"] = np.concatenate([data.pop("image"), data["mask"]], -1)
    return ({k: v[FED_EVAL:] for k, v in data.items()},
            {k: v[:FED_EVAL] for k, v in data.items()})


def fed_model(cfg):
    from fedvit_torch.models import build_model
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    perturb(model, SEED)
    return model


@contextlib.contextmanager
def fed_instruments(fa, ln, on_round_end=None):
    """Instruments of a ``train_federated`` run, all by rebinding, in a dict:
    at each round's end (its checkpoint) the launches of the phase's kernels
    so far ("counts"), the checkpoint's synchronised seconds and bytes
    ("saves") and the numpy state it saved ("np_states"); the aggregation's
    device time by round (CUDA events, no synchronise: "agg"); the
    evaluation's synchronised img/s ("evals"); the drawn (steps, batch)
    indices, 4 a round in round order ("drawn"); the number of local
    trainings ("local_trainings"), the first one's first gathered batch
    ("batch"); and the calls of the plain versions of the
    phase's kernels ("plain"). ``on_round_end(rnd)`` runs after each
    checkpoint. Every count starts at 0."""
    from fedvit_torch.fed import fedavg, server
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    from fedvit_torch.train import checkpoint
    from fedvit_torch.train.ema import shadow_weights

    fns = counted(fa, ln) | {"K7": rs.shift_cuda, "K8": ra.equalize_cuda}
    rec = {"counts": [], "saves": [], "np_states": [], "agg": {}, "evals": [],
           "drawn": [], "local_trainings": 0, "round": 1}
    save = checkpoint.save_federated_checkpoint
    draw = server.sample_client_indices
    make_local_train = fedavg.make_local_train

    def timed_events(fn):
        def wrapped(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            rec["agg"].setdefault(rec["round"], []).append((start, end))
        return wrapped

    @contextlib.contextmanager
    def timed_eval(model, shadow):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with shadow_weights(model, shadow) as m:
            yield m
        torch.cuda.synchronize()
        rec["evals"].append(FED_EVAL / (time.perf_counter() - t0))

    def timed_save(path, model, ema, rnd, history, np_state, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(path, model, ema, rnd, history, np_state, *args, **kwargs)
        seconds = time.perf_counter() - t0
        rec["saves"].append((seconds, sum(
            f.stat().st_size for f in (Path(path) / "fed_ckpt").iterdir())))
        rec["np_states"].append(np_state)
        rec["counts"].append({k: fn.launches for k, fn in fns.items()})
        if on_round_end is not None:
            on_round_end(rnd)
        rec["round"] = rnd + 1

    def recording(*args, **kwargs):
        out = draw(*args, **kwargs)
        rec["drawn"].append(out.copy())
        return out

    def counting_local_train(cfg, loss_fn, *args):
        inner = make_local_train(cfg, loss_fn, *args)

        def local_train(model, batches, *args, **kwargs):
            rec["local_trainings"] += 1
            if "batch" not in rec:           # the run's first local batch
                rec["batch"] = {k: v[0].clone() for k, v in batches.items()}
            return inner(model, batches, *args, **kwargs)
        return local_train

    with contextlib.ExitStack() as stack:
        rec["plain"] = stack.enter_context(plain_calls(fa, ln))
        for module, name, fn in (
                (fedavg, "accumulate", timed_events(fedavg.accumulate)),
                (fedavg, "server_step", timed_events(fedavg.server_step)),
                (fedavg, "make_local_train", counting_local_train),
                (server, "shadow_weights", timed_eval),
                (server, "sample_client_indices", recording),
                (checkpoint, "save_federated_checkpoint", timed_save)):
            stack.enter_context(rebound(module, name, fn))
        torch.cuda.synchronize()
        for fn in fns.values():
            fn.launches = 0
        yield rec


def plain_versions(fa, ln):
    """(module, name) of the plain versions of the phase's kernels: K1-K3's
    attention and K3's kernel-order backward, the LayerNorm forward, K4,
    K7's two shifts, K8."""
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    return ((fa, "attention_from_qkvb"), (fa, "qkvb_attention_bwd_plain"),
            (ln, "layer_norm_plain"), (ln, "ln_bwd_plain"),
            (rs, "row_shift_plain"), (rs, "col_shift_plain"),
            (ra, "equalize_plain"))


@contextlib.contextmanager
def plain_calls(fa, ln):
    """Counts the calls of the plain versions of K1-K4, K7 and K8 inside the
    block, by name, in a dict."""
    calls = {name: 0 for _, name in plain_versions(fa, ln)}
    with contextlib.ExitStack() as stack:
        for module, name in plain_versions(fa, ln):
            def counting(*args, _fn=getattr(module, name), _name=name,
                         **kwargs):
                calls[_name] += 1
                return _fn(*args, **kwargs)
            stack.enter_context(rebound(module, name, counting))
        yield calls


def per_round(counts):
    """Launches in each round from the running counts at each round's end."""
    out, prev = [], {k: 0 for k in counts[0]}
    for c in counts:
        out.append({k: c[k] - prev[k] for k in c if c[k] - prev[k]})
        prev = c
    return out


def fed_want():
    """Launches a round: 4 × 8 local steps of (12 K2, 12 K3, 25 K4, 25
    LayerNorm forwards, 12 K7, 3 K8) and (12 K1, 25 LayerNorm forwards) a
    forward of the evaluation (4 batches of 64)."""
    steps = FED_CLIENTS * FED_STEPS
    forwards = FED_EVAL // FED_EVAL_BATCH
    return {"K1": BLOCKS * forwards, "K2": steps * BLOCKS,
            "K3": steps * BLOCKS, "K4": steps * NORMS,
            "LN": (steps + forwards) * NORMS, "K7": steps * 12,
            "K8": steps * 3}


def host64(model):
    """The federated leaves of ``model`` as fp64 CPU tensors."""
    from fedvit_torch.fed.fedavg import federated_leaves
    return {n: t.detach().double().cpu()
            for n, t in federated_leaves(model).items()}


def check_aggregation(cfg, train, model, captured):
    """12b: the round's global leaves against θ + η(Σ wᵢθᵢ − θ) in fp64 from
    the clients' own leaves, and the control with equal weights."""
    from fedvit_torch.fed.partition import client_weights, partition

    weights = client_weights(partition("dirichlet", train["label"],
                                       FED_CLIENTS, alpha=0.5, seed=cfg.seed))
    w = (weights / weights.sum()).astype(np.float64)     # all 4 take part
    eta = cfg.federated.server_lr
    got = host64(model)
    worst = control = 0.0
    for n, theta in captured["global"].items():
        clients = [c[n] for c in captured["clients"]]
        scale = theta.abs() + sum(wi * c.abs() for wi, c in zip(w, clients))
        want = theta + eta * (sum(wi * c for wi, c in zip(w, clients)) - theta)
        equal = theta + eta * (sum(clients) / len(clients) - theta)
        worst = max(worst, float(((got[n] - want).abs() / (scale + 1e-30)).max()))
        control = max(control, float(((got[n] - equal).abs()
                                      / (scale + 1e-30)).max()))
    log(f"[fed] 12b aggregation over {len(got)} leaves (parameters and "
        f"BatchNorm statistics), weights {w.round(4).tolist()}: largest "
        f"|got − θ − η(Σwᵢθᵢ − θ)| / (|θ| + Σwᵢ|θᵢ|) {worst!r} (limit "
        f"{AGG_RTOL!r}); control, equal weights: {control!r} (must exceed)")
    if not worst <= AGG_RTOL:
        raise RuntimeError("the federated round does not aggregate as "
                           "θ + η(Σ wᵢθᵢ − θ)")
    if not control > AGG_RTOL:
        raise RuntimeError("the aggregation check cannot tell equal weights "
                           "from the split's")
    return worst


def check_fresh_optimizer(cfg, model, step):
    """12c: client 0's first local step of round 2 against one step of a
    freshly made local optimizer from the same parameters and gradients."""
    from fedvit_torch.fed import fedavg

    state = step["state"]
    fresh_state = state["count"] == 0 and all(
        not t.any() for part in ("mu", "nu") for t in state[part].values())
    scratch = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in scratch.named_parameters():
            p.copy_(step["params"][n])
    tx = fedavg.build_local_optimizer(cfg, scratch)
    tx.step(scratch, step["grads"], tx.init(scratch))
    differ = [n for n, p in scratch.named_parameters()
              if not torch.equal(p, step["after"][n])]
    log(f"[fed] 12c client 0's first local step of round 2: optimizer state "
        f"at count 0 with zero moments: {fresh_state}; parameters bit-equal "
        f"to one step of a fresh local optimizer: {not differ} {differ[:3]}")
    if not fresh_state or differ:
        raise RuntimeError("a client's local optimizer was not fresh")


def check_augment_batch(tag, augment, batch, seed):
    """The train augment on ``batch`` (a gathered local batch) through K7 and
    K8, bit-equal to the same call through the plain shifts and equalize from
    the same generator state; then K7 and K8 against their plain versions,
    timed, at each shape that call gave them (K8 also with ``spans``).
    Returns (K7's records, K8's records), one a shape."""
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs

    seen = []

    def recording(module, name, kind):
        fn = getattr(module, name)

        def wrapped(img, *args):
            seen.append((kind, tuple(img.shape)))
            return fn(img, *args)
        return rebound(module, name, wrapped)

    g = torch.Generator(device="cuda").manual_seed(seed)
    start = g.get_state()
    with recording(rs, "row_shift", "rows"), \
            recording(rs, "col_shift", "columns"), \
            recording(ra, "equalize", "equalize"):
        out = augment(batch, g)["image"]
    g.set_state(start)
    with augment_kernels_replaced_by_plain(rs, ra):
        plain = augment(batch, g)["image"]
    shifts = [s for s in seen if s[0] != "equalize"]
    equalized = [s for s in seen if s[0] == "equalize"]
    log(f"{tag} train augment of a gathered local batch "
        f"{tuple(batch['image'].shape)} {batch['image'].dtype} → "
        f"{tuple(out.shape)}: K7 at {shifts}, K8 at {equalized}; bit-equal to "
        f"the plain shifts and equalize from the same generator state: "
        f"{torch.equal(out, plain)}")
    if len(shifts) != 12 or len(equalized) != 3 or not torch.equal(out, plain):
        raise RuntimeError(f"{tag}: the train augment did not call K7 and K8 "
                           f"as it should or disagrees with the plain path")
    del out, plain
    k7 = [check_k7(rs, shape, 2 if kind == "rows" else 1, seed * 10 + i,
                   timed=True)
          for i, (kind, shape) in enumerate(sorted(set(shifts)))]
    k8 = [check_k8(ra, shape, seed * 10 + 10 + i, timed=True)
          for i, (_, shape) in enumerate(sorted(set(equalized)))]
    for _, shape in sorted(set(equalized)):
        check_k8(ra, shape, seed * 10 + 20, False, spans=True)
    return k7, k8


def check_fed_shapes(fa, ln, attention_from_qkvb, cfg, train, ev, batch):
    """12a, at the shapes this path gives the kernels: K1 at the evaluation
    batch, K2-K4 at the local batch, K7 and K8 at those that the train
    augment takes from ``batch`` (the run's first gathered local batch:
    float 224² images, not uint8 canvases), each against its plain version;
    then that batch's train augment bit-equal to the same call through the
    plain shifts and equalize, one local step's gradients against the plain
    path (6c's gate) and the evaluation's logits against the plain attention
    (phase 3's gate). Returns each kernel's record (K7 and K8: one a shape)."""
    import dataclasses

    from fedvit_torch.data.pipeline import make_device_augment
    from fedvit_torch.data.sampling import compute_class_weights
    from fedvit_torch.eval.serve import make_eval_step
    from fedvit_torch.fed import fedavg
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step

    heads, e = 12, 768
    n = (cfg.model.image_size // 16) ** 2 + 1
    bf16 = torch.bfloat16
    recs = {"K1": check_k1(fa, attention_from_qkvb, FED_EVAL_BATCH, n, heads,
                           e // heads, bf16, K1_ATOL_BF16, timed=True),
            "K2": check_k2(fa, attention_from_qkvb, FED_BATCH, n, heads, bf16,
                           True),
            "K3": check_k3(fa, attention_from_qkvb, FED_BATCH, n, heads, bf16,
                           True),
            "K4": check_k4(ln, (FED_BATCH, n, e), bf16, True)}
    for key, shape in (("K1", [FED_EVAL_BATCH, n, 3 * e]),
                       ("K2", [FED_BATCH, n, 3 * e]),
                       ("K3", [FED_BATCH, n, 3 * e]), ("K4", [FED_BATCH, n, e])):
        recs[key]["shape"] = shape

    # the train augment on the gathered batch: the shapes K7 and K8 see
    augment = make_device_augment(cfg, train=True)
    recs["K7"], recs["K8"] = check_augment_batch("[fed] 12a", augment, batch,
                                                 SEED + 12)

    # one local step as a client takes it, kernels against the plain path
    model = fed_model(cfg)
    class_w = None
    if cfg.loss.class_weights:
        class_w = torch.from_numpy(compute_class_weights(
            train["label"], cfg.num_classes)).cuda()
    local = dataclasses.replace(cfg.training, gradient_accumulation_steps=1)
    step = make_train_step(cfg.replace(training=local),
                           build_loss(cfg, class_w), augment=augment)
    tx = fedavg.build_local_optimizer(cfg, model)
    generator, np_rng = fedavg.client_generators(cfg.seed, 1, 0, "cuda")
    state = TrainState(step=0, model=model, tx=tx, opt_state=tx.init(model),
                       ema=None, generator=generator, np_rng=np_rng)
    got = grads_by_path(model, state, step, batch, {
        "kernel": (),
        "plain": (attention_replaced_by(attention_from_qkvb),
                  layer_norm_backward_replaced_by(ln.ln_bwd_plain),
                  augment_kernels_replaced_by_plain(rs, ra)),
        "control": (attention_replaced_by(k3_without_dbias(fa)),)})
    compare_grads("fed-step", got, GRAD_RTOL_BF16,
                  [k for k in got["plain"][0] if k.endswith("attn.qkv.bias")],
                  "K3's dbias zeroed")
    del got

    # the round evaluation's forwards at batch 64, kernel against plain
    eval_step = make_eval_step(model, cfg, augment=make_device_augment(cfg, False))
    ev_dev = {k: torch.from_numpy(v).cuda() for k, v in ev.items() if k != "mask"}

    def logits():
        return torch.cat([eval_step({k: v[s:s + FED_EVAL_BATCH]
                                     for k, v in ev_dev.items()})
                          for s in range(0, FED_EVAL, FED_EVAL_BATCH)]
                         ).float().cpu().numpy()

    kernel = logits()
    with attention_replaced_by(attention_from_qkvb):
        want = logits()
    compare_logits("fed-eval", kernel, want)
    del model, state, ev_dev
    torch.cuda.empty_cache()
    return recs


def fed_cli(smi):
    """12e: the CLI on the JAX defaults (ViT-B/16@224, batch 4, 4 clients)
    over 256 synthetic images, one round, in a process of its own."""
    log_dir = FED_WORKDIR / "cli"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fedvit_torch.cli.train_federated",
         "--synthetic", "256", "--rounds", "1", "--log", str(log_dir)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the federated CLI failed:\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("[fed]"):
            log(f"[fed] 12e cli: {line}")
    history = json.loads((log_dir / "federated_history.json").read_text())
    generations = sorted(p.name for p in (log_dir / "ckpt").iterdir())
    values = [history[0][k] for k in ("loss", "accuracy", "balanced_accuracy",
                                      "macro_f1")] if history else []
    log(f"[fed] 12e `python -m fedvit_torch.cli.train_federated --synthetic 256 "
        f"--rounds 1`: {seconds!r} s in all (process start, data, model, "
        f"round, checkpoint); history {history}; ckpt/ holds {generations} "
        f"({smi})")
    if len(history) != 1 or not all(math.isfinite(v) for v in values) or \
            generations != ["fed_ckpt"]:
        raise RuntimeError("the federated CLI's history or checkpoint is wrong")


def trace_fed(fa, ln, cfg, train, ev, smi):
    """12f: one round broken into stages (each ended by a synchronise), then a
    profile of one round of ``train_federated``."""
    from torch.profiler import ProfilerActivity, profile

    from fedvit_torch.fed import fedavg, server

    stages = {k: 0.0 for k in ("local steps", "aggregation", "EMA")}
    timing = {"on": False, "assemble_ms": []}

    def synced(name, fn):
        def wrapped(*args, **kwargs):
            if not timing["on"]:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapped

    def timed_local(cfg_, loss_fn, *args):
        return synced("local steps", make_local_train(cfg_, loss_fn, *args))

    def host_timed_draw(self):
        t0 = time.perf_counter()
        out = draw(self)
        timing["assemble_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def switch(rnd):
        timing["on"] = rnd == 1            # time round 2, after the warm-up

    make_local_train, draw = fedavg.make_local_train, server.RoundBatches.draw
    with contextlib.ExitStack() as stack:
        rec = stack.enter_context(fed_instruments(fa, ln, on_round_end=switch))
        for module, name, fn in (
                (fedavg, "make_local_train", timed_local),
                (fedavg, "accumulate", synced("aggregation", fedavg.accumulate)),
                (fedavg, "server_step", synced("aggregation",
                                               fedavg.server_step)),
                (server, "ema_update", synced("EMA", server.ema_update)),
                (server.RoundBatches, "draw", host_timed_draw)):
            stack.enter_context(rebound(module, name, fn))
        result = server.train_federated(
            fed_config(2), fed_model(cfg), train, ev, log_fn=lambda s: None,
            workdir=str(FED_WORKDIR / "trace"))
    wall = result.history[1]["round_time_s"] * 1e3
    stages["evaluation"] = FED_EVAL / rec["evals"][1] * 1e3
    stages["checkpoint"] = rec["saves"][1][0] * 1e3
    log(f"[stages-fed] round 2 of 2, each stage ended by a synchronise ({smi}): "
        f"round wall {wall!r} ms (local steps, aggregation, EMA); assemble "
        f"{timing['assemble_ms'][1]!r} ms of host time on the background "
        f"thread, overlapped with round 1")
    for k, ms in stages.items():
        log(f"[stages-fed]   {k:12s} {ms!r} ms ({100 * ms / (wall + stages['evaluation'] + stages['checkpoint']):.1f}%)")

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def profiled(rnd):
        if rnd == 1:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif rnd == 2:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()

    with fed_instruments(fa, ln, on_round_end=profiled):
        server.train_federated(fed_config(2), fed_model(cfg), train, ev,
                               log_fn=lambda s: None,
                               workdir=str(FED_WORKDIR / "trace"))
    events, device_ms = device_events(prof)
    wall_ms = window["wall_ms"]
    log(f"[profile-fed] round 2 of 2 (draws, 32 local steps, aggregation, EMA, "
        f"evaluation, checkpoint): wall {wall_ms!r} ms, device {device_ms!r} ms "
        f"in {sum(e.count for e in events)} kernels and copies, busy "
        f"{100 * device_ms / wall_ms:.1f}% ({smi})")
    for e in events[:20]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile-fed]   {ms!r} ms ({100 * ms / device_ms:.1f}%) "
            f"x{e.count} {e.key[:90]}")
    for k, names in {"K1": K1_NAMES, "K2": K2_NAMES, "K3": K3_NAMES,
                     "K4": K4_NAMES, "K7": ("shift_kernel",),
                     "K8": ("equalize_kernel",)}.items():
        ms = sum(e.self_device_time_total for e in events
                 if in_group(e.key, names)) / 1e3
        log(f"[profile-fed] {k} {ms!r} ms = {100 * ms / device_ms:.1f}% of "
            f"device time")
        if not ms > 0:
            raise RuntimeError(f"[profile-fed]: no device time under {k}'s "
                               f"names {names}")


def fed_phase(fa, ln, smi, trace):
    """Phase 12; returns the launches a round of K1-K4, K7 and K8."""
    import shutil

    from fedvit_torch.fed import fedavg, server
    from fedvit_torch.ops.attention import attention_from_qkvb
    from fedvit_torch.train import checkpoint

    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    train, ev = fed_data()
    log(f"[fed] data: {len(train['label'])} training and {len(ev['label'])} "
        f"evaluation images {train['image'].shape[1:]} float32 in "
        f"{time.perf_counter() - t0!r} s (host)")
    cfg = fed_config(FED_ROUNDS)
    want = fed_want()
    images = FED_CLIENTS * FED_STEPS * FED_BATCH
    shutil.rmtree(FED_WORKDIR, ignore_errors=True)
    try:
        # 12a. the server at full width, 3 rounds
        model = fed_model(cfg)
        caller = {k: v.clone() for k, v in model.state_dict().items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lines = []
        with fed_instruments(fa, ln) as rec:
            t0 = time.perf_counter()
            full = server.train_federated(cfg, model, train, ev,
                                          log_fn=lines.append,
                                          workdir=str(FED_WORKDIR / "a"))
            run_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            agg_ms = [sum(s.elapsed_time(e) for s, e in rec["agg"][r])
                      for r in sorted(rec["agg"])]
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        for line in lines:
            log(line)
        launches = per_round(rec["counts"])
        for h, a, e, (s, b), n in zip(full.history, agg_ms, rec["evals"],
                                      rec["saves"], launches):
            log(f"[fed] round {h['round']}: {h['round_time_s']!r} s = "
                f"{images / h['round_time_s']!r} img/s synchronised "
                f"({FED_CLIENTS} clients x {FED_STEPS} steps x {FED_BATCH}, "
                f"the draws' wait, aggregation and EMA); aggregation {a!r} ms "
                f"of device time; evaluation {e!r} img/s; checkpoint {s!r} s, "
                f"{b} bytes; launches {n}")
        steady = full.history[1:]
        log(f"[fed] rounds 2-3 (round 1 warms up): "
            f"{images * len(steady) / sum(h['round_time_s'] for h in steady)!r}"
            f" img/s; peak {peak_gib!r} GiB; the run {run_s!r} s ({smi})")
        log(f"[fed] launches a round, want {want}; plain versions called "
            f"{rec['plain']}")
        if any(n != want for n in launches) or any(rec["plain"].values()):
            raise RuntimeError("a federated round did not launch the kernels "
                               "as it should")
        if len(full.history) != FED_ROUNDS or not all(
                math.isfinite(h[k]) for h in full.history
                for k in ("loss", "accuracy", "balanced_accuracy", "macro_f1",
                          "auroc")):
            raise RuntimeError("the federated history is not finite")
        moved = [k for k, v in full.model.state_dict().items()
                 if not torch.equal(v, caller[k])]
        untouched = all(torch.equal(v, caller[k])
                        for k, v in model.state_dict().items())
        log(f"[fed] the caller's model unchanged: {untouched}; the result's "
            f"tensors that moved: {len(moved)} of {len(caller)}")
        if not untouched or not moved:
            raise RuntimeError("train_federated changed the caller's model or "
                               "moved nothing")
        del model
        full.model = full.ema_params = None
        torch.cuda.empty_cache()
        shapes = check_fed_shapes(fa, ln, attention_from_qkvb, cfg, train, ev,
                                  rec.pop("batch"))

        # 12b, 12c. the same run cut to 2 rounds, with round 2's clients
        # captured: their leaves before and after local training, and client
        # 0's first local optimizer step
        captured = {"global": None, "clients": [], "step": None}
        make_local_train = fedavg.make_local_train
        build_local_optimizer = fedavg.build_local_optimizer

        def capturing(cfg_, loss_fn, *args):
            inner = make_local_train(cfg_, loss_fn, *args)

            def local_train(m, *args, **kwargs):
                last = two_rec["round"] == 2
                if last and captured["global"] is None:
                    captured["global"] = host64(m)
                loss = inner(m, *args, **kwargs)
                if last:
                    captured["clients"].append(host64(m))
                return loss
            return local_train

        def recording_optimizer(cfg_, m):
            tx = build_local_optimizer(cfg_, m)
            if two_rec["round"] != 2 or captured["step"] is not None:
                return tx
            first = tx.step

            def step(m_, grads, state):
                if captured["step"] is not None:
                    return first(m_, grads, state)
                captured["step"] = {
                    "state": {"count": state["count"],
                              **{part: {n: t.clone() for n, t in
                                        state[part].items()}
                                 for part in ("mu", "nu")}},
                    "params": {n: p.detach().clone()
                               for n, p in m_.named_parameters()},
                    "grads": {n: g.detach().clone() for n, g in grads.items()}}
                norm = first(m_, grads, state)
                captured["step"]["after"] = {
                    n: p.detach().clone() for n, p in m_.named_parameters()}
                return norm
            tx.step = step
            return tx

        with contextlib.ExitStack() as stack:
            two_rec = stack.enter_context(fed_instruments(fa, ln))
            stack.enter_context(rebound(fedavg, "make_local_train", capturing))
            stack.enter_context(rebound(fedavg, "build_local_optimizer",
                                        recording_optimizer))
            two = server.train_federated(
                fed_config(2), fed_model(cfg), train, ev,
                log_fn=lambda s: None, workdir=str(FED_WORKDIR / "b"))
        agg_err = check_aggregation(cfg, train, two.model, captured)
        check_fresh_optimizer(cfg, two.model, captured["step"])
        del captured
        torch.cuda.empty_cache()

        # 12d. resume the 2-round run to round 3
        two_state = two.model.state_dict()
        load = checkpoint.load_federated_checkpoint
        restored = {}

        def checked_load(path, m, ema):
            meta = load(path, m, ema)
            differ = [k for k, v in m.state_dict().items()
                      if not torch.equal(v, two_state[k])]
            differ += [k for k, v in ema.items()
                       if not torch.equal(v, two.ema_params[k])]
            restored.update(
                tensors=len(two_state) + len(ema), differ=differ,
                np_state=meta["np_rng_state"] == two_rec["np_states"][-1]
                == rec["np_states"][1], round=meta["round"])
            return meta

        lines = []
        with contextlib.ExitStack() as stack:
            res_rec = stack.enter_context(fed_instruments(fa, ln))
            stack.enter_context(rebound(checkpoint, "load_federated_checkpoint",
                                        checked_load))
            resumed = server.train_federated(
                cfg, fed_model(cfg), train, ev, log_fn=lines.append,
                workdir=str(FED_WORKDIR / "b"), resume=True)
        same_draws = len(res_rec["drawn"]) == FED_CLIENTS and all(
            np.array_equal(a, b) for a, b in zip(res_rec["drawn"],
                                                 rec["drawn"][-FED_CLIENTS:]))
        log(f"[fed] 12d resumed from round {restored['round']}: "
            f"{restored['tensors']} tensors restored bit for bit: "
            f"{not restored['differ']} {restored['differ'][:3]}; numpy state "
            f"as saved, and as the uninterrupted run's after round 2: "
            f"{restored['np_state']}; local trainings {res_rec['local_trainings']} "
            f"(round 3 alone: {FED_CLIENTS}); round 3's {FED_CLIENTS} clients' "
            f"indices equal the uninterrupted run's: {same_draws}; round 3's "
            f"loss {resumed.history[-1]['loss']!r} (uninterrupted "
            f"{full.history[-1]['loss']!r})")
        if restored["differ"] or not restored["np_state"] or \
                restored["round"] != 2 or not same_draws or \
                res_rec["local_trainings"] != FED_CLIENTS or \
                [h["round"] for h in resumed.history] != [1, 2, 3] or \
                not any("resumed from round 2" in x for x in lines):
            raise RuntimeError("the resumed federated run did not continue "
                               "as it should")
        del two, resumed, two_state
        torch.cuda.empty_cache()

        # 12e. the CLI
        fed_cli(smi)
        # 12f. where a round's time goes
        if trace:
            trace_fed(fa, ln, cfg, train, ev, smi)
    finally:
        shutil.rmtree(FED_WORKDIR, ignore_errors=True)
    log(f"[fed] phase 12 in {time.perf_counter() - phase_t0!r} s")
    return {"launches_round": launches[-1], "round_s": [
        h["round_time_s"] for h in full.history], "agg_ms": agg_ms,
        "eval_img_s": rec["evals"], "saves": rec["saves"],
        "peak_gib": peak_gib, "agg_rel_err": agg_err, "shapes": shapes}


# ---------------------------------------------------------------------------
# 13. The user's ISIC path: cli/import_weights → cli/train → cli/predict
#     --isic_dir, and cli/train_federated on the same files
# ---------------------------------------------------------------------------

# Phase 13 writes a seeded ISIC-2019 layout: 1,600 training JPEGs in
# ISIC-2019's two common sizes (12 more CSV rows without a JPEG, 10 UNK rows
# among those with one), a labelled test split of 256 JPEGs (4 more rows
# without one), one mask PNG an image, labels in ISIC-2019's class shares.
# Fold 0 of 5 trains on ~1,270 images, 9 steps of 128 an epoch.
ISIC_TRAIN, ISIC_TEST, ISIC_UNK = 1600, 256, 10
ISIC_NO_JPEG = (12, 4)                          # training, test
ISIC_SIZES = ((600, 450), (1024, 1024))
# ISIC-2019's training images a class (MEL, NV, BCC, AK, BKL, DF, VASC, SCC)
ISIC_COUNTS = (4522, 12875, 3323, 867, 2624, 239, 253, 628)
# each class's lesion pigment, RGB in [0, 1]
ISIC_PIGMENTS = ((0.22, 0.14, 0.12), (0.45, 0.30, 0.21), (0.76, 0.47, 0.46),
                 (0.70, 0.40, 0.34), (0.55, 0.40, 0.28), (0.60, 0.42, 0.36),
                 (0.58, 0.16, 0.26), (0.72, 0.36, 0.31))
ISIC_SITES = ("anterior torso", "upper extremity", "lower extremity",
              "posterior torso", "lateral torso", "head/neck", "palms/soles",
              "oral/genital", "Head/Neck", None)
ISIC_EPOCHS, ISIC_ROUNDS = 2, 2


def lesion_image(seed, w, h, label):
    """A smooth lesion-like RGB image and its mask, PIL images of w × h: a
    soft-edged ellipse of the class's pigment with a wavy border over skin,
    textured at a few pixels' scale, drawn at a quarter of the size and
    resized bicubically (the mask bilinearly, then thresholded)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    hs, ws = h // 4, w // 4
    yy, xx = np.mgrid[0:hs, 0:ws].astype(np.float32)
    cy, cx = rng.uniform(0.35, 0.65) * hs, rng.uniform(0.35, 0.65) * ws
    ry, rx = rng.uniform(0.12, 0.32, 2) * min(hs, ws)
    a = rng.uniform(0.0, math.pi)
    u = ((xx - cx) * math.cos(a) + (yy - cy) * math.sin(a)) / rx
    v = ((yy - cy) * math.cos(a) - (xx - cx) * math.sin(a)) / ry
    coarse = np.asarray(Image.fromarray(
        rng.normal(size=(hs // 16 + 2, ws // 16 + 2)).astype(np.float32)
    ).resize((ws, hs), Image.BICUBIC))
    lesion = 1.0 / (1.0 + np.exp(np.clip(10.0 * (u * u + v * v + 0.35 * coarse
                                                 - 1.0), -30.0, 30.0)))
    skin = rng.uniform((0.75, 0.55, 0.45), (0.95, 0.75, 0.65))
    pigment = np.asarray(ISIC_PIGMENTS[label]) * rng.uniform(0.8, 1.2, 3)
    img = (skin * (1.0 - lesion[..., None]) + pigment * lesion[..., None]
           + 0.04 * coarse[..., None] + rng.normal(0.0, 0.025, (hs, ws, 3)))
    small = Image.fromarray((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
    mask = Image.fromarray((lesion * 255).astype(np.uint8))
    return (small.resize((w, h), Image.BICUBIC),
            mask.resize((w, h), Image.BILINEAR).point(
                lambda p: 255 if p >= 128 else 0))


def write_isic_layout(root: Path, seed: int, packages: str) -> dict:
    """13a: the ISIC-2019 layout under ``root`` (CSVs with pandas, JPEGs and
    mask PNGs with PIL on 8 threads); returns what it wrote."""
    from concurrent.futures import ThreadPoolExecutor
    try:
        import pandas as pd
        from PIL import Image  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"phase 13 writes its ISIC layout with PIL and "
                           f"pandas, which do not both import here ({e!r}); "
                           f"phase 1's probe: {packages}") from e
    rng = np.random.default_rng(seed)
    shares = np.asarray(ISIC_COUNTS, np.float64) / sum(ISIC_COUNTS)
    masks = root / "masks"
    masks.mkdir(parents=True)
    jobs = []

    def split(name, first, n_jpeg, n_missing, n_unk, lesions):
        n = n_jpeg + n_missing
        names = [f"ISIC_{i:07d}" for i in range(first, first + n)]
        labels = rng.choice(8, n, p=shares)
        missing = set(rng.choice(n, n_missing, replace=False).tolist())
        with_jpeg = [i for i in range(n) if i not in missing]
        columns = labels.copy()
        columns[rng.choice(with_jpeg, n_unk, replace=False)] = 8     # UNK
        onehot = np.zeros((n, 9))
        onehot[np.arange(n), columns] = 1.0
        gt = pd.DataFrame(onehot, columns=["MEL", "NV", "BCC", "AK", "BKL",
                                           "DF", "VASC", "SCC", "UNK"])
        gt.insert(0, "image", names)
        ages = rng.choice(np.arange(0.0, 90.0, 5.0), n)
        ages[rng.random(n) < 0.05] = np.nan
        meta = pd.DataFrame({
            "image": names, "age_approx": ages,
            "anatom_site_general": rng.choice(
                np.asarray(ISIC_SITES, object), n,
                p=[0.2, 0.15, 0.2, 0.15, 0.02, 0.15, 0.02, 0.01, 0.05, 0.05]),
            "sex": rng.choice(np.asarray(["male", "female", "Male", "FEMALE",
                                          None], object), n,
                              p=[0.45, 0.45, 0.03, 0.03, 0.04])})
        if lesions:           # 1-4 images a lesion, as HAM10000's lesion ids
            ids = np.repeat(np.arange(n), rng.integers(1, 5, n))[:n]
            meta["lesion_id"] = [f"HAM_{i:07d}" for i in ids]
        sizes = rng.integers(0, len(ISIC_SIZES), n)
        img_dir = root / f"ISIC_2019_{name}_Input"
        img_dir.mkdir()
        for i in with_jpeg:
            jobs.append((img_dir / f"{names[i]}.jpg", masks / f"{names[i]}.png",
                         seed * 100003 + first + i, *ISIC_SIZES[sizes[i]],
                         int(labels[i])))
        return gt, meta

    for name, first, n_jpeg, n_missing, n_unk, lesions in (
            ("Training", 0, ISIC_TRAIN, ISIC_NO_JPEG[0], ISIC_UNK, True),
            ("Test", 10 ** 6, ISIC_TEST, ISIC_NO_JPEG[1], 0, False)):
        gt, meta = split(name, first, n_jpeg, n_missing, n_unk, lesions)
        gt.to_csv(root / f"ISIC_2019_{name}_GroundTruth.csv", index=False)
        meta.to_csv(root / f"ISIC_2019_{name}_Metadata.csv", index=False)

    def write(job):
        jpg, png, img_seed, w, h, label = job
        img, mask = lesion_image(img_seed, w, h, label)
        img.save(jpg, quality=90)
        mask.save(png)
        return jpg.stat().st_size, png.stat().st_size

    with ThreadPoolExecutor(8) as pool:
        sizes = list(pool.map(write, jobs))
    return {"jpegs": len(jobs), "jpeg_bytes": sum(s for s, _ in sizes),
            "png_bytes": sum(p for _, p in sizes)}


def timm_vit_base(seed):
    """A seeded ViT-B/16@224 backbone state dict in timm's layout (RGB patch
    embed, ``patch_embed.*``, ``cls_token``, ``pos_embed``, ``blocks.*``,
    ``norm.*``), as ``timm.create_model(..., num_classes=0).state_dict()``
    names it."""
    g = torch.Generator().manual_seed(seed)
    d, hidden, n = 768, 3072, (224 // 16) ** 2 + 1

    def draw(*shape, mean=0.0):
        return mean + 0.02 * torch.randn(*shape, generator=g)

    sd = {"cls_token": draw(1, 1, d), "pos_embed": draw(1, n, d),
          "patch_embed.proj.weight": draw(d, 3, 16, 16),
          "patch_embed.proj.bias": draw(d)}
    for i in range(BLOCKS):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": draw(d, mean=1.0), p + "norm1.bias": draw(d),
                   p + "attn.qkv.weight": draw(3 * d, d),
                   p + "attn.qkv.bias": draw(3 * d),
                   p + "attn.proj.weight": draw(d, d), p + "attn.proj.bias": draw(d),
                   p + "norm2.weight": draw(d, mean=1.0), p + "norm2.bias": draw(d),
                   p + "mlp.fc1.weight": draw(hidden, d),
                   p + "mlp.fc1.bias": draw(hidden),
                   p + "mlp.fc2.weight": draw(d, hidden), p + "mlp.fc2.bias": draw(d)})
    sd.update({"norm.weight": draw(d, mean=1.0), "norm.bias": draw(d)})
    return sd


def isic_config(root: Path, pretrained: Path) -> dict:
    """The user's YAML for phase 13: ViT-B/16@224, bf16, the mask PNGs as the
    4th channel, the default train augment, TTA and recipe, 5 folds, macro
    batch 128 as 2 × 64, 2 epochs, from the imported weights; federated
    rounds of 8 local steps."""
    return {"data": {"isic_dir": str(root), "use_segmentation_mask": True,
                     "segmentation_mask_dir": str(root / "masks")},
            "model": {"backbone": "vit_base_patch16_224", "image_size": 224,
                      "compute_dtype": "bfloat16", "pretrained": True,
                      "pretrained_path": str(pretrained)},
            "training": {"epochs": ISIC_EPOCHS, "batch_size": MICRO,
                         "gradient_accumulation_steps": ACCUM,
                         "scheduler": {"warmup_epochs": 0}},
            "federated": {"local_steps": FED_STEPS}}


@contextlib.contextmanager
def k1_inputs():
    """Inside the block, the first (qkv, bias, output, heads) of each qkv
    shape that the ViT's attention hands K1 (its forwards without a
    gradient), cloned, in a dict by shape. K1's count still rises once a
    launch."""
    from fedvit_torch.models import layers
    fn = layers.flash_attention_qkvb
    seen = {}

    def recording(qkv, bias, heads):
        out = fn(qkv, bias, heads)
        grad = torch.is_grad_enabled() and (qkv.requires_grad
                                            or bias.requires_grad)
        if not grad and tuple(qkv.shape) not in seen:
            seen[tuple(qkv.shape)] = (qkv.clone(), bias.clone(), out.clone(),
                                      heads)
        return out
    with rebound(layers, "flash_attention_qkvb", recording):
        yield seen


def check_k1_inputs(tag, fa, captured, timed_shapes):
    """K1's outputs in a CLI run against the plain version on the same
    inputs, at each captured shape, to ``k1_atol_bf16`` of the inputs' |v|;
    then K1 against its plain version on seeded inputs, timed, at each of
    ``timed_shapes``. Returns the timed records."""
    from fedvit_torch.ops.attention import attention_from_qkvb

    for shape, (qkv, bias, out, heads) in sorted(captured.items()):
        e = shape[-1] // 3
        with torch.inference_mode():
            want = attention_from_qkvb(qkv, bias, heads)
            vmax = float((qkv[..., 2 * e:].float() + bias[2 * e:].float())
                         .abs().max())
            err = float((out.float() - want.float()).abs().max())
            rel = float((out.float() - want.float()).pow(2).mean().sqrt()
                        / want.float().pow(2).mean().sqrt())
        atol = k1_atol_bf16(vmax)
        log(f"{tag} K1 on the run's own qkv {shape} {short(qkv.dtype)}, heads "
            f"{heads}, max |v| {vmax!r}: against the plain version "
            f"max_abs_err {err!r} (tolerance {atol!r}, one bf16 ulp of max "
            f"|v|), RMS error {rel!r} x RMS output")
        if not err <= atol:
            raise RuntimeError(f"{tag}: K1 disagrees with its plain version on "
                               f"the run's qkv {shape}: {err} > {atol}")
    recs = []
    for b, n, e3 in timed_shapes:
        rec = check_k1(fa, attention_from_qkvb, b, n, 12, e3 // 3 // 12,
                       torch.bfloat16, K1_ATOL_BF16, timed=True)
        rec["shape"] = [b, n, e3]
        recs.append(rec)
    return recs


def run_cli(tag, main_fn, argv):
    """``main_fn(argv)`` in this process with its stdout captured; returns
    (seconds, stdout, peak GiB). A failure prints the tail of its stdout."""
    import io
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = main_fn(argv)
        torch.cuda.synchronize()
    except BaseException:
        log(f"[isic] {tag} failed; its stdout ends:\n{out.getvalue()[-3000:]}")
        raise
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{tag} returned {rc}")
    return seconds, out.getvalue(), torch.cuda.max_memory_allocated() / 2 ** 30


def isic_phase(fa, ln, smi, packages, tmp):
    """Phase 13, its files under the directory ``tmp`` (phase 15 reads its
    ISIC layout after it); returns each kernel's launches by entry point
    ("launches") and the records of K1, K7 and K8 at the shapes this path
    gives them ("shapes")."""
    from fedvit_torch.cli import import_weights as import_cli
    from fedvit_torch.cli import predict as predict_cli
    from fedvit_torch.cli import train as train_cli
    from fedvit_torch.cli import train_federated as fed_cli
    from fedvit_torch.core.config import load_config
    from fedvit_torch.data.isic import load_isic_data
    from fedvit_torch.data.pipeline import HostDataSource, make_device_augment
    from fedvit_torch.eval import serve
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    from fedvit_torch.train import loop

    phase_t0 = time.perf_counter()
    fns = counted(fa, ln) | {"K7": rs.shift_cuda, "K8": ra.equalize_cuda}
    path_kernels = ("K1", "K2", "K3", "K4", "LN", "K7", "K8")

    def now():
        return {k: fn.launches for k, fn in fns.items()}

    def delta(before):
        return {k: fn.launches - before[k] for k, fn in fns.items()}

    def only(counts):
        return {k: v for k, v in counts.items() if v}

    root, pretrained, logs = tmp / "ISIC", tmp / "pretrained", tmp / "log"
    # 13a. the layout, its tables and its decode
    t0 = time.perf_counter()
    layout = write_isic_layout(root, SEED + 13, packages)
    layout_s = time.perf_counter() - t0
    log(f"[isic] 13a layout: {layout['jpegs']} JPEGs of "
        f"{' and '.join(f'{w}x{h}' for w, h in ISIC_SIZES)} "
        f"({layout['jpeg_bytes']} bytes, "
        f"{layout['jpeg_bytes'] / layout['jpegs']!r} a JPEG) and as many "
        f"mask PNGs ({layout['png_bytes']} bytes), the CSVs, in "
        f"{layout_s!r} s (host, 8 threads; {smi})")
    t0 = time.perf_counter()
    train_df, test_df = load_isic_data(str(root), log=lambda s: None)
    load_s = time.perf_counter() - t0
    log(f"[isic] load_isic_data: {len(train_df)} training and "
        f"{len(test_df)} test rows in {load_s!r} s (host; {smi})")
    if len(train_df) != ISIC_TRAIN - ISIC_UNK or len(test_df) != ISIC_TEST:
        raise RuntimeError("load_isic_data did not drop the UNK rows and "
                           "the rows without a JPEG as it should")
    config = tmp / "isic.yaml"
    config.write_text(json.dumps(isic_config(root, pretrained)))
    cfg = load_config(str(config))
    source = HostDataSource(train_df, cfg)
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        batch = source.gather(np.arange(len(source)))
        rates.append(len(source) / (time.perf_counter() - t0))
    log(f"[isic] HostDataSource decode of the {len(source)} training "
        f"images to {batch['image'].shape[1:]} uint8 canvases with their "
        f"masks ({cfg.training.num_workers} threads, PIL): cold "
        f"{rates[0]!r} img/s, cached {rates[1]!r} img/s (host; {smi})")
    masked = float((batch["image"][..., 3] > 0).mean())
    if not 0.02 < masked < 0.6:
        raise RuntimeError(f"the mask channel covers {masked!r} of the "
                           f"canvases: the mask PNGs were not read")
    del batch, source

    # 13b. cli.import_weights on a timm-layout ViT-B/16@224 backbone
    weights = tmp / "vit_base_patch16_224.pt"
    sd = timm_vit_base(SEED + 13)
    torch.save(sd, weights)
    import_s, _, _ = run_cli("cli.import_weights", import_cli.main, [
        "--weights", str(weights), "--config", str(config),
        "--output", str(pretrained)])
    saved = torch.load(pretrained / "variables.pt", map_location="cpu",
                       weights_only=True)
    w = sd["patch_embed.proj.weight"]
    patch = saved["backbone.patch_embed.proj.weight"]
    mean_ok = patch.shape[1] == 4 and torch.equal(
        patch[:, :3], w) and torch.equal(patch[:, 3], w.mean(dim=1))
    differ = [k for k, v in sd.items() if k != "patch_embed.proj.weight"
              and not torch.equal(saved["backbone." + k], v)]
    left = sorted({k for k in saved if k.startswith("backbone.")}
                  - {"backbone." + k for k in sd})
    log(f"[isic] 13b `python -m fedvit_torch.cli.import_weights`: "
        f"{len(sd)} tensors in {import_s!r} s; the 4th patch-embed "
        f"channel is the mean of the RGB kernels and the RGB kernels "
        f"the file's: {mean_ok}; other backbone tensors unequal to the "
        f"file's: {differ[:3]}; backbone tensors not from the file: "
        f"{left[:3]} ({smi})")
    if not mean_ok or differ or left:
        raise RuntimeError("the imported backbone is not the file's")
    del sd, saved

    # 13c. cli.train --fold 0
    epochs, evals, ttas, folds = [], [], [], {}
    train_epoch, evaluate = loop._train_epoch, loop._evaluate
    tta, train_fold = loop.evaluate_with_tta, loop.train_fold

    def timed_epoch(step, state, src, macro_bs, *args, **kwargs):
        torch.cuda.synchronize()
        before, t0 = now(), time.perf_counter()
        out = train_epoch(step, state, src, macro_bs, *args, **kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = len(src) // macro_bs
        epochs.append({"s": dt, "img_s": steps * macro_bs / dt,
                       "steps": steps, "per_step": {
                           k: v / steps for k, v in delta(before).items()}})
        return out

    def timed_eval(into, fn, n_forwards):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = now(), time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            n, forwards = n_forwards(*args, **kwargs)
            into.append({"img_s": n / (time.perf_counter() - t0),
                         "forwards": forwards, "launches": delta(before)})
            return out
        return wrapped

    def eval_forwards(step, src, batch_size, *args, **kwargs):
        return len(src), math.ceil(len(src) / batch_size)

    def tta_forwards(cfg_, model, src, batch_size=None):
        bs = batch_size or max(1, cfg_.training.batch_size // 4)
        return len(src), math.ceil(len(src) / bs)

    def recorded_fold(cfg_, f, trn, val, *args, **kwargs):
        folds[f] = {"train": len(trn), "val": len(val),
                    "shared": set(trn.df["lesion_id"])
                    & set(val.df["lesion_id"]),
                    "groups": trn.df["lesion_id"].nunique()
                    + val.df["lesion_id"].nunique()}
        return train_fold(cfg_, f, trn, val, *args, **kwargs)

    with contextlib.ExitStack() as stack:
        plain = stack.enter_context(plain_calls(fa, ln))
        train_k1 = stack.enter_context(k1_inputs())
        for module, name, fn in (
                (loop, "_train_epoch", timed_epoch),
                (loop, "_evaluate", timed_eval(evals, evaluate,
                                               eval_forwards)),
                (loop, "evaluate_with_tta", timed_eval(ttas, tta,
                                                       tta_forwards)),
                (loop, "train_fold", recorded_fold)):
            stack.enter_context(rebound(module, name, fn))
        before = now()
        train_s, _, train_peak = run_cli("cli.train", train_cli.main, [
            "--config", str(config), "--fold", "0", "--log", str(logs)])
        train_counts = delta(before)
    fold_log = (logs / "fold0" / "train_fold0.log").read_text()
    for line in fold_log.splitlines():
        if any(s in line for s in ("Pretrained init", " E0", "Train:",
                                   "Fold 0 Test", "New best")):
            log(f"[isic] cli.train: {line.split(' | ', 1)[-1].strip()}")
    fold = folds.get(0, {})
    log(f"[isic] 13c fold 0: {fold.get('train')} training and "
        f"{fold.get('val')} validation images in {fold.get('groups')} "
        f"lesions, lesions on both sides: {len(fold.get('shared', ()))}")
    want_step = {k: 0.0 for k in fns} | {
        "K7": 12.0, "K8": 3.0, "K2": ACCUM * BLOCKS, "K3": ACCUM * BLOCKS,
        "K4": ACCUM * NORMS, "LN": ACCUM * NORMS}
    for i, e in enumerate(epochs):
        log(f"[isic] cli.train epoch {i + 1}: {e['steps']} steps in "
            f"{e['s']!r} s = {e['img_s']!r} train img/s synchronised "
            f"(macro batch {MICRO * ACCUM}, resident canvases, the train "
            f"augment, the step); launches a step {only(e['per_step'])} "
            f"({smi})")
    for name, recs in (("validation", evals), ("TTA test", ttas)):
        for r in recs:
            log(f"[isic] cli.train {name}: {r['img_s']!r} img/s "
                f"synchronised, {r['forwards']} forwards, launches "
                f"{only(r['launches'])} ({smi})")
    ens = np.load(logs / "ensemble_logits.npy")
    log(f"[isic] `python -m fedvit_torch.cli.train --fold 0`: {train_s!r} "
        f"s from start to end (tables, decode, upload, 2 epochs, "
        f"checkpoints, TTA test); peak {train_peak!r} GiB; launches "
        f"{only(train_counts)}; plain versions called {plain}; "
        f"ensemble_logits.npy {ens.shape}, finite "
        f"{bool(np.isfinite(ens).all())} ({smi})")
    bad_eval = [r for r in evals + ttas
                if r["launches"] != serving_want(fns, r["forwards"])]
    if fold.get("shared") or not fold.get("train"):
        raise RuntimeError("fold 0's training and validation lesions "
                           "overlap, or the fold did not run")
    if len(epochs) != ISIC_EPOCHS or any(e["per_step"] != want_step
                                         for e in epochs) or \
            len(evals) != ISIC_EPOCHS or len(ttas) != 1 or bad_eval or \
            any(plain.values()):
        raise RuntimeError(f"cli.train did not launch the kernels as it "
                           f"should: want {only(want_step)} a step and "
                           f"{BLOCKS} K1 and {NORMS} LayerNorm forwards a "
                           f"forward, no plain version")
    if not all((logs / "fold0" / f"{k}_fold0" / "state.pt").exists()
               for k in ("best", "resume")) or \
            ens.shape != (ISIC_TEST, 8) or not np.isfinite(ens).all() or \
            "Pretrained init" not in fold_log:
        raise RuntimeError("cli.train's checkpoints, ensemble logits or "
                           "pretrained init are missing")
    tta_bs = max(1, cfg.training.batch_size // 4)
    shapes = {"K1": check_k1_inputs("[isic] 13c", fa, train_k1, [
        (8 * tta_bs, 197, 2304)])}
    del train_k1

    # 13d. cli.predict --isic_dir on the fold's best checkpoint, with TTA
    preds = []
    with contextlib.ExitStack() as stack:
        plain = stack.enter_context(plain_calls(fa, ln))
        stack.enter_context(rebound(serve, "evaluate_with_tta", timed_eval(
            preds, serve.evaluate_with_tta, tta_forwards)))
        predict_k1 = stack.enter_context(k1_inputs())
        before = now()
        predict_s, printed, predict_peak = run_cli(
            "cli.predict", predict_cli.main, [
                "--config", str(config), "--isic_dir", str(root),
                "--checkpoint", str(logs / "fold0" / "best_fold0"),
                "--tta", "--output", str(tmp / "predictions.csv"),
                "--logits_out", str(tmp / "predict_logits.npy")])
        predict_counts = delta(before)
    import pandas as pd
    got = np.load(tmp / "predict_logits.npy")
    rows = pd.read_csv(tmp / "predictions.csv")
    same_order = list(rows["image"]) == list(test_df["image"])
    err = rel_rms(got, ens)
    log(f"[isic] 13d `python -m fedvit_torch.cli.predict --isic_dir ... "
        f"--tta`: {predict_s!r} s from start to end; TTA "
        f"{preds[0]['img_s']!r} img/s synchronised at batch "
        f"{cfg.training.batch_size} ({preds[0]['forwards']} forwards; "
        f"cli.train's TTA test ran at {max(1, cfg.training.batch_size // 4)}"
        f"); peak {predict_peak!r} GiB; launches {only(predict_counts)}; "
        f"plain versions called {plain}; {len(rows)} CSV rows in the test "
        f"frame's order: {same_order}; report printed: "
        f"{'macro avg' in printed}; logits against ensemble_logits.npy: "
        f"bit-equal {np.array_equal(got, ens)}, RMS error {err!r} x RMS "
        f"logit (limit {LOGITS_RTOL_BF16!r}: the batch sizes differ) "
        f"({smi})")
    if predict_counts != serving_want(fns, preds[0]["forwards"]) or \
            any(plain.values()):
        raise RuntimeError("cli.predict did not launch K1 and the LayerNorm "
                           "forward alone, 12 and 25 a forward")
    if not err <= LOGITS_RTOL_BF16 or got.shape != ens.shape or \
            len(rows) != ISIC_TEST or not same_order or \
            "macro avg" not in printed:
        raise RuntimeError("cli.predict's logits, rows or report are wrong")
    shapes["K1"] += check_k1_inputs("[isic] 13d", fa, predict_k1, [
        (8 * cfg.training.batch_size, 197, 2304)])
    del predict_k1

    # 13e. cli.train_federated on the same files
    fed_log = tmp / "fed"
    with fed_instruments(fa, ln) as rec:
        fed_s, printed, fed_peak = run_cli(
            "cli.train_federated", fed_cli.main, [
                "--config", str(config), "--clients", str(FED_CLIENTS),
                "--rounds", str(ISIC_ROUNDS), "--log", str(fed_log)])
    history = json.loads((fed_log / "federated_history.json").read_text())
    launches = per_round(rec["counts"])
    for line in printed.splitlines():
        if line.startswith("[fed]"):
            log(f"[isic] cli.train_federated: {line}")
    log(f"[isic] 13e `python -m fedvit_torch.cli.train_federated` on the "
        f"ISIC files ({FED_CLIENTS} clients x {FED_STEPS} local steps of "
        f"{cfg.training.batch_size}, {ISIC_ROUNDS} rounds): {fed_s!r} s "
        f"from start to end (tables, the whole training split decoded, "
        f"rounds, checkpoints); rounds "
        f"{[h['round_time_s'] for h in history]} s; peak {fed_peak!r} "
        f"GiB; launches a round {launches}, want {fed_want()}; plain "
        f"versions called {rec['plain']} ({smi})")
    if len(history) != ISIC_ROUNDS or not all(
            math.isfinite(h[k]) for h in history
            for k in ("loss", "accuracy", "balanced_accuracy", "macro_f1")):
        raise RuntimeError("the federated CLI's history is wrong")
    if any(n != fed_want() for n in launches) or \
            len(launches) != ISIC_ROUNDS or any(rec["plain"].values()):
        raise RuntimeError("a federated round on the ISIC files did not "
                           "launch the kernels as it should")
    shapes["K7"], shapes["K8"] = check_augment_batch(
        "[isic] 13e", make_device_augment(cfg, train=True),
        rec.pop("batch"), SEED + 13)
    log(f"[isic] phase 13 in {time.perf_counter() - phase_t0!r} s ({smi})")
    return {"launches": {k: {"train_cli": train_counts[k],
                             "predict_cli": predict_counts[k],
                             "federated_cli_round": launches[-1].get(k, 0)}
                         for k in path_kernels},
            "shapes": shapes, "train_cli_s": train_s}



# ---------------------------------------------------------------------------
# 14. Lesion masks segmented on the card: ops/cvseg, data.on_device_masks
#     through the train and eval augments, and cli/precompute_masks
# ---------------------------------------------------------------------------

# 14a's batches (images, side): the ViT-B/16@224 fold's micro-batch of
# canvases (canvas_size(224) = 272) and SwinV2-L@384's (448) at 16.
SEG_SHAPES = ((64, 272), (16, 448))
SEG_REPS = 10                 # timed calls a stage; the median is kept
SEG_MAX_SYNCS = 8             # host syncs of the component loop a batch
# a mask's pixels equal to the CPU's on the same input, for each image: a
# gray level truncated the other way (the blurs sum in other orders) can
# move a threshold or a border pixel (tests/test_torch_cvseg.py)
SEG_AGREE = 0.999
SEG_BLUR_ATOL = 1e-3          # the blur against the CPU's, as the CPU tests
# PyTorch's default TF32 flags: cuDNN's convolutions in TF32, cuBLAS's
# products not (matmul precision "highest")
DEFAULT_TF32 = (True, "highest")
# 14d's federated round on the ISIC files: 2 clients x 2 local steps
MASK_CLIENTS, MASK_STEPS = 2, 2


def segment_inputs(b, size, seed):
    """(b, size, size, 3) float32 in [0, 1] on the host: phase 13's lesion
    images drawn at size², as uint8 divided by 255."""
    imgs = [np.asarray(lesion_image(seed + i, size, size, i % 8)[0])
            for i in range(b)]
    return torch.from_numpy(np.stack(imgs).astype(np.float32)
                            / np.float32(255.0))


@contextlib.contextmanager
def tf32_flags(conv, matmul):
    """cuDNN's TF32 flag and the fp32 matmul precision inside the block; the
    run's own after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = conv
    torch.set_float32_matmul_precision(matmul)
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def stage_ms(fn, reps=SEG_REPS):
    """Median device ms of ``fn()`` over ``reps`` calls, each between two
    CUDA events and synchronised (the waits on the host's syncs inside it
    included)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def counted_syncs(fn):
    """(``fn()``, the synchronising CUDA calls it made as
    ``torch.cuda.set_sync_debug_mode`` counts them, by the file:line that
    made them)."""
    import collections
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def check_segmenter(cv, b, size, seed, smi):
    """14a at one shape, under PyTorch's default TF32 flags: the stages on
    the card against the same on the CPU, their times, the sweeps and host
    syncs of the component loop. Returns its record."""
    se = cv.ELLIPSE_7x7
    x_cpu = segment_inputs(b, size, seed)
    x = x_cpu.cuda()
    circle = cv._circle_mask(size, size, x.device)
    with tf32_flags(*DEFAULT_TF32):
        lab = cv.rgb_to_lab_l(x)
        blurred = cv.gaussian_blur(lab)
        gray = blurred.clamp(0, 255).int()
        thresholds = cv.otsu_threshold(gray)
        binary = cv.otsu_binary_inv(gray) & circle
        morph = cv.morph_open(cv.morph_close(binary, se, 3), se, 2)
        cv.propagate_labels(morph)               # first-use work uncounted
        (labels, sweeps), sync_sites = counted_syncs(
            lambda: cv.propagate_labels(morph))
        syncs = sum(sync_sites.values())
        # each image alone: its own sweeps, and the batch's labels
        alone = [cv.propagate_labels(morph[i:i + 1]) for i in range(b)]
        alone_equal = torch.equal(torch.cat([lab for lab, _ in alone]),
                                  labels)
        alone_sweeps = sorted(n for _, n in alone)
        masks = cv.segment_lesion_batch(x, size)
        ms = {"lab": stage_ms(lambda: cv.rgb_to_lab_l(x)),
              "blur": stage_ms(lambda: cv.gaussian_blur(lab)),
              "otsu": stage_ms(lambda: cv.otsu_binary_inv(
                  blurred.clamp(0, 255).int()) & circle),
              "morphology": stage_ms(lambda: cv.morph_open(
                  cv.morph_close(binary, se, 3), se, 2)),
              "components": stage_ms(lambda: cv.largest_component(morph)),
              "whole": stage_ms(lambda: cv.segment_lesion_batch(x, size))}
        # control: the blur without its fp32 guard, under cuDNN's TF32
        with rebound(cv, "_ieee_fp32", contextlib.nullcontext):
            unguarded = cv.gaussian_blur(lab).cpu()
    # a user who turned TF32 on for cuBLAS too gets the same masks
    with tf32_flags(True, "high"):
        masks_tf32 = cv.segment_lesion_batch(x, size)
    # the same function on the CPU, on the same input
    lab_c = cv.rgb_to_lab_l(x_cpu)
    blurred_c = cv.gaussian_blur(lab_c)
    gray_c = blurred_c.clamp(0, 255).int()
    binary_c = cv.otsu_binary_inv(gray_c) & cv._circle_mask(size, size, "cpu")
    morph_c = cv.morph_open(cv.morph_close(binary_c, se, 3), se, 2)
    masks_c = cv.segment_lesion_batch(x_cpu, size)
    # the card's stages on the CPU's own inputs
    with tf32_flags(*DEFAULT_TF32):
        blur_same = cv.gaussian_blur(lab_c.cuda()).cpu()
        thresholds_same = cv.otsu_threshold(gray_c.cuda()).cpu()
        morph_same = cv.morph_open(cv.morph_close(
            binary_c.cuda(), se, 3), se, 2).cpu()
        labels_same = cv.connected_components(morph_c.cuda()).cpu()
    blur_err = float((blurred.cpu() - blurred_c).abs().max())
    blur_same_err = float((blur_same - blurred_c).abs().max())
    control_err = float((unguarded - blurred_c).abs().max())
    agree = (masks.cpu() == masks_c).float().mean(dim=(1, 2, 3))
    checks = sum(1 for end in itertools.accumulate(cv.SWEEP_BLOCKS)
                 if end <= sweeps and end < cv.MAX_SWEEPS)
    rec = {"shape": [b, size, size, 3], "ms": ms, "sweeps": sweeps,
           "sweeps_alone": alone_sweeps, "syncs": syncs, "checks": checks,
           "blur_max_abs_err": blur_err,
           "blur_same_input_max_abs_err": blur_same_err,
           "blur_unguarded_max_abs_err": control_err,
           "gray_levels_differing": int((gray.cpu() != gray_c).sum()),
           "thresholds_differing": int(
               (thresholds.cpu() != cv.otsu_threshold(gray_c)).sum()),
           "min_agreement": float(agree.min()),
           "foreground_share": float(masks.mean())}
    log(f"[masks] 14a segment_lesion_batch {tuple(x.shape)} on the card, "
        f"PyTorch's default TF32 flags: median ms {ms} ({smi}); component "
        f"loop {sweeps} sweeps, {syncs} host syncs counted by "
        f"torch.cuda.set_sync_debug_mode at {dict(sync_sites)} ({checks} "
        f"reads of the images still changing; limit {SEG_MAX_SYNCS}); each "
        f"image alone converges in {alone_sweeps} sweeps (JAX's cap "
        f"{cv.MAX_SWEEPS}), its labels bit-equal to the batch's: "
        f"{alone_equal}; against the CPU on the same input: blur "
        f"max |Δ| {blur_err!r} ({blur_same_err!r} on the CPU's own L; "
        f"{control_err!r} without the fp32 guard), gray levels differing "
        f"{rec['gray_levels_differing']} of {gray.numel()}, thresholds "
        f"differing {rec['thresholds_differing']} of {b}, the masks' pixel "
        f"agreement per image min {rec['min_agreement']!r} (limit "
        f"{SEG_AGREE}), foreground {rec['foreground_share']!r}")
    failed = []
    if not (blur_err <= SEG_BLUR_ATOL and blur_same_err <= SEG_BLUR_ATOL):
        failed.append(f"the blur is off the CPU's by {blur_err}")
    if not torch.equal(thresholds_same, cv.otsu_threshold(gray_c)):
        failed.append("the thresholds of the same gray levels differ")
    if not torch.equal(morph_same, morph_c):
        failed.append("the morphology of the same binary image differs")
    if not torch.equal(labels_same, cv.connected_components(morph_c)):
        failed.append("the labels of the same binary image differ")
    if not float(agree.min()) >= SEG_AGREE:
        failed.append(f"a mask agrees with the CPU's on {float(agree.min())}")
    if not torch.equal(masks_tf32, masks):
        failed.append("cuBLAS's TF32 changed the masks")
    if not syncs <= SEG_MAX_SYNCS:
        failed.append(f"the component loop synced {syncs} times")
    if not alone_equal:
        failed.append("an image's labels alone differ from the batch's")
    if failed:
        raise RuntimeError(f"14a at {tuple(x.shape)}: " + "; ".join(failed))
    return rec


def masks_config(root: Path, pretrained: Path) -> dict:
    """Phase 13's YAML without the mask directory: the masks segmented on the
    card (``data.on_device_masks``), no TTA, federated rounds of 2 local
    steps."""
    raw = isic_config(root, pretrained)
    del raw["data"]["segmentation_mask_dir"]
    raw["data"]["on_device_masks"] = True
    raw["training"]["tta"] = {"enabled": False}
    raw["federated"] = {"local_steps": MASK_STEPS}
    return raw


def mask_iou(pair):
    """IoU of a 224² mask PNG written on the card against the layout's drawn
    mask resized to it (nearest)."""
    from PIL import Image
    written, drawn = pair
    a = np.asarray(Image.open(written)) > 0
    with Image.open(drawn) as im:
        b = np.asarray(im.convert("L").resize(a.shape[::-1],
                                              Image.NEAREST)) > 127
    union = (a | b).sum()
    return float((a & b).sum() / union) if union else 1.0


def on_device_masks_phase(fa, ln, smi, packages):
    """Phase 14; returns the launches of K1-K4, K7 and K8 by entry point
    ("launches") and 14a's records ("segment")."""
    import io
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from fedvit_torch.cli import import_weights as import_cli
    from fedvit_torch.cli import precompute_masks as precompute_cli
    from fedvit_torch.cli import predict as predict_cli
    from fedvit_torch.cli import train as train_cli
    from fedvit_torch.cli import train_federated as fed_cli
    from fedvit_torch.core.config import load_config
    from fedvit_torch.data import pipeline
    from fedvit_torch.ops import cvseg as cv
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    from fedvit_torch.train import loop

    phase_t0 = time.perf_counter()
    # 14a. the segmenter on the card against the CPU. The process's first
    # switch into the sync debug mode counts a sync of its own: made here
    _, first = counted_syncs(lambda: None)
    log(f"[masks] syncs counted around nothing at the debug mode's first "
        f"use: {dict(first)}")
    segment = [check_segmenter(cv, b, size, SEED + 14 + 1000 * i, smi)
               for i, (b, size) in enumerate(SEG_SHAPES)]

    fns = counted(fa, ln) | {"K7": rs.shift_cuda, "K8": ra.equalize_cuda}
    path_kernels = ("K1", "K2", "K3", "K4", "LN", "K7", "K8")

    def now():
        return {k: fn.launches for k, fn in fns.items()}

    def delta(before):
        return {k: fn.launches - before[k] for k, fn in fns.items()}

    def only(counts):
        return {k: v for k, v in counts.items() if v}

    seg_calls = []

    def timed_segment(fn):
        def wrapped(img, size):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(img, size)
            end.record()
            seg_calls.append((tuple(img.shape), start, end))
            return out
        return wrapped

    def seg_ms(calls):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for _, s, e in calls]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_masks_") as tmp:
        tmp = Path(tmp)
        root, pretrained, logs = tmp / "ISIC", tmp / "pretrained", tmp / "log"
        t0 = time.perf_counter()
        layout = write_isic_layout(root, SEED + 14, packages)
        log(f"[masks] layout: {layout['jpegs']} JPEGs of "
            f"{' and '.join(f'{w}x{h}' for w, h in ISIC_SIZES)} and their "
            f"drawn mask PNGs in {time.perf_counter() - t0!r} s (host; {smi})")

        # 14b. python -m fedvit_torch.cli.precompute_masks
        out_dir = tmp / "masks_on_card"
        with rebound(cv, "segment_lesion_batch",
                     timed_segment(cv.segment_lesion_batch)):
            pre_s, printed, pre_peak = run_cli(
                "cli.precompute_masks", precompute_cli.main, [
                    "--isic_dir", str(root), "--output_dir", str(out_dir),
                    "--image_size", "224"])
        pre_calls = seg_ms(seg_calls)
        seg_calls.clear()
        pngs = sorted(out_dir.glob("*.png"))

        def png_values(path):
            return np.unique(np.asarray(Image.open(path)))
        with ThreadPoolExecutor(8) as pool:
            values = set(np.concatenate(list(pool.map(png_values, pngs)))
                         .tolist())
            ious = list(pool.map(mask_iou, [(p, root / "masks" / p.name)
                                            for p in pngs]))
        shapes = {np.asarray(Image.open(pngs[0])).shape} if pngs else set()
        log(f"[masks] 14b `python -m fedvit_torch.cli.precompute_masks "
            f"--image_size 224` on the {layout['jpegs']} JPEGs: {len(pngs)} "
            f"PNGs of {shapes}, values {sorted(values)}, in {pre_s!r} s = "
            f"{layout['jpegs'] / pre_s!r} img/s from start to end (PIL "
            f"decode at 448² on 8 threads, batches of 32 on the card, PNG "
            f"writes); {len(pre_calls)} segmenter calls, "
            f"{sum(pre_calls)!r} device ms in all; peak {pre_peak!r} GiB; "
            f"mean IoU against the layout's drawn masks {np.mean(ious)!r} "
            f"(min {min(ious)!r}; for information) ({smi})")
        if len(pngs) != layout["jpegs"] or not values <= {0, 255} or \
                shapes != {(224, 224)}:
            raise RuntimeError("cli.precompute_masks did not write a 0/255 "
                               "224² PNG for every JPEG")

        # 14c. cli.train --fold 0 from masks segmented on the card
        weights = tmp / "vit_base_patch16_224.pt"
        torch.save(timm_vit_base(SEED + 14), weights)
        config = tmp / "masks.yaml"
        config.write_text(json.dumps(masks_config(root, pretrained)))
        run_cli("cli.import_weights", import_cli.main, [
            "--weights", str(weights), "--config", str(config),
            "--output", str(pretrained)])
        cfg = load_config(str(config))
        epochs, evals = [], []
        train_epoch, evaluate = loop._train_epoch, loop._evaluate

        def timed_epoch(step, state, src, macro_bs, *args, **kwargs):
            torch.cuda.synchronize()
            before, t0, first = now(), time.perf_counter(), len(seg_calls)
            state, loss = train_epoch(step, state, src, macro_bs, *args,
                                      **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps = len(src) // macro_bs
            seg = seg_ms(seg_calls[first:])
            epochs.append({"s": dt, "steps": steps, "loss": loss,
                           "img_s": steps * macro_bs / dt,
                           "segment_calls": len(seg),
                           "segment_ms": float(np.mean(seg)) if seg else 0.0,
                           "per_step": {k: v / steps for k, v in
                                        delta(before).items()}})
            return state, loss

        def timed_eval(step, src, batch_size, *args, **kwargs):
            before, first = now(), len(seg_calls)
            out = evaluate(step, src, batch_size, *args, **kwargs)
            evals.append({"forwards": math.ceil(len(src) / batch_size),
                          "launches": delta(before),
                          "segment_calls": len(seg_calls) - first})
            return out

        with contextlib.ExitStack() as stack:
            plain = stack.enter_context(plain_calls(fa, ln))
            for module, name, fn in (
                    (loop, "_train_epoch", timed_epoch),
                    (loop, "_evaluate", timed_eval),
                    (pipeline, "segment_lesion_batch",
                     timed_segment(pipeline.segment_lesion_batch))):
                stack.enter_context(rebound(module, name, fn))
            before = now()
            train_s, _, train_peak = run_cli("cli.train", train_cli.main, [
                "--config", str(config), "--fold", "0", "--log", str(logs)])
            train_counts = delta(before)
        train_calls = seg_ms(seg_calls)
        seg_calls.clear()
        ens = np.load(logs / "ensemble_logits.npy")
        want_step = {k: 0.0 for k in fns} | {
            "K7": 12.0, "K8": 3.0, "K2": ACCUM * BLOCKS, "K3": ACCUM * BLOCKS,
            "K4": ACCUM * NORMS, "LN": ACCUM * NORMS}
        for i, e in enumerate(epochs):
            step_ms = e["s"] / e["steps"] * 1e3
            log(f"[masks] cli.train epoch {i + 1}: {e['steps']} steps in "
                f"{e['s']!r} s = {e['img_s']!r} train img/s synchronised, "
                f"loss {e['loss']!r}; the segmenter {e['segment_calls']} "
                f"calls of {e['segment_ms']!r} device ms on "
                f"({MICRO * ACCUM}, 272, 272, 3), "
                f"{e['segment_ms'] / step_ms!r} of a step's {step_ms!r} ms; "
                f"launches a step {only(e['per_step'])} ({smi})")
        log(f"[masks] 14c `python -m fedvit_torch.cli.train --fold 0` with "
            f"data.on_device_masks: {train_s!r} s from start to end; peak "
            f"{train_peak!r} GiB; launches {only(train_counts)}; plain "
            f"versions called {plain}; segmenter calls {len(train_calls)} "
            f"({sum(e['steps'] for e in epochs)} steps, "
            f"{sum(r['forwards'] for r in evals)} evaluation forwards); "
            f"ensemble_logits.npy {ens.shape}, finite "
            f"{bool(np.isfinite(ens).all())} ({smi})")
        bad_eval = [r for r in evals if r["segment_calls"] != r["forwards"]
                    or r["launches"] != serving_want(fns, r["forwards"])]
        if len(epochs) != ISIC_EPOCHS or any(
                e["per_step"] != want_step or e["segment_calls"] != e["steps"]
                or not math.isfinite(e["loss"]) for e in epochs) or \
                not evals or bad_eval or any(plain.values()) or \
                len(train_calls) != sum(e["steps"] for e in epochs) + sum(
                    r["forwards"] for r in evals):
            raise RuntimeError(f"cli.train with on-device masks did not run "
                               f"as it should: want {only(want_step)} and a "
                               f"segmenter call a step, {BLOCKS} K1 and a "
                               f"segmenter call a forward, no plain version, "
                               f"finite losses")
        if ens.shape != (ISIC_TEST, 8) or not np.isfinite(ens).all():
            raise RuntimeError("cli.train's ensemble logits are wrong")

        # 14d. cli.predict --isic_dir without TTA; --tta refused; a round
        argv = ["--config", str(config), "--isic_dir", str(root),
                "--checkpoint", str(logs / "fold0" / "best_fold0"),
                "--output", str(tmp / "predictions.csv"),
                "--logits_out", str(tmp / "predict_logits.npy")]
        with contextlib.ExitStack() as stack:
            plain = stack.enter_context(plain_calls(fa, ln))
            stack.enter_context(rebound(
                pipeline, "segment_lesion_batch",
                timed_segment(pipeline.segment_lesion_batch)))
            before = now()
            predict_s, _, predict_peak = run_cli("cli.predict",
                                                 predict_cli.main, argv)
            predict_counts = delta(before)
        predict_calls = seg_ms(seg_calls)
        seg_calls.clear()
        got = np.load(tmp / "predict_logits.npy")
        forwards = math.ceil(ISIC_TEST / cfg.training.batch_size)
        log(f"[masks] 14d `python -m fedvit_torch.cli.predict --isic_dir` "
            f"without TTA: {predict_s!r} s from start to end; peak "
            f"{predict_peak!r} GiB; launches {only(predict_counts)} in "
            f"{forwards} forwards; segmenter calls {len(predict_calls)}, "
            f"{np.mean(predict_calls)!r} device ms each on "
            f"({cfg.training.batch_size}, 272, 272, 3); plain versions "
            f"called {plain}; logits {got.shape}, finite "
            f"{bool(np.isfinite(got).all())}, RMS difference from "
            f"ensemble_logits.npy {rel_rms(got, ens)!r} x RMS logit ({smi})")
        if predict_counts != serving_want(fns, forwards) or \
                any(plain.values()) or \
                len(predict_calls) != forwards or \
                got.shape != (ISIC_TEST, 8) or not np.isfinite(got).all():
            raise RuntimeError("cli.predict with on-device masks did not run "
                               "as it should")
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                predict_cli.main(argv + ["--tta"])
        except ValueError as e:
            refusal = str(e)
        else:
            raise RuntimeError("cli.predict --tta ran on the 3-channel "
                               "canvases of on-device masks")
        log(f"[masks] 14d `cli.predict --tta` refused: ValueError({refusal!r})")
        if "on_device_masks" not in refusal:
            raise RuntimeError("cli.predict --tta was refused by another "
                               "error than the TTA refusal")

        fed_log = tmp / "fed"
        with contextlib.ExitStack() as stack:
            rec = stack.enter_context(fed_instruments(fa, ln))
            stack.enter_context(rebound(
                pipeline, "segment_lesion_batch",
                timed_segment(pipeline.segment_lesion_batch)))
            fed_s, printed, fed_peak = run_cli(
                "cli.train_federated", fed_cli.main, [
                    "--config", str(config), "--clients", str(MASK_CLIENTS),
                    "--rounds", "1", "--log", str(fed_log)])
        fed_calls = seg_ms(seg_calls)
        seg_calls.clear()
        history = json.loads((fed_log / "federated_history.json").read_text())
        launches = per_round(rec["counts"])
        steps = MASK_CLIENTS * MASK_STEPS
        eval_forwards = math.ceil(ISIC_TEST / cfg.training.batch_size)
        fed_want_ = {"K1": BLOCKS * eval_forwards, "K2": steps * BLOCKS,
                     "K3": steps * BLOCKS, "K4": steps * NORMS,
                     "LN": (steps + eval_forwards) * NORMS,
                     "K7": steps * 12, "K8": steps * 3}
        log(f"[masks] 14d `python -m fedvit_torch.cli.train_federated` on the "
            f"ISIC files with on-device masks ({MASK_CLIENTS} clients x "
            f"{MASK_STEPS} local steps of {cfg.training.batch_size}, 1 "
            f"round): {fed_s!r} s from start to end; peak {fed_peak!r} GiB; "
            f"launches {launches}, want {fed_want_}; segmenter calls "
            f"{len(fed_calls)} ({steps} local steps, {eval_forwards} "
            f"evaluation forwards); plain versions called {rec['plain']}; "
            f"history {history} ({smi})")
        if len(history) != 1 or not all(
                math.isfinite(history[0][k])
                for k in ("loss", "accuracy", "balanced_accuracy")) or \
                launches != [fed_want_] or any(rec["plain"].values()) or \
                len(fed_calls) != steps + eval_forwards:
            raise RuntimeError("the federated round with on-device masks did "
                               "not run as it should")
    log(f"[masks] phase 14 in {time.perf_counter() - phase_t0!r} s ({smi})")
    return {"launches": {k: {"train_cli": train_counts[k],
                             "predict_cli": predict_counts[k],
                             "federated_cli_round": launches[-1].get(k, 0)}
                         for k in path_kernels},
            "segment": segment}


# ---------------------------------------------------------------------------
# 15. The old generation on the card: a HybridViT on ViT-B/16@224 — the
#     Attention U-Net branch, the three fusions, MetadataEmbedding, the
#     LayerNorm head, JointLoss and named-view TTA
# ---------------------------------------------------------------------------

OLD_FUSIONS = ("attention", "concat", "cross_attention")
OLD_SERVE_IMAGES, OLD_SERVE_BATCH = 256, 64      # 4 forwards a fusion
OLD_SEG_WEIGHT = 0.3
OLD_XATTN_MICRO = 32         # the cross-attention step: macro 64 as 2 x 32
OLD_VIEWS = ("original", "hflip", "vflip", "crop_tl", "crop_br", "crop_center")
# K4's launches a micro-batch: the ViT's 25, the head's LayerNorm (D 512)
# and, with the cross-attention fusion, its LayerNorm (D 768)
OLD_NORMS = {"attention": NORMS + 1, "concat": NORMS + 1,
             "cross_attention": NORMS + 2}
# The old generation's LayerNorms give K4 fp32 rows (flax's
# nn.LayerNorm(dtype=float32) promotes its input): the head's at D 512 and
# the cross-attention's at D 768, 64 rows a micro-batch. Held and timed in
# fp32 and, beside it, bf16.
K4_OLD_SHAPES = ((64, 512), (64, 768))
# The seg mask of the kernel path against the plain attention path: no
# kernel is on the U-Net's path, so the two are the same computation; bit
# equality is expected, and where cuDNN picks another algorithm between the
# two calls, the RMS of the difference is held to 1e-3 of the RMS mask.
SEG_MASK_RTOL = 1e-3
# cuDNN's convolution kernels in a device profile (forward, data and weight
# gradients; the layout transposes around them): the U-Net's and the
# fusion's 1x1 convs (the ViT's patch embedding is a matmul)
CONV_NAMES = (r"fprop", r"dgrad", r"wgrad", r"conv", r"implicit_gemm",
              r"nchwToNhwc", r"nhwcToNchw")


def old_gen_raw(fusion, joint, micro=MICRO):
    """The HybridViT's YAML as a dict: ViT-B/16@224, bf16, the U-Net at its
    default channels, ``fusion``, ``metadata.style: embedding``, the
    LayerNorm head. ``joint``: JointLoss on 4-channel canvases
    (``loss.seg_weight`` 0.3, the mask a target), drop-path 0.1 and the
    phase-6 recipe at macro batch 2 x ``micro``; else 3-channel serving."""
    return {"data": {"use_segmentation_mask": joint},
            "model": {"backbone": "vit_base_patch16_224", "image_size": 224,
                      "compute_dtype": "bfloat16",
                      "drop_path_rate": 0.1 if joint else 0.0,
                      "segmentation": {"enabled": True, "fusion_type": fusion},
                      "metadata": {"style": "embedding"},
                      "classifier": {"layer_norm": True}},
            "loss": {"type": "asymmetric",
                     "seg_weight": OLD_SEG_WEIGHT if joint else 0.0},
            "training": {"batch_size": micro,
                         "gradient_accumulation_steps": ACCUM,
                         "optimizer": {"lr": 1e-4},
                         "scheduler": {"warmup_epochs": 0},
                         "llrd": {"decay_rate": 0.75, "head_lr_mult": 10.0},
                         "grad_clip": 1.0, "ema": {"decay": 0.9995}}}


def old_gen_model(cfg, seed):
    """The seeded HybridViT on the card, its weights moved by ``perturb``."""
    from fedvit_torch.models import build_model
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(seed))
    perturb(model, seed)
    return model


def settle_batchnorms(model, images):
    """Set the U-Net's BatchNorm running statistics to those of one
    training-mode forward of ``images`` (momentum 0 for that call), as
    training leaves them. With ``perturb``'s weights and untrained running
    statistics, evaluation scales the U-Net's activations by ~1.4 a layer,
    and its features would drown the backbone's in the concat and
    cross-attention fusions."""
    from fedvit_torch.models.unet import FlaxBatchNorm
    norms = [m for m in model.seg_branch.modules()
             if isinstance(m, FlaxBatchNorm)]
    for m in norms:
        m.momentum = 0.0
    model.seg_branch.train()
    with torch.no_grad():
        model.seg_branch(images)
    model.seg_branch.eval()
    for m in norms:
        m.momentum = 0.9


def canvases(n, channels, seed):
    """``n`` seeded 272² uint8 canvases (ViT-B/16@224's) with ``channels``
    channels (the 4th a mask), their labels and metadata, on the host."""
    from fedvit_torch.data.pipeline import ArrayDataSource
    data = serving_inputs(n, 272, seed).gather(np.arange(n))
    data["image"] = np.ascontiguousarray(data["image"][..., :channels])
    return ArrayDataSource(data)


def old_serving(fa, attention_from_qkvb, smi, fusion):
    """15a for one fusion type; returns K1's launches."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.data.pipeline import make_device_augment
    from fedvit_torch.eval.serve import _evaluate, _to_device, make_eval_step
    from fedvit_torch.ops import layer_norm as ln

    tag = f"old-serve {fusion}"
    cfg = from_dict(old_gen_raw(fusion, joint=False))
    model = old_gen_model(cfg, SEED + 15)
    source = canvases(OLD_SERVE_IMAGES, 3, SEED + 15)
    augment = make_device_augment(cfg, False)
    batch = augment(_to_device(source.gather(np.arange(OLD_SERVE_BATCH)),
                               torch.device("cuda")))
    settle_batchnorms(model, batch["image"])
    step = make_eval_step(model, cfg, augment=augment)
    _evaluate(step, source, OLD_SERVE_BATCH, cfg.num_classes)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, ln)
    t0 = time.perf_counter()
    served = _evaluate(step, source, OLD_SERVE_BATCH, cfg.num_classes)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = expect_launches(tag, fa, ln, OLD_SERVE_IMAGES // OLD_SERVE_BATCH,
                               OLD_NORMS[fusion])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with attention_replaced_by(attention_from_qkvb):
        plain = _evaluate(step, source, OLD_SERVE_BATCH, cfg.num_classes)
    compare_logits(tag, served["logits"], plain["logits"])
    with attention_replaced_by(
            lambda qkv, bias, h: attention_from_qkvb(qkv, bias * 0, h)):
        no_bias = _evaluate(step, source, OLD_SERVE_BATCH, cfg.num_classes)
    control = rel_rms(no_bias["logits"], plain["logits"])
    log(f"[{tag}] control, plain attention without the qkv bias: RMS error "
        f"{control!r} x RMS logit (must exceed {LOGITS_RTOL_BF16!r})")
    if not control > LOGITS_RTOL_BF16:
        raise RuntimeError(f"{tag}: the logits check cannot tell a dropped "
                           f"qkv bias")
    with torch.inference_mode():
        got = model(batch["image"], batch["metadata"])
        with attention_replaced_by(attention_from_qkvb):
            want = model(batch["image"], batch["metadata"])
    mask, ref = got["seg_mask"].float(), want["seg_mask"].float()
    same = bool(torch.equal(mask, ref))
    err = float((mask - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    log(f"[{tag}] seg_mask {tuple(mask.shape)} finite "
        f"{bool(torch.isfinite(mask).all())}, kernel path against plain path: "
        f"bit-equal {same}, RMS error {err!r} x RMS mask (limit "
        f"{SEG_MASK_RTOL!r} where not bit-equal); features "
        f"{tuple(got['features'].shape)}")
    if mask.shape != (OLD_SERVE_BATCH, 224, 224, 1) or \
            not bool(torch.isfinite(mask).all()) or not err <= SEG_MASK_RTOL:
        raise RuntimeError(f"{tag}: the seg mask is wrong or moves with the "
                           f"attention path")
    img_s = OLD_SERVE_IMAGES / serve_s
    log(f"[{tag}] HybridViT (ViT-B/16@224 + Attention U-Net, {fusion} "
        f"fusion, MetadataEmbedding, LayerNorm head) bf16 3ch bs "
        f"{OLD_SERVE_BATCH}: {OLD_SERVE_IMAGES} images in {serve_s!r} s = "
        f"{img_s!r} img/s, peak {peak!r} GiB ({smi})")
    return launches


def old_train(fa, ln, attention_from_qkvb, smi, fusion, micro, n_timed,
              check, trace=False):
    """15b: the JointLoss step of the HybridViT with ``fusion`` at macro
    batch 2 x ``micro`` of 4-channel uint8 canvases through the fused train
    augment: 1 warm-up step and ``n_timed`` timed ones, their launches held
    a step; with ``check``, the gradient gate, the seg term and the JointLoss
    control; with ``trace``, a profile of one step. Returns the launches a
    step."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.data.pipeline import make_device_augment
    from fedvit_torch.eval.serve import _to_device
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    from fedvit_torch.train import losses
    from fedvit_torch.train import step as step_module
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step

    tag = f"old-train {fusion}"
    raw = old_gen_raw(fusion, joint=True, micro=micro)
    cfg = from_dict(copy.deepcopy(raw))
    model = old_gen_model(cfg, SEED + 15)
    tx, _ = build_optimizer(cfg, model, steps_per_epoch=100)
    state = TrainState.create(model, tx, seed=SEED)
    augment = make_device_augment(cfg, True)
    step = make_train_step(cfg, build_loss(cfg), augment=augment)
    macro = micro * ACCUM
    source = canvases((1 + n_timed) * macro, 4, SEED + 16)
    batches = [_to_device(source.gather(np.arange(i * macro, (i + 1) * macro)),
                          torch.device("cuda")) for i in range(1 + n_timed)]
    fns = counted(fa, ln) | {"K7": rs.shift_cuda, "K8": ra.equalize_cuda}

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    still = [n for n, p in model.named_parameters()
             if torch.equal(p, before[n]) and not n.startswith("metadata_branch.")]
    log(f"[{tag}] warm-up step: loss {float(m['loss'])!r}, grad_norm "
        f"{float(m['grad_norm'])!r}; parameters outside the metadata "
        f"embedding (which no entry point runs) that did not move: {still[:5]}")
    if still or not math.isfinite(float(m["loss"])):
        raise RuntimeError(f"{tag}: the warm-up step did not move the "
                           f"parameters or its loss is not finite")
    del before
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = []
    for batch in batches[1:]:
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = {k: fn.launches / n_timed for k, fn in fns.items()}
    want = {k: 0.0 for k in fns} | {
        "K2": ACCUM * BLOCKS, "K3": ACCUM * BLOCKS,
        "K4": ACCUM * OLD_NORMS[fusion], "LN": ACCUM * OLD_NORMS[fusion],
        "K7": 12.0, "K8": 3.0}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses_ = [float(m["loss"]) for m in metrics]
    log(f"[{tag}] launches a step over {n_timed} steps: "
        f"{({k: v for k, v in counts.items() if v})} (want "
        f"{({k: v for k, v in want.items() if v})}); losses {losses_}")
    if counts != want or not all(map(math.isfinite, losses_)):
        raise RuntimeError(f"{tag}: the step did not launch the kernels as it "
                           f"should, or its loss is not finite")
    img_s = n_timed * macro / train_s
    log(f"[{tag}] JointLoss step (seg_weight {OLD_SEG_WEIGHT}), HybridViT "
        f"ViT-B/16@224 + Attention U-Net, {fusion} fusion, bf16, 4ch uint8 "
        f"272² canvases through the fused train augment, macro batch {macro} "
        f"({ACCUM} x {micro}): {n_timed} steps in {train_s!r} s = {img_s!r} "
        f"img/s, {train_s / n_timed * 1e3!r} ms/step, peak {peak!r} GiB "
        f"({smi})")
    if trace:
        trace_training(f"profile-{tag}", step, state, batches[2], smi, {
            "K2": K2_NAMES, "K3": K3_NAMES, "K4": K4_NAMES,
            "convolutions (cuDNN)": CONV_NAMES})
    if not check:
        return counts

    # the gradients, kernels against the plain attention and LayerNorm
    # backward, with K3's bias gradient zeroed as the control. The U-Net and
    # the fusion's seg side take the classification loss's gradient through
    # the fusion's pooled map, sums over the backbone's features that cancel,
    # so each leaf is allowed its own rounding noise as well, measured as in
    # phase 8 against the plain path with its attention computed in fp32.
    # The seg term of each path is recorded.
    seg_terms = []

    def recording(seg_mask, target):
        value = losses.bce_dice_loss(seg_mask, target)
        seg_terms.append((seg_mask.detach().clone(), target.detach().clone(),
                          value.detach().clone()))
        return value

    def plain_fp32(qkv, bias, heads):
        return attention_from_qkvb(qkv.float(), bias.float(), heads).to(
            qkv.dtype)

    with rebound(step_module, "bce_dice_loss", recording):
        got = grads_by_path(model, state, step, batches[1], {
            "kernel": (),
            "plain": (attention_replaced_by(attention_from_qkvb),
                      layer_norm_backward_replaced_by(ln.ln_bwd_plain)),
            "fp32": (attention_replaced_by(plain_fp32),
                     layer_norm_backward_replaced_by(ln.ln_bwd_plain)),
            "control": (attention_replaced_by(k3_without_dbias(fa)),)})
    meta = [n for n in got["plain"][0] if n.startswith("metadata_branch.")]
    if any(float(got[p][0][n].abs().max()) for p in got for n in meta):
        raise RuntimeError(f"{tag}: the metadata embedding, which no entry "
                           f"point runs, has a gradient")
    for grads, _ in got.values():          # exactly 0 on every path
        for n in meta:
            del grads[n]
    compare_grads(tag, got, GRAD_RTOL_BF16,
                  [n for n in got["plain"][0] if n.endswith("attn.qkv.bias")],
                  "K3's dbias zeroed", zero_grad=(),
                  report=("attn.qkv.bias", "classifier.0.weight",
                          "classifier.2.weight", "conv1.weight",
                          "bn2.weight", "seg_proj1.weight"))
    for prefix in ("seg_branch.", "fusion."):
        group = [n for n in got["plain"][0] if n.startswith(prefix)]
        errs = [rel_rms(got["kernel"][0][n].cpu().numpy(),
                        got["plain"][0][n].cpu().numpy()) for n in group]
        log(f"[{tag}]   {prefix}* {len(group)} leaves: error median "
            f"{float(np.median(errs))!r}, largest {max(errs)!r}")
    # the seg term: 4 paths x ACCUM micro-batches recorded; the kernel path's
    # first ACCUM recomputed from its own seg_mask and target
    worst = 0.0
    for seg_mask, target, value in seg_terms[:ACCUM]:
        again = losses.bce_dice_loss(seg_mask, target)
        worst = max(worst, abs(float(again) - float(value)))
        in_range = bool(((target >= 0) & (target <= 1)).all())
        if seg_mask.shape != (micro, 224, 224, 1) or \
                target.shape != seg_mask.shape or not in_range:
            raise RuntimeError(f"{tag}: the seg term's mask or target is "
                               f"wrong: {tuple(seg_mask.shape)}, "
                               f"{tuple(target.shape)}, in [0, 1] {in_range}")
    log(f"[{tag}] seg term: {len(seg_terms)} calls (4 paths x {ACCUM} "
        f"micro-batches); the kernel path's {[float(v) for _, _, v in seg_terms[:ACCUM]]} "
        f"against bce_dice_loss recomputed on its own seg_mask and target: "
        f"largest |difference| {worst!r}; target in [0, 1], its mean "
        f"{float(seg_terms[0][1].mean())!r}")
    if len(seg_terms) != 4 * ACCUM or worst != 0.0:
        raise RuntimeError(f"{tag}: the seg term is not bce_dice_loss of the "
                           f"step's seg_mask and target")
    # the JointLoss control: the same model (3 channels, the mask a target)
    # and batch through a step built with seg_weight 0
    off_raw = copy.deepcopy(raw)
    off_raw["loss"]["seg_weight"] = 0.0
    off_cfg = from_dict(off_raw)
    off = make_train_step(off_cfg, build_loss(off_cfg), augment=augment)
    zero = grads_by_path(model, state, off, batches[1], {"off": ()})
    leaf = "seg_branch.decoder.final_conv.weight"
    on_g = float(got["kernel"][0][leaf].abs().max())
    off_g = float(zero["off"][0][leaf].abs().max())
    log(f"[{tag}] JointLoss control: {leaf} max |grad| {on_g!r} at seg_weight "
        f"{OLD_SEG_WEIGHT}, {off_g!r} from a step built with seg_weight 0 "
        f"(must be exactly 0); seg_weight of the steps {step.seg_weight} and "
        f"{off.seg_weight}")
    if off_g != 0.0 or not on_g > 0.0 or off.seg_weight != 0.0:
        raise RuntimeError(f"{tag}: the JointLoss control failed")
    return counts


def old_cli(fa, ln, smi, tmp):
    """15c: the user's path on phase 13's ISIC layout under ``tmp``;
    returns the launches by entry point."""
    from fedvit_torch.cli import predict as predict_cli
    from fedvit_torch.cli import train as train_cli
    from fedvit_torch.core.config import load_config
    from fedvit_torch.eval import serve
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    from fedvit_torch.train import loop

    root, work = tmp / "ISIC", tmp / "old_gen"
    work.mkdir()
    fns = counted(fa, ln) | {"K7": rs.shift_cuda, "K8": ra.equalize_cuda}

    def now():
        return {k: fn.launches for k, fn in fns.items()}

    def only(counts):
        return {k: v for k, v in counts.items() if v}

    raw = isic_config(root, tmp / "pretrained")
    del raw["model"]["pretrained_path"]
    raw["model"].update({"pretrained": False,
                         "segmentation": {"enabled": True,
                                          "fusion_type": "attention"},
                         "metadata": {"style": "embedding"},
                         "classifier": {"layer_norm": True}})
    raw["loss"] = {"seg_weight": OLD_SEG_WEIGHT}
    raw["training"].update({"epochs": 1, "two_stage": {
        "enabled": True, "stage1_epochs": 1}})
    config = work / "joint.yaml"
    config.write_text(json.dumps(raw))
    cfg = load_config(str(config))

    # cli.train --fold 0: stage 1 (the backbone frozen), stage 2, TTA test
    calls = []

    def counting(kind, fn, units):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = now(), time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append({"kind": kind, "s": time.perf_counter() - t0,
                          "units": units(*args, **kwargs),
                          "launches": {k: v - before[k]
                                       for k, v in now().items()}})
            return out
        return wrapped

    def epoch_steps(step, state, src, macro_bs, *args, **kwargs):
        return len(src) // macro_bs

    def eval_forwards(step, src, batch_size, *args, **kwargs):
        return math.ceil(len(src) / batch_size)

    def tta_forwards(cfg_, model, src, batch_size=None):
        return math.ceil(len(src) / (batch_size or max(
            1, cfg_.training.batch_size // 4)))

    with contextlib.ExitStack() as stack:
        plain = stack.enter_context(plain_calls(fa, ln))
        for name, kind, units in (("_train_epoch", "epoch", epoch_steps),
                                  ("_evaluate", "validation", eval_forwards),
                                  ("evaluate_with_tta", "tta", tta_forwards)):
            stack.enter_context(rebound(loop, name, counting(
                kind, getattr(loop, name), units)))
        before = now()
        train_s, _, train_peak = run_cli("cli.train", train_cli.main, [
            "--config", str(config), "--fold", "0", "--log",
            str(work / "log")])
        train_counts = {k: v - before[k] for k, v in now().items()}
    fold_log = (work / "log" / "fold0" / "train_fold0.log").read_text()
    for line in fold_log.splitlines():
        if any(s in line for s in ("[stage1]", " E0", "Fold 0 Test")):
            log(f"[old-cli] cli.train: {line.split(' | ', 1)[-1].strip()}")
    norms = OLD_NORMS["attention"]
    want_step = {k: 0 for k in fns} | {
        "K2": ACCUM * BLOCKS, "K3": ACCUM * BLOCKS, "K4": ACCUM * norms,
        "LN": ACCUM * norms, "K7": 12, "K8": 3}
    bad = []
    for c in calls:
        per = ({k: v / c["units"] for k, v in c["launches"].items()}
               if c["kind"] == "epoch" else c["launches"])
        want = (want_step if c["kind"] == "epoch" else
                serving_want(fns, c["units"], norms))
        log(f"[old-cli] cli.train {c['kind']}: {c['units']} "
            f"{'steps' if c['kind'] == 'epoch' else 'forwards'} in "
            f"{c['s']!r} s; launches {'a step ' if c['kind'] == 'epoch' else ''}"
            f"{only(per)} ({smi})")
        if per != want:
            bad.append(c["kind"])
    kinds = [c["kind"] for c in calls]
    ens = np.load(work / "log" / "ensemble_logits.npy")
    log(f"[old-cli] 15c `python -m fedvit_torch.cli.train --fold 0` (JointLoss, "
        f"two-stage: 1 epoch with the backbone frozen, then 1): {train_s!r} s "
        f"from start to end; peak {train_peak!r} GiB; calls {kinds}; launches "
        f"{only(train_counts)}; plain versions called {plain}; "
        f"ensemble_logits.npy {ens.shape} finite "
        f"{bool(np.isfinite(ens).all())} ({smi})")
    if bad or kinds.count("epoch") != 2 or "tta" not in kinds or \
            any(plain.values()) or ens.shape != (ISIC_TEST, 8) or \
            not np.isfinite(ens).all():
        raise RuntimeError(f"cli.train on the HybridViT did not run or launch "
                           f"as it should: {bad}")

    # cli.predict --isic_dir --tta on the fold's best checkpoint (8 views of
    # 4-channel canvases; the model slices the mask off)
    with plain_calls(fa, ln) as plain:
        before = now()
        predict_s, _, predict_peak = run_cli("cli.predict", predict_cli.main, [
            "--config", str(config), "--isic_dir", str(root),
            "--checkpoint", str(work / "log" / "fold0" / "best_fold0"),
            "--tta", "--output", str(work / "joint.csv"),
            "--logits_out", str(work / "joint.npy")])
        predict_counts = {k: v - before[k] for k, v in now().items()}
    got = np.load(work / "joint.npy")
    forwards = math.ceil(ISIC_TEST / cfg.training.batch_size)
    log(f"[old-cli] `python -m fedvit_torch.cli.predict --isic_dir --tta` on "
        f"best_fold0: {predict_s!r} s from start to end; peak "
        f"{predict_peak!r} GiB; launches {only(predict_counts)} for "
        f"{forwards} forwards of 8 views; plain versions called {plain}; "
        f"logits {got.shape} finite {bool(np.isfinite(got).all())} ({smi})")
    if predict_counts != serving_want(fns, forwards, norms) or \
            any(plain.values()) or \
            got.shape != (ISIC_TEST, 8) or not np.isfinite(got).all():
        raise RuntimeError(f"cli.predict --tta on the HybridViT did not launch "
                           f"K1 and the LayerNorm forward alone, {BLOCKS} and "
                           f"{norms} a forward, or its logits are wrong")

    # cli.predict --tta with the named views, 3-channel canvases, from a .pt
    # state dict of the seeded HybridViT
    named = copy.deepcopy(raw)
    named["data"]["use_segmentation_mask"] = False
    named["loss"] = {"seg_weight": 0.0}
    named["training"]["tta"] = {"views": list(OLD_VIEWS)}
    named_config = work / "named.yaml"
    named_config.write_text(json.dumps(named))
    named_cfg = load_config(str(named_config))
    model = old_gen_model(named_cfg, SEED + 17)
    torch.save(model.state_dict(), work / "hybrid_vit.pt")
    del model
    with contextlib.ExitStack() as stack:
        plain = stack.enter_context(plain_calls(fa, ln))
        shapes = stack.enter_context(k1_inputs())
        before = now()
        named_s, _, named_peak = run_cli("cli.predict", predict_cli.main, [
            "--config", str(named_config), "--isic_dir", str(root),
            "--checkpoint", str(work / "hybrid_vit.pt"), "--tta",
            "--output", str(work / "named.csv"),
            "--logits_out", str(work / "named.npy")])
        named_counts = {k: v - before[k] for k, v in now().items()}
        rows = sorted(s[0] for s in shapes)
    logits = np.load(work / "named.npy")
    bs = named_cfg.training.batch_size
    log(f"[old-cli] `python -m fedvit_torch.cli.predict --isic_dir --tta` with "
        f"training.tta.views {list(OLD_VIEWS)}, 3-channel canvases, a .pt "
        f"state dict: {named_s!r} s from start to end; peak {named_peak!r} "
        f"GiB; launches {only(named_counts)}; K1's batch rows {rows} (views x "
        f"batch {bs}); plain versions called {plain}; logits {logits.shape} "
        f"finite {bool(np.isfinite(logits).all())} ({smi})")
    if named_counts != serving_want(fns, forwards, norms) or \
            any(plain.values()) or \
            rows != [len(OLD_VIEWS) * bs] or \
            logits.shape != (ISIC_TEST, 8) or not np.isfinite(logits).all():
        raise RuntimeError("named-view TTA did not run 6 views a row through "
                           "K1, or its logits are wrong")
    return {k: {"train_cli": train_counts[k], "predict_cli": predict_counts[k],
                "named_view_predict": named_counts[k]}
            for k in ("K1", "K2", "K3", "K4", "LN", "K7", "K8")}


def old_gen_phase(fa, ln, smi, tmp, trace=False):
    """Phase 15 (with ``trace``, a profile of one JointLoss step); returns
    the launches of K1-K4, the LayerNorm forward, K7 and K8 by path
    ("launches") and K4's records at the old generation's widths ("k4")."""
    from fedvit_torch.ops.attention import attention_from_qkvb

    phase_t0 = time.perf_counter()
    launches = {k: {} for k in ("K1", "K2", "K3", "K4", "LN", "K7", "K8")}
    # 15a. serving, each fusion type
    for fusion in OLD_FUSIONS:
        launches["K1"][f"serve_{fusion}"] = old_serving(
            fa, attention_from_qkvb, smi, fusion)
        torch.cuda.empty_cache()
    # 15b. the JointLoss step; the cross-attention's at 2 x 32
    counts = old_train(fa, ln, attention_from_qkvb, smi, "attention", MICRO,
                       TIMED_STEPS, check=True, trace=trace)
    torch.cuda.empty_cache()
    xcounts = old_train(fa, ln, attention_from_qkvb, smi, "cross_attention",
                        OLD_XATTN_MICRO, 1, check=False)
    torch.cuda.empty_cache()
    for k in ("K2", "K3", "K4", "LN", "K7", "K8"):
        launches[k]["step_attention"] = counts[k]
        launches[k]["step_cross_attention"] = xcounts[k]
    # 15c. the user's path
    for k, v in old_cli(fa, ln, smi, tmp).items():
        launches[k].update(v)
    # K4 at the widths the old generation adds
    k4 = []
    for shape in K4_OLD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            rec = check_k4(ln, shape, dtype, True)
            k4.append({"shape": list(shape), "dtype": short(dtype), **rec})
    log(f"[old] phase 15 in {time.perf_counter() - phase_t0!r} s ({smi})")
    return {"launches": launches, "k4": k4}


# ---------------------------------------------------------------------------
# 16. What a JAX YAML reached that the port refused: model.remat, the plain
#     attention options, cli/verify, cli/train --profile (utils/profiling)
# ---------------------------------------------------------------------------

REMAT_TIMED = 3              # timed steps each way, after one warm-up step
REMAT_DROP_PATH = 0.1
# Remat's gradients against the same step's without, from one state: the
# recomputation runs the same kernels on the same inputs, so the two are
# expected bit-equal (no kernel of the port uses atomics; cuBLAS picks its
# algorithm by shape). Where a leaf is not, it is held to phase 8's leaf
# limit, and the leaves that differ are printed with their errors.
REMAT_LEAF_RTOL = SWIN_GRAD_RTOL_BF16
# The SwinV2-L@384 shapes of 16a, (micro-batch, accumulation): phase 8's and
# the 16-image micro-batch that only remat is expected to fit
SWIN_REMAT_SHAPES = ((SWIN_MICRO, SWIN_ACCUM), (2 * SWIN_MICRO, 1))
# The trace of ``cli.train --profile``: the kernels of a fold step that it
# must name (K1 runs in validation, outside the traced steps)
PROFILE_KERNELS = {"K2": K2_NAMES, "K3": K3_NAMES, "K4": K4_NAMES,
                   "K7": ("shift_kernel",), "K8": ("equalize_kernel",)}
VERIFY_CHECKS = 14


@contextlib.contextmanager
def remat_set(model, on: bool):
    """Inside the block the model's transformer blocks are rematerialised
    (``on``) or not: the ``remat`` flag of each module that holds one (the
    ViT, each SwinV2 stage), which ``build_model`` sets from
    ``model.remat``."""
    mods = [m for m in model.modules()
            if isinstance(getattr(m, "remat", None), bool)]
    if not mods:
        raise RuntimeError("the model holds no remat flag")
    before = [m.remat for m in mods]
    for m in mods:
        m.remat = on
    try:
        yield
    finally:
        for m, b in zip(mods, before):
            m.remat = b


def remat_same_result(tag, model, state, step, batch) -> dict:
    """One macro batch's gradients, loss and the generator's state after
    them, without and with remat from one state (generators, buffers):
    bit-equal, else each leaf within REMAT_LEAF_RTOL and the generator's
    state equal. Leaves the state and the buffers as it found them."""
    snap = (state.generator.get_state(),
            copy.deepcopy(state.np_rng.bit_generator.state),
            {n: t.clone() for n, t in model.named_buffers()})

    def restore():
        state.generator.set_state(snap[0])
        state.np_rng.bit_generator.state = copy.deepcopy(snap[1])
        with torch.no_grad():
            for n, t in model.named_buffers():
                t.copy_(snap[2][n])

    got = {}
    for on in (False, True):
        restore()
        with remat_set(model, on):
            grads, loss, _ = step.accumulate_grads(state, batch)
        got[on] = ({n: g.clone() for n, g in grads.items()}, loss.clone(),
                   state.generator.get_state())
        for p in model.parameters():
            p.grad = None
    restore()
    (g0, l0, s0), (g1, l1, s1) = got[False], got[True]
    differ = {n: rel_rms(g1[n].float().cpu().numpy(),
                         g0[n].float().cpu().numpy())
              for n in g0 if not torch.equal(g0[n], g1[n])}
    same_loss, same_gen = bool(torch.equal(l0, l1)), bool(torch.equal(s0, s1))
    loss_err = abs(float(l1) - float(l0)) / abs(float(l0))
    log(f"[{tag}] remat against no remat, one macro batch from one state: "
        f"loss {float(l0)!r} vs {float(l1)!r} (bit-equal {same_loss}); "
        f"{len(differ)} of {len(g0)} gradient leaves differ in their bits"
        f"{f', by kind (count, largest RMS error / RMS grad) {group_max(differ)}' if differ else ''}"
        f"; the generator's state after the step bit-equal {same_gen}")
    over = {n: e for n, e in differ.items() if not e <= REMAT_LEAF_RTOL}
    if not same_gen or over or not loss_err <= REMAT_LEAF_RTOL:
        raise RuntimeError(f"{tag}: remat changes the step's result: "
                           f"generator {same_gen}, loss {loss_err!r}, leaves "
                           f"over {REMAT_LEAF_RTOL!r}: {over}")
    return {"bit_equal": same_loss and not differ,
            "leaves_differ": len(differ),
            "largest_leaf_err": max(differ.values(), default=0.0)}


def remat_timed(tag, what, fns, smi, state, step, batches, want) -> dict:
    """A warm-up step on ``batches[0]``, then one timed step on each of the
    others: ms/step and peak memory over the timed steps, their launches a
    step held to ``want``, finite losses."""
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    for batch in batches[1:]:
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = len(batches) - 1
    counts = {k: fn.launches / n for k, fn in fns.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    macro = batches[0]["image"].shape[0]
    got = {k: v for k, v in counts.items() if v}
    log(f"[{tag}] {what}, macro batch {macro} ({step.accum} x "
        f"{macro // step.accum}): {n} steps after a warm-up in {dt!r} s = "
        f"{dt / n * 1e3!r} ms/step, {n * macro / dt!r} img/s, peak {peak!r} "
        f"GiB; launches a step {got} (want "
        f"{({k: v for k, v in want.items() if v})}); losses {losses} ({smi})")
    if counts != want or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"{tag}: the step did not launch the kernels as it "
                           f"should, or its loss is not finite")
    return {"ms_step": dt / n * 1e3, "img_s": n * macro / dt,
            "peak_gib": peak, "launches_step": got}


def remat_pair(tag, what, fns, smi, model, state, step, batches, want,
               check=True) -> dict:
    """16a at one shape: the same-result gate (with ``check``), then the
    timed steps without and with remat; remat's peak must be below the
    peak without. ``want(on)`` gives the launches a step."""
    rec = {"same_result": remat_same_result(tag, model, state, step,
                                            batches[0])} if check else {}
    for on in (False, True):
        with remat_set(model, on):
            rec["remat" if on else "no_remat"] = remat_timed(
                f"{tag}{' remat' if on else ''}",
                f"{what}{', remat' if on else ''}", fns, smi, state, step,
                batches, want(on))
    off, on = rec["no_remat"]["peak_gib"], rec["remat"]["peak_gib"]
    log(f"[{tag}] peak {on!r} GiB with remat against {off!r} without "
        f"({on / off!r}x); ms/step {rec['remat']['ms_step']!r} against "
        f"{rec['no_remat']['ms_step']!r} "
        f"({rec['remat']['ms_step'] / rec['no_remat']['ms_step']!r}x) ({smi})")
    if not on < off:
        raise RuntimeError(f"{tag}: remat did not lower the peak memory")
    return rec


def remat_phase(fa, ln, smi) -> dict:
    """16a: ViT-B/16@224 at 2 x 64, the JointLoss HybridViT at 2 x 64 and
    SwinV2-L@384 at 8 x 2 and 16 x 1, each built with ``model.remat: true``
    and run without and with it; serving a remat ViT-B. Returns the records
    by shape and the launches by path."""
    import dataclasses

    from fedvit_torch.core.config import from_dict
    from fedvit_torch.data.pipeline import make_device_augment
    from fedvit_torch.eval.serve import _to_device
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step

    fns = counted(fa, ln) | {"K7": rs.shift_cuda, "K8": ra.equalize_cuda}
    zero = {k: 0.0 for k in fns}
    records = {}

    # ViT-B/16@224 at 2 x 64 (phase 6's recipe, drop-path 0.1)
    cfg, model, state, step, batches = training_setup(
        "vit_base_patch16_224", 224, MICRO, ACCUM, REMAT_DROP_PATH, 0.75,
        remat=True, n_batches=1 + REMAT_TIMED)
    records["vit_b_2x64"] = remat_pair(
        "remat vit-b", "ViT-B/16@224 bf16 4ch+meta", fns, smi, model, state,
        step, batches, lambda on: zero | {
            "K2": ACCUM * BLOCKS * (1 + on), "K3": ACCUM * BLOCKS,
            "K4": ACCUM * NORMS, "LN": ACCUM * (NORMS + 2 * BLOCKS * on)})
    # serving the remat model: no checkpoint, so K1 and no K2
    model.eval()
    for fn in fns.values():
        fn.launches = 0
    with torch.inference_mode():
        model(batches[0]["image"][:MICRO], batches[0]["metadata"][:MICRO])
    served = {k: fn.launches for k, fn in fns.items() if fn.launches}
    log(f"[remat vit-b] serving the remat model, one forward of {MICRO}: "
        f"launches {served} (want {{'K1': {BLOCKS}, 'LN': {NORMS}}})")
    if served != {"K1": BLOCKS, "LN": NORMS}:
        raise RuntimeError("serving a remat model does not launch K1 and the "
                           "LayerNorm forward alone")
    records["vit_b_serve_launches"] = served
    del cfg, model, state, step, batches
    torch.cuda.empty_cache()

    # the JointLoss HybridViT at 2 x 64 through the fused train augment
    raw = old_gen_raw("attention", joint=True)
    raw["model"]["remat"] = True
    cfg = from_dict(raw)
    model = old_gen_model(cfg, SEED + 16)
    tx, _ = build_optimizer(cfg, model, steps_per_epoch=100)
    state = TrainState.create(model, tx, seed=SEED)
    step = make_train_step(cfg, build_loss(cfg),
                           augment=make_device_augment(cfg, True))
    macro = MICRO * ACCUM
    source = canvases((1 + REMAT_TIMED) * macro, 4, SEED + 16)
    batches = [_to_device(source.gather(np.arange(i * macro, (i + 1) * macro)),
                          torch.device("cuda"))
               for i in range(1 + REMAT_TIMED)]
    records["joint_loss_2x64"] = remat_pair(
        "remat joint-loss", "JointLoss HybridViT (ViT-B/16@224 + Attention "
        "U-Net, attention fusion) bf16, 4ch uint8 272² canvases through the "
        "fused train augment", fns, smi, model, state, step, batches,
        lambda on: zero | {
            "K2": ACCUM * BLOCKS * (1 + on), "K3": ACCUM * BLOCKS,
            "K4": ACCUM * OLD_NORMS["attention"],
            "LN": ACCUM * (OLD_NORMS["attention"] + 2 * BLOCKS * on),
            "K7": 12.0, "K8": 3.0})
    del cfg, model, state, step, batches, source
    torch.cuda.empty_cache()

    # SwinV2-L@384 at 8 x 2 and 16 x 1, the same macro batches of 16
    cfg, model, state, step, batches = training_setup(
        SWIN, SWIN_SIZE, SWIN_MICRO, SWIN_ACCUM, REMAT_DROP_PATH, SWIN_LLRD,
        remat=True, n_batches=1 + REMAT_TIMED)
    blocks, norms = sum(SWIN_DEPTHS), sum(SWIN_NORMS)

    def swin_want(accum):     # remat recomputes the blocks' two LayerNorms
        return lambda on: zero | {"K5_lse": accum * blocks * (1 + on),
                                  "K6": accum * blocks, "K4": accum * norms,
                                  "LN": accum * (norms + 2 * blocks * on)}

    what = "SwinV2-L@384 bf16 4ch+meta"
    records["swinv2_l_8x2"] = remat_pair(
        "remat swinv2-l 8x2", what, fns, smi, model, state, step, batches,
        swin_want(SWIN_ACCUM))
    micro16, accum16 = SWIN_REMAT_SHAPES[1]
    cfg16 = cfg.replace(training=dataclasses.replace(
        cfg.training, batch_size=micro16,
        gradient_accumulation_steps=accum16))
    step16 = make_train_step(cfg16, build_loss(cfg16))
    rec16 = {}
    with remat_set(model, True):
        rec16["remat"] = remat_timed(
            "remat swinv2-l 16x1 remat", f"{what}, remat", fns, smi, state,
            step16, batches, swin_want(accum16)(True))
    # without remat: whether a micro-batch of 16 fits at all
    fits = True
    with remat_set(model, False):
        try:
            rec16["no_remat"] = remat_timed(
                "remat swinv2-l 16x1", what, fns, smi, state, step16,
                batches, swin_want(accum16)(False))
        except torch.cuda.OutOfMemoryError as e:
            fits = False
            reached = torch.cuda.max_memory_allocated() / 2 ** 30
            message = str(e).splitlines()[0]
    if not fits:
        for p in model.parameters():
            p.grad = None
        torch.cuda.empty_cache()
        rec16["no_remat"] = {"fits": False, "peak_gib_at_failure": reached}
        log(f"[remat swinv2-l 16x1] without remat a micro-batch of 16 does "
            f"not fit: out of memory at {reached!r} GiB allocated "
            f"({message[:200]}) ({smi})")
    on = rec16["remat"]["peak_gib"]
    off = rec16["no_remat"].get("peak_gib")
    log(f"[remat swinv2-l 16x1] peak with remat {on!r} GiB; without "
        f"{'did not fit' if off is None else repr(off) + ' GiB'} "
        f"(the card: {torch.cuda.get_device_properties(0).total_memory / 2 ** 30!r} "
        f"GiB) ({smi})")
    if off is not None and not on < off:
        raise RuntimeError("remat did not lower SwinV2-L's peak at 16 x 1")
    records["swinv2_l_16x1"] = rec16
    del cfg, cfg16, model, state, step, step16, batches
    torch.cuda.empty_cache()
    launches = {}
    for shape, rec in records.items():
        for way in ("no_remat", "remat"):
            for k, v in rec.get(way, {}).get("launches_step", {}).items():
                launches.setdefault(k, {})[f"{shape}_{way}_a_step"] = v
    launches["K1"] = {"vit_b_remat_serve_a_forward":
                      records["vit_b_serve_launches"]["K1"]}
    return {"records": records, "launches": launches}


def serve_once(tag, fa, ln, smi, model, cfg, source, batch):
    """One serving batch of ``batch`` images through ``_evaluate`` after a
    warm-up: (logits, img/s, peak GiB, launches)."""
    from fedvit_torch.data.pipeline import make_device_augment
    from fedvit_torch.eval.serve import _evaluate, make_eval_step

    step = make_eval_step(model, cfg, augment=make_device_augment(cfg, False))
    _evaluate(step, source, batch, cfg.num_classes)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, ln)
    t0 = time.perf_counter()
    out = _evaluate(step, source, batch, cfg.num_classes)
    torch.cuda.synchronize()
    img_s = batch / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {k: v for k, v in launch_counts(fa, ln).items() if v}
    log(f"[{tag}] serving, one batch of {batch}: {img_s!r} img/s, peak "
        f"{peak!r} GiB, launches {counts} ({smi})")
    return out["logits"], img_s, peak, counts


def plain_attention_phase(fa, ln, smi) -> dict:
    """16b: ViT-B/16@224 with ``attention_impl: xla`` and SwinV2-L@384 with
    ``packed`` and ``xla`` against ``auto`` on the same weights: one serving
    batch and one training step after a warm-up each, no attention kernel
    launched on the plain paths (K4 and the LayerNorm forward run under
    every value, as in JAX), the logits within the serving gate of the
    model, the step's loss within it too. Returns the records."""
    import dataclasses

    from fedvit_torch.data.pipeline import canvas_size
    from fedvit_torch.models import build_model
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step

    attention = set(counted(fa, None))
    records = {}
    for name, backbone, size, impls, batch, micro, accum, drop, llrd, \
            limit, serve_want, step_want in (
            ("vit_b", "vit_base_patch16_224", 224, ("xla",), SERVE_BATCH,
             MICRO, ACCUM, 0.1, 0.75, LOGITS_RTOL_BF16,
             {"K1": BLOCKS, "LN": NORMS},
             {"K2": ACCUM * BLOCKS, "K3": ACCUM * BLOCKS,
              "K4": ACCUM * NORMS, "LN": ACCUM * NORMS}),
            ("swinv2_l", SWIN, SWIN_SIZE, ("packed", "xla"), SWIN_BATCH,
             SWIN_MICRO, SWIN_ACCUM, SWIN_DROP_PATH, SWIN_LLRD,
             SWIN_LOGITS_RTOL_BF16,
             {"K5": sum(SWIN_DEPTHS), "LN": sum(SWIN_NORMS)},
             {"K5_lse": SWIN_ACCUM * sum(SWIN_DEPTHS),
              "K6": SWIN_ACCUM * sum(SWIN_DEPTHS),
              "K4": SWIN_ACCUM * sum(SWIN_NORMS),
              "LN": SWIN_ACCUM * sum(SWIN_NORMS)})):
        cfg, model, state, step, batches = training_setup(
            backbone, size, micro, accum, drop, llrd, n_batches=2)
        weights = {k: v.clone() for k, v in model.state_dict().items()}
        source = serving_inputs(batch, canvas_size(size), SEED + 16)
        rec = {}

        def run(impl, model, state, step):
            tag = f"plain-attention {name} {impl}"
            logits, img_s, peak, served = serve_once(
                tag, fa, ln, smi, model, cfg, source, batch)
            torch.cuda.reset_peak_memory_stats()
            state, first = step(state, batches[0])
            torch.cuda.synchronize()
            reset_counts(fa, ln)
            t0 = time.perf_counter()
            state, m = step(state, batches[1])
            loss = float(m["loss"])
            train_s = time.perf_counter() - t0
            trained = {k: v for k, v in launch_counts(fa, ln).items() if v}
            train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"[{tag}] training step after a warm-up, macro batch "
                f"{micro * accum} ({accum} x {micro}): {train_s * 1e3!r} ms, "
                f"{micro * accum / train_s!r} img/s, peak {train_peak!r} GiB, "
                f"losses {float(first['loss'])!r}, {loss!r}, launches "
                f"{trained} ({smi})")
            return {"logits": logits, "loss": loss, "serve_img_s": img_s,
                    "serve_peak_gib": peak, "serve_launches": served,
                    "train_ms": train_s * 1e3,
                    "train_img_s": micro * accum / train_s,
                    "train_peak_gib": train_peak, "train_launches": trained}

        rec["auto"] = run("auto", model, state, step)
        if rec["auto"]["serve_launches"] != serve_want or \
                rec["auto"]["train_launches"] != step_want:
            raise RuntimeError(f"{name} auto: the kernels were not launched "
                               f"as before: want {serve_want} and {step_want}")
        del model, state, step
        torch.cuda.empty_cache()
        for impl in impls:
            icfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                         attention_impl=impl))
            imodel = build_model(icfg, device="cuda")
            imodel.load_state_dict(weights)
            tx, _ = build_optimizer(icfg, imodel, steps_per_epoch=100)
            rec[impl] = run(impl, imodel, TrainState.create(imodel, tx, SEED),
                            make_train_step(icfg, build_loss(icfg)))
            tag = f"plain-attention {name} {impl}"
            compare_logits(tag, rec[impl]["logits"], rec["auto"]["logits"],
                           limit)
            loss_err = abs(rec[impl]["loss"] - rec["auto"]["loss"]) / abs(
                rec["auto"]["loss"])
            fired = {k: v for k, v in {**rec[impl]["serve_launches"],
                                       **rec[impl]["train_launches"]}.items()
                     if k in attention}
            log(f"[{tag}] against auto: the step's loss {rec[impl]['loss']!r} "
                f"vs {rec['auto']['loss']!r}, relative {loss_err!r} (limit "
                f"{limit!r}); attention kernels launched {fired} (want none); "
                f"serving {rec[impl]['serve_img_s']!r} img/s and peak "
                f"{rec[impl]['serve_peak_gib']!r} GiB against auto's "
                f"{rec['auto']['serve_img_s']!r} and "
                f"{rec['auto']['serve_peak_gib']!r}; training "
                f"{rec[impl]['train_img_s']!r} img/s and peak "
                f"{rec[impl]['train_peak_gib']!r} GiB against "
                f"{rec['auto']['train_img_s']!r} and "
                f"{rec['auto']['train_peak_gib']!r} ({smi})")
            if fired or rec[impl]["serve_launches"] != {
                    "LN": serve_want["LN"]} or rec[impl]["train_launches"] != {
                    "K4": step_want["K4"], "LN": step_want["LN"]} \
                    or not loss_err <= limit:
                raise RuntimeError(f"{tag}: a kernel ran on the plain path, "
                                   f"or its step disagrees with auto's")
            del imodel, tx
            torch.cuda.empty_cache()
        for r in rec.values():
            del r["logits"]
        records[name] = rec
        del weights, batches, source
        torch.cuda.empty_cache()
    return records


def verify_phase(fa, ln, smi) -> dict:
    """16c: ``python -m fedvit_torch.cli.verify --device cuda`` in a
    process of its own: exit 0, every check PASS, none FAIL. Then its
    ``main`` again in this process, every count set to 0 just before and
    the inputs of the kernels' entries recorded: every check passes again,
    K1-K4, K7 and K8 each launch once for each call of their entry and no
    other kernel runs. Then each of these kernels against its plain version
    at each shape and dtype that run gave it (K1 at N = 5 in fp32 and bf16,
    K2-K4 in fp32, K7 and K8 at the shapes of verify's augments), to the
    tolerances of the earlier phases. Returns the launches, the records by
    kernel and shape, and the seconds."""
    from fedvit_torch.cli import verify as verify_cli
    from fedvit_torch.models import layers
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    from fedvit_torch.ops.attention import attention_from_qkvb

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "fedvit_torch.cli.verify", "--device", "cuda"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - t0
    passed, failed = out.stdout.count("[PASS]"), out.stdout.count("[FAIL]")
    for line in out.stdout.splitlines():
        if line.startswith(("Device:", "  [")) or "tests passed" in line:
            log(f"[verify] {line.strip()}")
    log(f"[verify] `python -m fedvit_torch.cli.verify --device cuda`: exit "
        f"{out.returncode}, {passed} PASS, {failed} FAIL in {seconds!r} s "
        f"({smi})")
    if out.returncode != 0 or passed != VERIFY_CHECKS or failed:
        raise RuntimeError(f"cli.verify failed on the card:\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")

    # the same main in this process, counted, the kernels' inputs recorded
    seen = {"attention": [], "K4": [], "LN": [], "K7": [], "K8": []}

    def recording(module, name, key, describe):
        fn = getattr(module, name)

        def wrapped(*args):
            seen[key].append(describe(*args))
            return fn(*args)
        return rebound(module, name, wrapped)

    def attention(qkv, bias, heads):
        grad = torch.is_grad_enabled() and (qkv.requires_grad
                                            or bias.requires_grad)
        return tuple(qkv.shape), qkv.dtype, heads, grad

    fns = counted(fa, ln) | {"K7": rs.shift_cuda, "K8": ra.equalize_cuda}
    for fn in fns.values():
        fn.launches = 0
    with contextlib.ExitStack() as stack:
        for module, name, key, describe in (
                (layers, "flash_attention_qkvb", "attention", attention),
                (ln, "layer_norm_bwd", "K4",
                 lambda x, *_: (tuple(x.shape), x.dtype)),
                (ln, "layer_norm_fwd", "LN",
                 lambda x, w, b, eps, dtype: (tuple(x.shape), x.dtype,
                                              dtype or x.dtype)),
                (rs, "row_shift", "K7",
                 lambda img, _: ("rows", tuple(img.shape), img.dtype)),
                (rs, "col_shift", "K7",
                 lambda img, _: ("columns", tuple(img.shape), img.dtype)),
                (ra, "equalize", "K8",
                 lambda img, *_: (tuple(img.shape), img.dtype))):
            stack.enter_context(recording(module, name, key, describe))
        in_s, stdout, peak = run_cli("cli.verify", verify_cli.main,
                                     ["--device", "cuda"])
    launches = {k: fn.launches for k, fn in fns.items() if fn.launches}
    grads = sum(1 for *_, grad in seen["attention"] if grad)
    calls = {"K1": len(seen["attention"]) - grads, "K2": grads, "K3": grads,
             "K4": len(seen["K4"]), "LN": len(seen["LN"]),
             "K7": len(seen["K7"]), "K8": len(seen["K8"])}
    passed, failed = stdout.count("[PASS]"), stdout.count("[FAIL]")
    log(f"[verify] cli.verify's main in this process: {passed} PASS, "
        f"{failed} FAIL in {in_s!r} s, peak {peak!r} GiB; launches "
        f"{launches} against the calls of their entries {calls}; inputs: "
        f"attention (shape, dtype, heads, grad) {sorted(set(seen['attention']), key=str)}, "
        f"K4 {sorted(set(seen['K4']), key=str)}, LayerNorm forward "
        f"{sorted(set(seen['LN']), key=str)}, K7 "
        f"{sorted(set(seen['K7']), key=str)}, K8 "
        f"{sorted(set(seen['K8']), key=str)} ({smi})")
    if passed != VERIFY_CHECKS or failed or launches != calls or \
            not all(calls.values()):
        raise RuntimeError("cli.verify in this process: a check failed, a "
                           "kernel of its path did not launch, or a kernel "
                           "launched other than once a call of its entry")
    if any(dtype != torch.float32 for *_, dtype in seen["K7"] + seen["K8"]):
        raise RuntimeError("cli.verify gave K7 or K8 other than float32")

    # each kernel against its plain version at the shapes that run gave it
    recs = {k: [] for k in calls}

    def tagged(rec, shape, dtype):
        return rec | {"shape": list(shape), "dtype": short(dtype)}

    for shape, dtype, heads, grad in sorted(set(seen["attention"]), key=str):
        b, n, e3 = shape
        d = e3 // 3 // heads
        if grad:
            recs["K2"].append(tagged(check_k2(
                fa, attention_from_qkvb, b, n, heads, dtype, False, d=d),
                shape, dtype))
            recs["K3"].append(tagged(check_k3(
                fa, attention_from_qkvb, b, n, heads, dtype, False, d=d),
                shape, dtype))
        else:
            atol = K1_ATOL_FP32 if dtype == torch.float32 else K1_ATOL_BF16
            recs["K1"].append(tagged(check_k1(
                fa, attention_from_qkvb, b, n, heads, d, dtype, atol, False),
                shape, dtype))
    for shape, dtype in sorted(set(seen["K4"]), key=str):
        recs["K4"].append(tagged(check_k4(ln, shape, dtype, False), shape,
                                 dtype))
    for shape, xdt, ydt in sorted(set(seen["LN"]), key=str):
        recs["LN"].append(tagged(check_ln_fwd(ln, shape, xdt, ydt, False),
                                 shape, xdt) | {"out_dtype": short(ydt)})
    for i, (kind, shape, _) in enumerate(sorted(set(seen["K7"]), key=str)):
        recs["K7"].append(check_k7(rs, shape, 2 if kind == "rows" else 1,
                                   SEED + 160 + i, False))
    for i, (shape, _) in enumerate(sorted(set(seen["K8"]), key=str)):
        recs["K8"].append(check_k8(ra, shape, SEED + 170 + i, False))
        check_k8(ra, shape, SEED + 180 + i, False, spans=True)
    return {"passed": passed, "s": seconds, "in_process_s": in_s,
            "launches": launches, "shapes": recs}


def profile_cli_phase(fa, ln, smi, tmp, plain_s) -> dict:
    """16d: ``cli.train --fold 0 --profile DIR`` on phase 13's layout and
    YAML: one trace written, of optimizer steps 2-4, naming K2, K3, K4, K7
    and K8; its seconds beside phase 13c's run without ``--profile``.
    Returns the launches of the run and the record."""
    from fedvit_torch.cli import train as train_cli
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs

    fns = counted(fa, ln) | {"K7": rs.shift_cuda, "K8": ra.equalize_cuda}
    before = {k: fn.launches for k, fn in fns.items()}
    trace_dir = tmp / "profile16"
    seconds, _, peak = run_cli("cli.train --profile", train_cli.main, [
        "--config", str(tmp / "isic.yaml"), "--fold", "0",
        "--log", str(tmp / "log16"), "--profile", str(trace_dir)])
    launches = {k: fn.launches - before[k] for k, fn in fns.items()
                if fn.launches - before[k]}
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise RuntimeError(f"cli.train --profile wrote {len(files)} traces")
    nbytes = files[0].stat().st_size
    events = json.loads(files[0].read_text())["traceEvents"]
    names = [str(e.get("name", "")) for e in events]
    steps = sorted(n for n in set(names) if n.startswith("ProfilerStep#"))
    found = {k: sum(1 for n in names if in_group(n, patterns))
             for k, patterns in PROFILE_KERNELS.items()}
    device_us = sum(float(e.get("dur", 0)) for e in events
                    if e.get("cat") == "kernel")
    log(f"[profile-cli] `python -m fedvit_torch.cli.train --fold 0 --profile "
        f"DIR`: {seconds!r} s from start to end against {plain_s!r} s for "
        f"phase 13c's run without --profile ({seconds / plain_s!r}x); peak "
        f"{peak!r} GiB; launches {launches}; trace {files[0].name} "
        f"({nbytes} bytes, {len(events)} events) of {steps}; kernel events "
        f"by name {found}, {device_us / 1e3!r} ms of kernel time in the "
        f"traced steps ({smi})")
    if steps != ["ProfilerStep#1", "ProfilerStep#2", "ProfilerStep#3"] or \
            not all(found.values()):
        raise RuntimeError("the trace of cli.train --profile does not hold "
                           "the traced steps or does not name the port's "
                           "kernels")
    return {"launches": launches, "s": seconds, "plain_s": plain_s,
            "trace_bytes": nbytes, "kernel_events": found}


def last_options_phase(fa, ln, smi, tmp, plain_cli_s) -> dict:
    """Phase 16; returns the launches by kernel and path and the records."""
    phase_t0 = time.perf_counter()
    remat = remat_phase(fa, ln, smi)
    torch.cuda.empty_cache()
    plain = plain_attention_phase(fa, ln, smi)
    torch.cuda.empty_cache()
    verified = verify_phase(fa, ln, smi)
    torch.cuda.empty_cache()
    profiled = profile_cli_phase(fa, ln, smi, tmp, plain_cli_s)
    launches = remat["launches"]
    for name, rec in plain.items():
        for where in ("serve", "train"):
            for k, v in rec["auto"][f"{where}_launches"].items():
                launches.setdefault(k, {})[f"{name}_auto_{where}"] = v
    for k, v in verified["launches"].items():
        launches.setdefault(k, {})["verify_cli"] = v
    for k, v in profiled["launches"].items():
        launches.setdefault(k, {})["profile_cli"] = v
    log(f"[phase16] phase 16 in {time.perf_counter() - phase_t0!r} s ({smi})")
    return {"launches": launches, "remat": remat["records"],
            "plain_attention": plain, "verify": verified,
            "profile_cli": profiled}


# ---------------------------------------------------------------------------
# 17. Data parallelism and the federated meshes: two ranks that share the card
# ---------------------------------------------------------------------------

# Two ranks share the one H100 (gloo: NCCL refuses two ranks on one device,
# and gloo moves the CUDA tensors of a collective through the host), each a
# process of its own started here. Their times are not a measure of data
# parallelism's scaling: the two ranks halve one card, and every collective
# is staged through host memory.
DP_RANKS = 2
DP_SWIN_MACRO = 16            # 17a: SwinV2-L at 16 x 1, 8 rows a rank
DP_SWIN_STEPS = 2             # the replicas must agree after more than one
DP_FED_STEPS = 4              # 17c: 4 clients x 4 local steps of 32
DP_FED_IMAGES = 640
DP_TIMEOUT = 900.0            # the whole world of phase 17, seconds
# 17b: cli.train --fold 0 with training.data_parallel on two ranks against
# the same command on one process, one epoch of macro batch 128. The ranks
# run each micro-batch of 64 as 32 + 32 rows, so cuBLAS and K4 sum in other
# orders than on 64 rows: bf16 roundings an ulp apart in each step, which
# Adam turns into ±lr moves of gradients within rounding of 0 (lr 1e-4, the
# head's 1e-3) over the epoch's steps. The validation loss is held to 2% and
# the test logits (TTA) as RMS difference over RMS logit to
# LOGITS_RTOL_BF16, the limit of phase 3's one-ulp differences through 12
# bf16 blocks.
DP_CLI_LOSS_RTOL = 0.02
# 17d: JAX's own contract for a client x data round against the 1-D round
# (tests/test_federated.py:231-245), in fp32: the pre-update loss within
# 1e-4 (1 + |loss|), each parameter within 3 lr steps.
DP_2D_LOSS_RTOL = 1e-4


def dp_swin_setup(n_batches):
    """17a's recipe: SwinV2-L@384, bf16, 4 channels, metadata (its
    BatchNorm), the model's default drop path, MixUp/CutMix, one
    micro-batch of 16."""
    from fedvit_torch.core.config import ModelConfig
    return training_setup(SWIN, SWIN_SIZE, DP_SWIN_MACRO, 1,
                          ModelConfig().drop_path_rate, SWIN_LLRD,
                          n_batches=n_batches)


def dp_fed_config(dim):
    """17c's round (``dim`` "client": bf16, 4 clients x 4 local steps of 32,
    the train augment) or 17d's ("data": fp32, one client, one step, no
    augment, mix, dropout, drop path or metadata)."""
    import dataclasses
    from fedvit_torch.core.config import (AugmentationConfig, CutmixConfig,
                                          MixupConfig)
    cfg = fed_config(1)
    if dim == "client":
        return cfg.replace(federated=dataclasses.replace(
            cfg.federated, local_steps=DP_FED_STEPS))
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, compute_dtype="float32", drop_path_rate=0.0,
            metadata=dataclasses.replace(cfg.model.metadata, enabled=False),
            classifier=dataclasses.replace(cfg.model.classifier,
                                           dropout=0.0)),
        augmentation=AugmentationConfig(mixup=MixupConfig(enabled=False),
                                        cutmix=CutmixConfig(enabled=False)),
        federated=dataclasses.replace(cfg.federated, num_clients=1,
                                      local_steps=1, augment=False))


def dp_fed_inputs(cfg):
    """The round's server and working copy, its batches on the card
    {key: (C, S, B, ...)}, the clients' weights and ids."""
    import copy as copy_
    from fedvit_torch.data.synthetic import make_synthetic_dataset
    from fedvit_torch.fed.partition import client_weights, partition
    from fedvit_torch.fed.server import sample_client_indices
    fed = cfg.federated
    data = make_synthetic_dataset(n=DP_FED_IMAGES, image_size=224, seed=SEED)
    data["image"] = np.concatenate([data.pop("image"), data["mask"]], -1)
    parts = partition("dirichlet", data["label"], fed.num_clients,
                      alpha=0.5, seed=cfg.seed)
    rng = np.random.default_rng(SEED)
    idx = np.stack([sample_client_indices(data["label"], p, fed.local_steps,
                                          cfg.training.batch_size, rng)
                    for p in parts])
    batches = {k: torch.from_numpy(np.ascontiguousarray(
        data[k][idx.reshape(-1)]).reshape(idx.shape + data[k].shape[1:]))
        .cuda() for k in ("image", "label", "metadata")}
    server = fed_model(cfg)
    return (server, copy_.deepcopy(server), batches,
            client_weights(parts).astype(np.float32),
            list(range(fed.num_clients)))


def leaves_digest(leaves) -> str:
    """SHA-256 of the bytes of ``leaves`` in order."""
    import hashlib
    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def client_records(into, absacc=None, drop=False):
    """Rebinds ``fedavg.accumulate``: each client's leaves' digest goes to
    ``into``, Σ wᵢ|θᵢ| to ``absacc`` when given; with ``drop`` the client
    joins no sum (the control)."""
    from fedvit_torch.fed import fedavg
    accumulate = fedavg.accumulate

    def recording(acc, leaves, weight):
        into.append(leaves_digest(leaves))
        if absacc is not None:
            accumulate(absacc, [t.abs() for t in leaves], weight)
        if not drop:
            accumulate(acc, leaves, weight)

    with rebound(fedavg, "accumulate", recording):
        yield


def dp_references(fa, ln, smi, tmp: Path, work: Path) -> dict:
    """17a-17d on one process, the references the ranks are held to; the
    large ones saved under ``work``, 17b's config too (``tmp`` holds phase
    13's layout and imported weights)."""
    from fedvit_torch.cli import train as train_cli
    from fedvit_torch.fed.fedavg import federated_leaves, make_federated_round
    from fedvit_torch.ops.attention import windowed_attention_flat as plain
    from fedvit_torch.train import loop
    from fedvit_torch.train.losses import build_loss
    ref = {}

    # 17a. the SwinV2-L step at 16 x 1: kernel path, and the plain path in
    # bf16 and with fp32 attention for each leaf's rounding noise (phase 8)
    def plain_fp32(q, k, v, bias, mask, heads):
        return plain(q.float(), k.float(), v.float(), bias, mask,
                     heads).to(q.dtype)

    torch.cuda.reset_peak_memory_stats()
    cfg, model, state, step, batches = dp_swin_setup(DP_SWIN_STEPS)
    got = grads_by_path(model, state, step, batches[0], {
        "kernel": (),
        "plain": (window_attention_replaced_by(plain),
                  layer_norm_backward_replaced_by(ln.ln_bwd_plain)),
        "fp32": (window_attention_replaced_by(plain_fp32),
                 layer_norm_backward_replaced_by(ln.ln_bwd_plain))})
    noise = {n: rel_rms(g.cpu().numpy(), got["fp32"][0][n].cpu().numpy())
             for n, g in got["plain"][0].items()}
    torch.save({"grads": {n: g.cpu() for n, g in got["kernel"][0].items()},
                "loss": got["kernel"][1], "noise": noise},
               work / "dp17a_ref.pt")
    ref["a"] = {"loss": got["kernel"][1],
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[dp] 17a reference: SwinV2-L@384 bf16 step at {DP_SWIN_MACRO} x 1 "
        f"on one process, loss {got['kernel'][1]!r}, peak "
        f"{ref['a']['peak_gib']!r} GiB with three gradient passes ({smi})")
    del cfg, model, state, step, batches, got
    torch.cuda.empty_cache()

    # 17b. cli.train --fold 0 on phase 13's layout, one process
    config = work / "dp17b.yaml"
    raw = isic_config(tmp / "ISIC", tmp / "pretrained")
    raw["training"].update(epochs=1, data_parallel=True)
    config.write_text(json.dumps(raw))
    vals = []
    evaluate = loop._evaluate

    def recording(*a, **k):
        out = evaluate(*a, **k)
        vals.append(float(out["loss"]))
        return out

    with rebound(loop, "_evaluate", recording):
        seconds, _, peak = run_cli("dp 17b one process", train_cli.main, [
            "--config", str(config), "--fold", "0",
            "--log", str(work / "log17b_one")])
    ref["b"] = {"val_loss": vals,
                "logits": np.load(work / "log17b_one" / "ensemble_logits.npy"),
                "s": seconds, "peak_gib": peak}
    log(f"[dp] 17b reference: cli.train --fold 0 on one process, 1 epoch, "
        f"validation losses {vals} in {seconds!r} s, peak {peak!r} GiB "
        f"({smi})")
    torch.cuda.empty_cache()

    # 17c. a FedAvg round of 4 clients x 4 local steps of 32, one process
    cfg = dp_fed_config("client")
    server, working, batches, weights, clients = dp_fed_inputs(cfg)
    before = [t.detach().clone() for t in federated_leaves(server).values()]
    absacc = [torch.zeros_like(t) for t in before]
    digests = []
    with client_records(digests, absacc):
        metrics = make_federated_round(cfg, build_loss(cfg))(
            server, working, batches, weights, clients, 1, SEED)
    leaves = federated_leaves(server)
    torch.save({"leaves": {n: t.detach().cpu() for n, t in leaves.items()},
                "scale": {n: (a + b.abs()).cpu() for n, a, b in
                          zip(leaves, absacc, before)}},
               work / "dp17c_ref.pt")
    ref["c"] = {"loss": float(metrics["loss"]), "clients": digests}
    log(f"[dp] 17c reference: a round of {len(clients)} clients x "
        f"{cfg.federated.local_steps} local steps of "
        f"{cfg.training.batch_size} on one process, loss "
        f"{ref['c']['loss']!r} ({smi})")
    del server, working, batches, absacc, before, leaves
    torch.cuda.empty_cache()

    # 17d. the fp32 1-D round the 2-D mesh is held to
    cfg = dp_fed_config("data")
    server, working, batches, weights, clients = dp_fed_inputs(cfg)
    metrics = make_federated_round(cfg, build_loss(cfg))(
        server, working, batches, weights, clients, 1, SEED)
    torch.save({n: t.detach().cpu()
                for n, t in federated_leaves(server).items()},
               work / "dp17d_ref.pt")
    ref["d"] = {"loss": float(metrics["loss"])}
    log(f"[dp] 17d reference: the fp32 round of one client, one local step "
        f"of {cfg.training.batch_size}, on one process, loss "
        f"{ref['d']['loss']!r} ({smi})")
    del server, working, batches
    torch.cuda.empty_cache()
    return ref


def rank_counts(fa, ln) -> dict:
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    fns = counted(fa, ln) | {"K7": rs.shift_cuda, "K8": ra.equalize_cuda}
    return {k: fn.launches for k, fn in fns.items()}


def reset_rank_counts(fa, ln) -> None:
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs
    reset_counts(fa, ln)
    rs.shift_cuda.launches = ra.equalize_cuda.launches = 0


def same_on_ranks(tensors) -> bool:
    """Whether this rank's ``tensors`` hold rank 0's bits."""
    import torch.distributed as dist
    flat = torch.cat([t.detach().reshape(-1).float() if t.is_floating_point()
                      else t.detach().reshape(-1).double().float()
                      for t in tensors])
    theirs = flat.clone()
    dist.broadcast(theirs, src=0)
    return bool(torch.equal(flat, theirs))


def rank_swin(fa, ln, tmp: Path, rank: int) -> dict:
    """17a on a rank: the DP step's gradients (and the control's, without
    the gradient all-reduce) from the fresh state, saved by rank 0; then
    two steps, their launches and peak, and the replicas compared."""
    import torch.distributed as dist
    from fedvit_torch.parallel.data import DataParallel
    from fedvit_torch.train import step as step_module
    from fedvit_torch.train.losses import build_loss
    torch.cuda.reset_peak_memory_stats()
    cfg, model, state, _, batches = dp_swin_setup(DP_SWIN_STEPS)
    step = step_module.make_train_step(cfg, build_loss(cfg),
                                       data=DataParallel(dist.group.WORLD))
    got = grads_by_path(model, state, step, batches[0], {
        "dp": (),
        "control": (rebound(step_module, "all_reduce_flat",
                            lambda *a, **k: None),)})
    if rank == 0:
        torch.save({"dp": {n: g.cpu() for n, g in got["dp"][0].items()},
                    "loss": got["dp"][1],
                    "control": {n: g.cpu()
                                for n, g in got["control"][0].items()}},
                   tmp / "dp17a_rank0.pt")
    del got
    torch.cuda.empty_cache()
    dist.barrier()
    reset_rank_counts(fa, ln)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = rank_counts(fa, ln)
    from fedvit_torch.ops.layer_norm import LayerNorm
    norms = sum(isinstance(m, LayerNorm) for m in model.modules())
    equal = same_on_ranks([*model.state_dict().values(),
                           *state.ema.values()])
    gen_equal = same_on_ranks([state.generator.get_state()])
    return {"counts": counts, "losses": losses, "equal": equal,
            "generator_equal": gen_equal, "norms": norms,
            "ms_step": seconds / len(batches) * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def rank_cli(fa, ln, tmp: Path, rank: int) -> dict:
    """17b on a rank: ``cli.train`` main in this process, its validation
    losses, this rank's checkpoint writes and the digest of its parameters
    after each epoch."""
    import io
    from fedvit_torch.cli import train as train_cli
    from fedvit_torch.train import checkpoint as ckpt
    from fedvit_torch.train import loop
    vals, writes, digests, steps = [], [], [], []
    evaluate, atomic, epoch = loop._evaluate, ckpt._atomic_save, \
        loop._train_epoch

    def recording_eval(*a, **k):
        out = evaluate(*a, **k)
        vals.append(float(out["loss"]))
        return out

    def recording_write(obj, path):
        writes.append(str(path))
        return atomic(obj, path)

    def recording_epoch(step, state, src, macro_bs, *a, **k):
        out = epoch(step, state, src, macro_bs, *a, **k)
        digests.append(leaves_digest(state.model.state_dict().values()))
        steps.append(len(src) // macro_bs)
        return out

    reset_rank_counts(fa, ln)
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with rebound(loop, "_evaluate", recording_eval), \
            rebound(ckpt, "_atomic_save", recording_write), \
            rebound(loop, "_train_epoch", recording_epoch), \
            contextlib.redirect_stdout(out):
        rc = train_cli.main(["--config", str(tmp / "dp17b.yaml"), "--fold",
                             "0", "--log", str(tmp / "log17b_dp")])
    torch.cuda.synchronize()
    return {"rc": rc, "val_loss": vals, "writes": writes, "digests": digests,
            "steps": sum(steps), "counts": rank_counts(fa, ln),
            "s": time.perf_counter() - t0, "stdout_lines":
            len(out.getvalue().splitlines()),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def rank_fed(fa, ln, tmp: Path, rank: int, dim: str) -> dict:
    """17c (``dim`` "client": a client mesh of the ranks, then the control
    where rank 1 adds none of its clients) or 17d ("data": a 1 x 2 client
    x data mesh) on a rank; rank 0 saves the global leaves."""
    import copy as copy_
    from fedvit_torch.fed.fedavg import (client_slots, federated_leaves,
                                         make_federated_round)
    from fedvit_torch.parallel import mesh as pmesh
    from fedvit_torch.train.losses import build_loss
    cfg = dp_fed_config(dim)
    server, work, batches, weights, clients = dp_fed_inputs(cfg)
    if dim == "client":
        mesh = pmesh.client_mesh()
    else:
        mesh = pmesh.make_mesh([1, DP_RANKS], ["client", "data"])
    slots = client_slots(mesh, "client", len(clients))
    local = {k: v[slots] for k, v in batches.items()}
    if dim == "data":
        lo, hi = pmesh.row_piece(cfg.training.batch_size,
                                 mesh.size(1), pmesh.mesh_coordinate(
                                     mesh, "data"))
        local = {k: v[:, :, lo:hi] for k, v in local.items()}
    initial = copy_.deepcopy(server)
    round_fn = make_federated_round(cfg, build_loss(cfg), mesh)
    digests = []
    reset_rank_counts(fa, ln)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with client_records(digests):
        metrics = round_fn(server, work, local, weights, clients, 1, SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = rank_counts(fa, ln)
    leaves = federated_leaves(server)
    if rank == 0:
        torch.save({n: t.detach().cpu() for n, t in leaves.items()},
                   tmp / f"dp17{'c' if dim == 'client' else 'd'}_rank0.pt")
    equal = same_on_ranks(list(leaves.values()))
    out = {"loss": float(metrics["loss"]), "clients": {
        int(clients[s]): d for s, d in zip(range(slots.start, slots.stop),
                                           digests)},
        "counts": counts, "equal": equal, "s": seconds,
        "local_rows": int(local["label"].shape[2])}
    if dim == "client":
        with client_records([], drop=rank == 1):
            make_federated_round(cfg, build_loss(cfg), mesh)(
                initial, work, local, weights, clients, 1, SEED)
        if rank == 0:
            torch.save({n: t.detach().cpu()
                        for n, t in federated_leaves(initial).items()},
                       tmp / "dp17c_control.pt")
    return out


def rank_main(rank: int, tmp: str, out) -> None:
    """One rank of phase 17: joins the gloo group of DP_RANKS ranks on the
    card through a file under ``tmp``, runs 17a-17d in order, freeing the
    card between them, and puts (rank, True, results) or (rank, False,
    traceback) on ``out``."""
    import os
    import traceback
    import torch.distributed as dist
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_RANKS),
                          LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(DP_RANKS))
        from fedvit_torch.ops import flash_attention as fa
        from fedvit_torch.ops import layer_norm as ln
        from fedvit_torch.parallel.mesh import init_process_group_from_env
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        backend = []
        init_process_group_from_env(
            "cuda", init_method=f"file://{tmp}/dp17_store",
            log=backend.append)
        tmp_ = Path(tmp)
        results = {"backend": backend[0]}
        for name, fn in (("a", lambda: rank_swin(fa, ln, tmp_, rank)),
                         ("b", lambda: rank_cli(fa, ln, tmp_, rank)),
                         ("c", lambda: rank_fed(fa, ln, tmp_, rank, "client")),
                         ("d", lambda: rank_fed(fa, ln, tmp_, rank, "data"))):
            results[name] = fn()
            torch.cuda.empty_cache()
            dist.barrier()
        out.put((rank, True, results))
    except Exception:                              # noqa: BLE001
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_dp_ranks(tmp: Path) -> list:
    """Start the DP_RANKS ranks of phase 17 and wait for them; a rank that
    fails, or a world that outlasts DP_TIMEOUT, fails the run, and every
    rank is stopped."""
    import multiprocessing
    import queue
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, str(tmp), out))
             for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.monotonic() + DP_TIMEOUT
        while len(results) < DP_RANKS:
            try:
                rank, ok, value = out.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(f"phase 17's ranks did not finish in "
                                   f"{DP_TIMEOUT!r} s")
            if not ok:
                raise RuntimeError(f"phase 17: rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    return [results[r] for r in range(DP_RANKS)]


def nccl_record(tmp: Path) -> dict:
    """17e: whether this PyTorch has NCCL, and one NCCL all-reduce on the
    card at world 1 (the backend a multi-card cell would take)."""
    import torch.distributed as dist
    available = dist.is_nccl_available()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store",
                            rank=0, world_size=1)
    try:
        t = torch.arange(4.0, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        result = t.cpu().tolist()
        version = torch.cuda.nccl.version()
        version = ".".join(map(str, version)) \
            if isinstance(version, tuple) else str(version)
    finally:
        dist.destroy_process_group()
    return {"available": available, "all_reduce": result, "version": version}


def dp_phase(fa, ln, smi, tmp: Path) -> dict:
    """Phase 17 (``tmp`` holds phase 13's layout and imported weights);
    returns the launches of each kernel on each rank by sub-phase."""
    phase_t0 = time.perf_counter()
    work = tmp / "dp17"
    work.mkdir()
    ref = dp_references(fa, ln, smi, tmp, work)
    ranks_t0 = time.perf_counter()
    ranks = run_dp_ranks(work)
    ranks_s = time.perf_counter() - ranks_t0
    log(f"[dp] {DP_RANKS} ranks on one {smi}, {ranks[0]['backend']}; the "
        f"ranks' world ran 17a-17d in {ranks_s!r} s. Two ranks that share "
        f"one card, with gloo staging every collective through the host: "
        f"no time below measures data parallelism's scaling")
    launches = {}
    for r, res in enumerate(ranks):
        for sub in "abcd":
            for k, v in res[sub]["counts"].items():
                if v:
                    launches.setdefault(k, {}).setdefault(
                        f"rank{r}", {})[f"17{sub}"] = v

    # 17a
    want_a = {k: 0 for k in ranks[0]["a"]["counts"]} | {
        "K5_lse": DP_SWIN_STEPS * sum(SWIN_DEPTHS),
        "K6": DP_SWIN_STEPS * sum(SWIN_DEPTHS),
        "K4": DP_SWIN_STEPS * ranks[0]["a"]["norms"],
        "LN": DP_SWIN_STEPS * ranks[0]["a"]["norms"]}
    refa = torch.load(work / "dp17a_ref.pt", weights_only=True)
    got = torch.load(work / "dp17a_rank0.pt", weights_only=True)
    noise = refa["noise"]
    left_out = {n for n, v in noise.items() if v > NOISY_LEAF}
    if not set(ZERO_GRAD) <= left_out:
        raise RuntimeError("17a: a bias before a training-mode BatchNorm is "
                           "not all noise")
    allowed = {n: SWIN_GRAD_RTOL_BF16 + 2 * noise[n] for n in noise
               if n not in left_out}
    errs = {n: rel_rms(got["dp"][n].numpy(), refa["grads"][n].numpy())
            for n in allowed}
    ctrl = {n: rel_rms(got["control"][n].numpy(), refa["grads"][n].numpy())
            for n in allowed}
    over = {n: (e, allowed[n]) for n, e in errs.items() if not e <= allowed[n]}
    caught = [n for n in allowed if ctrl[n] > allowed[n]]
    loss_err = abs(got["loss"] - refa["loss"]) / abs(refa["loss"])
    worst = sorted(errs.items(), key=lambda kv: -kv[1] / allowed[kv[0]])[:3]
    log(f"[dp] 17a SwinV2-L@384 bf16 DP step, macro batch {DP_SWIN_MACRO} as "
        f"{DP_RANKS} x {DP_SWIN_MACRO // DP_RANKS} rows, against {DP_SWIN_MACRO}"
        f" x 1 on one process: loss {got['loss']!r} vs {refa['loss']!r} "
        f"(relative {loss_err!r}, limit {SWIN_GRAD_RTOL_BF16!r}); RMS error / "
        f"RMS grad over {len(errs)} leaves (limit {SWIN_GRAD_RTOL_BF16!r} + "
        f"2 x the leaf's noise; {len(left_out)} noisy leaves left out): median "
        f"{float(np.median(list(errs.values())))!r}, nearest their limits "
        f"{[(n, e, allowed[n]) for n, e in worst]}; control, no gradient "
        f"all-reduce: {len(caught)} of {len(allowed)} leaves over their "
        f"limits, median error {float(np.median(list(ctrl.values())))!r}")
    for r, res in enumerate(ranks):
        a = res["a"]
        log(f"[dp] 17a rank {r}: {DP_SWIN_STEPS} steps, losses {a['losses']}, "
            f"{a['ms_step']!r} ms/step (two ranks sharing the card, not a "
            f"scaling figure), peak {a['peak_gib']!r} GiB; launches "
            f"{ {k: v for k, v in a['counts'].items() if v} } (want "
            f"{ {k: v for k, v in want_a.items() if v} }); parameters, "
            f"statistics and EMA bit-equal to rank 0's: {a['equal']}, "
            f"generator {a['generator_equal']} ({smi})")
    del refa, got
    if over or not loss_err <= SWIN_GRAD_RTOL_BF16:
        raise RuntimeError(f"17a: the DP step's gradients disagree with the "
                           f"one-process step's: {over}")
    if len(caught) <= len(allowed) // 2:
        raise RuntimeError("17a: the gradient check cannot tell a missing "
                           "gradient all-reduce")
    if any(res["a"]["counts"] != want_a or not res["a"]["equal"]
           or not res["a"]["generator_equal"] for res in ranks):
        raise RuntimeError("17a: a rank launched other kernels than the "
                           "step's, or the replicas differ")

    # 17b
    b0, b1 = ranks[0]["b"], ranks[1]["b"]
    logits = np.load(work / "log17b_dp" / "ensemble_logits.npy")
    want_logits = ref["b"]["logits"]
    val_err = [abs(a - w) / abs(w) for a, w in
               zip(b0["val_loss"], ref["b"]["val_loss"])]
    logit_err = rel_rms(logits, want_logits)
    steps = b0["steps"]
    want_b = {"K2": steps * 2 * BLOCKS, "K3": steps * 2 * BLOCKS,
              "K4": steps * 2 * NORMS, "K7": steps * 12, "K8": steps * 3}
    # and the LayerNorm forward: NORMS a micro-batch and a served forward
    want_ln = [NORMS * (2 * steps + b["counts"].get("K1", 0) // BLOCKS)
               for b in (b0, b1)]
    log(f"[dp] 17b cli.train --fold 0, training.data_parallel, {DP_RANKS} "
        f"ranks: exit {b0['rc']} and {b1['rc']} in {b0['s']!r} s (one "
        f"process: {ref['b']['s']!r} s; two ranks sharing the card, not a "
        f"scaling figure); validation losses {b0['val_loss']} vs one "
        f"process's {ref['b']['val_loss']} (relative {val_err}, limit "
        f"{DP_CLI_LOSS_RTOL!r}); test logits RMS error / RMS logit "
        f"{logit_err!r} (limit {LOGITS_RTOL_BF16!r}); checkpoint writes by "
        f"rank {len(b0['writes'])} and {len(b1['writes'])}, stdout lines "
        f"{b0['stdout_lines']} and {b1['stdout_lines']}; parameters after "
        f"each epoch bit-equal: {b0['digests'] == b1['digests']}; launches "
        f"rank 0 { {k: v for k, v in b0['counts'].items() if v} }, rank 1 "
        f"{ {k: v for k, v in b1['counts'].items() if v} } ({steps} steps; "
        f"want {want_b}, K1 > 0 and LN {want_ln}); peaks {b0['peak_gib']!r} and "
        f"{b1['peak_gib']!r} GiB ({smi})")
    if b0["rc"] != 0 or b1["rc"] != 0 or not b0["writes"] or b1["writes"] \
            or b0["digests"] != b1["digests"] or not b0["digests"] \
            or len(b0["val_loss"]) != len(ref["b"]["val_loss"]) \
            or not all(e <= DP_CLI_LOSS_RTOL for e in val_err) \
            or not logit_err <= LOGITS_RTOL_BF16 \
            or not np.isfinite(logits).all():
        raise RuntimeError("17b: the data-parallel cli.train disagrees with "
                           "the one-process run, or a rank other than 0 "
                           "wrote, or the replicas differ")
    for b, ln_ in zip((b0, b1), want_ln):
        if any(b["counts"].get(k) != v for k, v in want_b.items()) or \
                not b["counts"].get("K1") or b["counts"].get("LN") != ln_:
            raise RuntimeError("17b: a rank did not launch the fold's "
                               "kernels as it should")

    # 17c
    refc = torch.load(work / "dp17c_ref.pt", weights_only=True)
    gotc = torch.load(work / "dp17c_rank0.pt", weights_only=True)
    ctrlc = torch.load(work / "dp17c_control.pt", weights_only=True)
    worst = control = 0.0
    for n, want in refc["leaves"].items():
        scale = refc["scale"][n] + 1e-30
        worst = max(worst, float(((gotc[n] - want).abs() / scale).max()))
        control = max(control, float(((ctrlc[n] - want).abs() / scale).max()))
    clients = {**ranks[0]["c"]["clients"], **ranks[1]["c"]["clients"]}
    same_clients = [clients.get(c) == d
                    for c, d in enumerate(ref["c"]["clients"])]
    loss_c = abs(ranks[0]["c"]["loss"] - ref["c"]["loss"])
    want_c = 2 * DP_FED_STEPS      # local steps a rank: 2 clients each
    want_c = {"K2": want_c * BLOCKS, "K3": want_c * BLOCKS,
              "K4": want_c * NORMS, "LN": want_c * NORMS, "K7": want_c * 12,
              "K8": want_c * 3}
    log(f"[dp] 17c FedAvg round of ViT-B/16@224, 4 clients x "
        f"{DP_FED_STEPS} local steps of {FED_BATCH} on a client mesh of "
        f"{DP_RANKS} ranks (2 clients a rank) against one process: each "
        f"client's leaves bit-equal {same_clients}; global leaves largest "
        f"|got - want| / (|θ| + Σwᵢ|θᵢ|) {worst!r} (limit {AGG_RTOL!r}, fp32 "
        f"summation order); loss {ranks[0]['c']['loss']!r} vs "
        f"{ref['c']['loss']!r}; ranks bit-equal {ranks[1]['c']['equal']}; "
        f"control, rank 1 drops its clients' sum: {control!r} (must exceed); "
        f"round {ranks[0]['c']['s']!r} s on rank 0 (shared card, not a "
        f"scaling figure); launches rank 0 "
        f"{ {k: v for k, v in ranks[0]['c']['counts'].items() if v} } (want "
        f"{want_c}) ({smi})")
    if not all(same_clients) or not worst <= AGG_RTOL or \
            not loss_c <= 1e-6 * abs(ref["c"]["loss"]) or \
            not ranks[1]["c"]["equal"]:
        raise RuntimeError("17c: the client-mesh round disagrees with the "
                           "one-process round")
    if not control > AGG_RTOL:
        raise RuntimeError("17c: the check cannot tell a rank that drops its "
                           "clients' sum")
    if any({k: v for k, v in res["c"]["counts"].items() if v} != want_c
           for res in ranks):
        raise RuntimeError("17c: a rank did not launch its clients' kernels "
                           "as it should")

    # 17d
    refd = torch.load(work / "dp17d_ref.pt", weights_only=True)
    gotd = torch.load(work / "dp17d_rank0.pt", weights_only=True)
    lr = dp_fed_config("data").training.optimizer.lr
    param_err = max(float((gotd[n] - w).abs().max()) for n, w in refd.items())
    loss_d = abs(ranks[0]["d"]["loss"] - ref["d"]["loss"])
    want_d = {"K2": BLOCKS, "K3": BLOCKS, "K4": NORMS, "LN": NORMS}
    log(f"[dp] 17d the fp32 round on a 1 x {DP_RANKS} client x data mesh "
        f"({ranks[0]['d']['local_rows']} rows a rank) against the 1-D round: "
        f"loss {ranks[0]['d']['loss']!r} vs {ref['d']['loss']!r} (|diff| "
        f"{loss_d!r}, limit {DP_2D_LOSS_RTOL * (1 + abs(ref['d']['loss']))!r}"
        f"); largest parameter difference {param_err!r} (limit 3·lr·steps "
        f"{3 * lr!r}); ranks bit-equal {ranks[1]['d']['equal']}; launches "
        f"rank 0 { {k: v for k, v in ranks[0]['d']['counts'].items() if v} }"
        f" (want {want_d}) ({smi})")
    if not loss_d < DP_2D_LOSS_RTOL * (1 + abs(ref["d"]["loss"])) or \
            not param_err <= 3 * lr or not ranks[1]["d"]["equal"] or \
            any({k: v for k, v in res["d"]["counts"].items() if v} != want_d
                for res in ranks):
        raise RuntimeError("17d: the client x data round breaks JAX's "
                           "contract")

    # 17e
    nccl = nccl_record(work)
    log(f"[dp] 17e NCCL: torch.distributed.is_nccl_available() "
        f"{nccl['available']}, NCCL {nccl['version']}, one all-reduce of "
        f"[0, 1, 2, 3] at world 1 on the card: {nccl['all_reduce']} ({smi})")
    if nccl["all_reduce"] != [0.0, 1.0, 2.0, 3.0]:
        raise RuntimeError("17e: the NCCL all-reduce at world 1 is wrong")
    log(f"[dp] phase 17 in {time.perf_counter() - phase_t0!r} s ({smi})")
    return {"launches": launches, "nccl": nccl}


# ---------------------------------------------------------------------------
# 18. EVA-02-L/14@448 training: the rotary kernel, the ragged LayerNorm, K9
# ---------------------------------------------------------------------------

EVA = "eva02_large_patch14_448.mim_m38m_ft_in22k_in1k"
EVA_SIZE, EVA_PATCH, EVA_DEPTH, EVA_HEADS = 448, 14, 24, 16
EVA_WIDTH, EVA_HIDDEN, EVA_REF_GRID = 1024, 2730, 16
EVA_GRID = EVA_SIZE // EVA_PATCH                   # 32 x 32 patches
EVA_TOKENS = 1 + EVA_GRID ** 2                     # and the class token
EVA_MICRO, EVA_ACCUM = 32, 2                       # the cell's micro-batch
EVA_DROP_PATH, EVA_LLRD = 0.2, 0.8
# The names of the new kernels in a device profile: the rotary kernel
# (``csrc/rotary.cu``) and the ragged LayerNorm forward and K4 pass; K9's
# training entries are K10's kernels (attn_fwd/attn_bwd without a bias)
ROPE_NAMES = (r"\brotary_kernel<",)
LN_RAGGED_NAMES = (r"\bln_fwd_ragged_kernel<", r"\bln_bwd_ragged_kernel<")
# the ragged LayerNorm's untimed cases, (x dtype, y dtype) → widths: rows
# off 16 bytes (2,730 and 1,030 in bf16) and over D 2048 (4,096, 2,052)
LN_RAGGED_CASES = {(torch.bfloat16, torch.bfloat16): (2730, 1030, 4096),
                   (torch.float32, torch.float32): (2730, 2052),
                   (torch.float32, torch.bfloat16): (2730,),
                   (torch.bfloat16, torch.float32): (2730,)}
K4_RAGGED_CASES = (((63, 2730), torch.bfloat16), ((4, 9, 1030), torch.bfloat16),
                   ((129, 4096), torch.bfloat16), ((65, 2730), torch.float32),
                   ((1057, 2052), torch.float32), ((3, 6), torch.float32))


def check_rotary(rotary, b, grid, heads, d, dtype, timed):
    """The rotary kernel (``rotary_qk_cuda``) on seeded (B, 1 + grid², E) q
    and k against ``rotate_plain``, by +θ (the forward) and −θ (the
    backward): the same bits (both take the same roundings), the class token
    copied, the inputs left as they were, one launch a call; timed beside
    its byte bound (q and k of the patch tokens read and written once and
    the table read once) and the plain version. Returns a record a
    direction."""
    n, e = 1 + grid * grid, heads * d
    cos, sin = rotary.rope_table(grid, d, EVA_REF_GRID, device="cuda")
    q, k = (seeded((b, n, e), dtype, SEED + 180 + n + d + i) for i in range(2))
    q0, k0 = q.clone(), k.clone()
    tag = f"[rope] q, k {(b, n, e)} {short(dtype)} heads {heads} (d {d})"
    recs = {}
    for sign, name in ((1.0, "fwd"), (-1.0, "bwd")):
        s = sin if sign > 0 else -sin
        before = rotary.rotary_qk_cuda.launches
        got = rotary.rotary_qk_cuda(q, k, cos, sin, sign)
        torch.cuda.synchronize()
        launched = rotary.rotary_qk_cuda.launches - before
        same = all(torch.equal(a, rotary.rotate_plain(x, cos, s))
                   for a, x in zip(got, (q, k)))
        kept = torch.equal(q, q0) and torch.equal(k, k0)
        log(f"{tag} by {name} θ: the plain version's bits {same}, the inputs "
            f"as they were {kept}, launches {launched}")
        if not (same and kept and launched == 1):
            raise RuntimeError("the rotary kernel is not its plain version")
        rec = recs[name] = {"same_bits": same}
        if not timed:
            continue
        rec["ms"] = cuda_ms(lambda: rotary.rotary_qk_cuda(q, k, cos, sin, sign))
        rec["plain_ms"] = cuda_ms(lambda: (rotary.rotate_plain(q, cos, s),
                                           rotary.rotate_plain(k, cos, s)),
                                  iters=5)
        nbytes = 4 * b * (n - 1) * e * q.element_size() + 2 * cos.numel() * 4
        # per element: two products and a sum
        rec.update(bound(nbytes, 3.0 * 2 * q.numel(), torch.float32))
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        log(f"{tag} by {name} θ: kernel {rec['ms']!r} ms, "
            f"{100 * rec['share_of_bound']!r}% of its bound "
            f"{rec['bound_ms']!r} ms by {rec['bound_by']} ({nbytes} B); plain "
            f"{rec['plain_ms']!r} ms")
    return recs


def check_rotary_grad(rotary) -> None:
    """``rotary_qk`` under grad on the card: one launch forward and one
    backward, q's and k's gradients the outputs' turned by −θ, bit for bit."""
    cos, sin = rotary.rope_table(4, 64, EVA_REF_GRID, device="cuda")
    q, k = (seeded((2, 17, 128), torch.float32, SEED + 190 + i).requires_grad_()
            for i in range(2))
    dq, dk = (seeded((2, 17, 128), torch.float32, SEED + 192 + i)
              for i in range(2))
    before = rotary.rotary_qk_cuda.launches
    torch.autograd.backward(rotary.rotary_qk(q, k, cos, sin), [dq, dk])
    torch.cuda.synchronize()
    launched = rotary.rotary_qk_cuda.launches - before
    same = torch.equal(q.grad, rotary.rotate_plain(dq, cos, -sin)) and \
        torch.equal(k.grad, rotary.rotate_plain(dk, cos, -sin))
    log(f"[rope] under grad: launches {launched} (want 2), the gradients the "
        f"outputs' turned by −θ {same}")
    if launched != 2 or not same:
        raise RuntimeError("rotary_qk's backward is not the rotation by −θ")


def ragged_counts(ln) -> tuple:
    return (ln.layer_norm_fwd_cuda.ragged_launches,
            ln.layer_norm_bwd_cuda.ragged_launches)


def check_ln_ragged(ln):
    """18b: the ragged LayerNorm forward and K4's ragged pass against their
    plain versions (phase 6's and 8a's checks) at small and odd shapes, each
    launch counted by the ragged counters, then timed at the cell's SwiGLU
    norm, (32 x 1,025, 2,730) bf16; returns (forward's record, K4's)."""
    before = ragged_counts(ln)
    calls = 0
    for (xdt, ydt), widths in LN_RAGGED_CASES.items():
        for d in widths:
            for shape in ((1, d), (7, d), (3, 37, d)):
                check_ln_fwd(ln, shape, xdt, ydt, False)
                calls += 1
    for shape, dtype in K4_RAGGED_CASES:
        check_k4(ln, shape, dtype, False)
    got = tuple(a - b for a, b in zip(ragged_counts(ln), before))
    want = (2 * calls, len(K4_RAGGED_CASES))
    log(f"[ln-ragged] ragged launches (forward, K4) {got} (want {want})")
    if got != want:
        raise RuntimeError("rows off 16 bytes or over D 2048 did not take "
                           "the ragged kernels once a call")
    rows = EVA_MICRO * EVA_TOKENS
    fwd = check_ln_fwd(ln, (rows, EVA_HIDDEN), torch.bfloat16, torch.bfloat16,
                       True)
    k4 = check_k4(ln, (EVA_MICRO, EVA_TOKENS, EVA_HIDDEN), torch.bfloat16, True)
    k4["share_of_bound"] = k4["bound_ms"] / k4["ms"]
    log(f"[ln-ragged] K4's ragged pass at ({rows}, {EVA_HIDDEN}): "
        f"{100 * k4['share_of_bound']!r}% of its bound")
    return fwd, k4


def eva_train(fa, ln, smi, trace):
    """18d: the step of phase 8b on EVA-02-L/14@448 at macro batch 64 as 2
    micro-batches of 32 (the cell's micro-batch), drop-path 0.2, LLRD 0.8: a
    warm-up step, then 5 timed ones whose launches a micro-batch must be 24
    of K9's log-sum-exp entry, 24 K9 backwards, 48 rotary (q and k turned
    once forward and once back a block), 73 LayerNorm forwards and 73 K4
    (three a block and ``fc_norm``), 24 of each of them ragged (the SwiGLU
    norm), and none of any other kernel. Returns the timed steps' counts."""
    from fedvit_torch.ops.layer_norm import LayerNorm

    cfg, model, state, step, batches = training_setup(
        EVA, EVA_SIZE, EVA_MICRO, EVA_ACCUM, EVA_DROP_PATH, EVA_LLRD)
    norms = [m for m in model.modules() if isinstance(m, LayerNorm)]
    wide = sum(m.weight.numel() == EVA_HIDDEN for m in norms)
    log(f"[eva-train] {EVA}: {len(model.backbone.blocks)} blocks, "
        f"{len(norms)} LayerNorms, {wide} of them over {EVA_HIDDEN}")
    if len(model.backbone.blocks) != EVA_DEPTH or \
            len(norms) != 3 * EVA_DEPTH + 1 or wide != EVA_DEPTH:
        raise RuntimeError("want 24 blocks of three LayerNorms, one of them "
                           "the SwiGLU norm, and fc_norm")
    state = warm_up_step("eva-train", cfg, model, state, step, batches[0])
    micro_batches = TIMED_STEPS * EVA_ACCUM
    want = {k: 0 for k in counted(fa, ln)} | {
        "K9_lse": micro_batches * EVA_DEPTH, "K9_bwd": micro_batches * EVA_DEPTH,
        "RoPE": 2 * micro_batches * EVA_DEPTH,
        "K4": micro_batches * len(norms), "LN": micro_batches * len(norms)}
    before = ragged_counts(ln)
    state, counts = timed_steps("eva-train", "EVA-02-L/14@448 bf16 4ch+meta", fa,
                                ln, state, step, batches[1:], want, smi)
    ragged = tuple(a - b for a, b in zip(ragged_counts(ln), before))
    log(f"[eva-train] ragged launches (forward, K4) in {len(batches) - 1} "
        f"steps: {ragged} (want {(micro_batches * wide,) * 2})")
    if ragged != (micro_batches * wide,) * 2:
        raise RuntimeError("the SwiGLU norm did not take the ragged kernels "
                           "once a micro-batch and block")
    if trace:
        trace_training("profile-eva-train", step, state, batches[1], smi, {
            "K9 log-sum-exp entry": K10_LSE_NAMES, "K9 backward": K10_BWD_NAMES,
            "RoPE": ROPE_NAMES, "ragged LayerNorm": LN_RAGGED_NAMES})
    return counts | {"LN_ragged": ragged[0], "K4_ragged": ragged[1]}


def eva02_phase(fa, ln, smi, trace):
    """Phase 18; returns the records of the rotary kernel, the ragged
    LayerNorm forward and K4 pass, K9 at the cell's shape, and the training
    step's launch counts, for the kernels line."""
    from fedvit_torch.ops import rotary
    phase_t0 = time.perf_counter()
    # 18a. the rotary kernel
    for b, grid, heads, d, dtype in ((3, 4, 2, 64, torch.float32),
                                     (2, 7, 2, 64, torch.bfloat16),
                                     (3, 4, 3, 64, torch.bfloat16),
                                     (9, EVA_GRID, EVA_HEADS, 64, torch.bfloat16)):
        check_rotary(rotary, b, grid, heads, d, dtype, False)
    check_rotary_grad(rotary)
    rope = check_rotary(rotary, EVA_MICRO, EVA_GRID, EVA_HEADS,
                        EVA_WIDTH // EVA_HEADS, torch.bfloat16, True)
    torch.cuda.empty_cache()
    # 18b. the ragged LayerNorm
    ln_fwd, k4 = check_ln_ragged(ln)
    torch.cuda.empty_cache()
    # 18c. K9 at the cell's shape
    k9 = check_k9(fa, EVA_MICRO, EVA_TOKENS, EVA_HEADS, EVA_WIDTH // EVA_HEADS,
                  torch.bfloat16, ("fwd", "lse", "bwd"), True)
    torch.cuda.empty_cache()
    # 18d. the training step
    counts = eva_train(fa, ln, smi, trace)
    torch.cuda.empty_cache()
    log(f"[eva] phase 18 in {time.perf_counter() - phase_t0!r} s ({smi})")
    return {"rope": rope, "ln_fwd": ln_fwd, "k4": k4, "k9": k9,
            "counts": counts}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", action="store_true",
                        help="also break the time of a serving batch (phases 5 "
                             "and 7), of a training step (phases 6, 8 and "
                             "18), of a fold step (phase 9), of a federated "
                             "round (phase 12) and of a JointLoss step "
                             "(phase 15) down")
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
    # which of the file readers that cli/train needs import here; nothing
    # below depends on them
    probe = subprocess.run(
        [sys.executable, "-c", "import importlib, json\nfound = {}\n"
         "for m in ('PIL', 'pandas', 'yaml', 'cv2'):\n"
         "    try:\n        found[m] = getattr(importlib.import_module(m), "
         "'__version__', 'yes')\n"
         "    except Exception as e:\n        found[m] = repr(e)\n"
         "print(json.dumps(found))"],
        capture_output=True, text=True, timeout=300)
    log(f"[packages] import on this machine: {probe.stdout.strip()} "
        f"{probe.stderr.strip()[-300:]}")
    # whether libjpeg's and libpng's headers are here, which a port of
    # native/fedvit_loader.cpp needs; nothing below depends on them
    compiler = next((c for c in ("c++", "g++", "gcc") if shutil.which(c)), None)
    headers = {}
    for header, before in (("jpeglib.h", "#include <cstdio>\n"), ("png.h", "")):
        if compiler is None:
            headers[header] = "no host compiler"
            continue
        out = subprocess.run([compiler, "-x", "c++", "-fsyntax-only", "-"],
                             input=f"{before}#include <{header}>\n",
                             capture_output=True, text=True, timeout=120)
        headers[header] = ("found" if out.returncode == 0 else
                           f"not found: {out.stderr.strip()[-200:]}")
    log(f"[headers] {compiler} -fsyntax-only: {headers}")
    free, total = torch.cuda.mem_get_info()
    log(f"[device] memory free before the run: {free / 2 ** 30!r} of "
        f"{total / 2 ** 30!r} GiB")
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

    reset_counts(fa, ln)
    t0 = time.perf_counter()
    served = _evaluate(step, source, SERVE_BATCH, cfg.num_classes)
    serve_s = time.perf_counter() - t0
    launches = expect_launches("serve", fa, ln,
                               math.ceil(SERVE_IMAGES / SERVE_BATCH))
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
    reset_counts(fa, ln)
    t0 = time.perf_counter()
    _, _, tta_logits = evaluate_with_tta(cfg, model, tta_source,
                                         batch_size=TTA_BATCH)
    tta_s = time.perf_counter() - t0
    expect_launches("tta", fa, ln, math.ceil(TTA_IMAGES / TTA_BATCH))
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

    # 6d. the LayerNorm forward kernel
    ln_fwd = ln_fwd_phase(ln)

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

    # 12. federated training of ViT-B/16@224
    torch.cuda.empty_cache()
    fed = fed_phase(fa, ln, smi, args.trace)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_isic_") as tmp:
        # 13. the user's ISIC path through the CLIs
        torch.cuda.empty_cache()
        isic = isic_phase(fa, ln, smi, probe.stdout.strip(), Path(tmp))
        # 14. lesion masks segmented on the card
        torch.cuda.empty_cache()
        masks = on_device_masks_phase(fa, ln, smi, probe.stdout.strip())
        # 15. the old generation: a HybridViT on ViT-B/16@224
        torch.cuda.empty_cache()
        old = old_gen_phase(fa, ln, smi, Path(tmp), args.trace)
        # 16. remat, the plain attention options, cli.verify, --profile
        torch.cuda.empty_cache()
        last = last_options_phase(fa, ln, smi, Path(tmp), isic["train_cli_s"])
        # 17. data parallelism and the federated meshes on two ranks
        torch.cuda.empty_cache()
        dp = dp_phase(fa, ln, smi, Path(tmp))
    # 18. EVA-02-L/14@448: the rotary kernel, the ragged LayerNorm, K9, a step
    torch.cuda.empty_cache()
    eva = eva02_phase(fa, ln, smi, args.trace)
    for entry, rec in eva["k9"].items():
        k9[entry]["eva02_l_448"] = rec
    for entry, key in (("lse", "K9_lse"), ("bwd", "K9_bwd")):
        k9[entry]["launches_eva02_train"] = eva["counts"][key]
    for rec, key in ((k1, "K1"), (k2, "K2"), (k3, "K3"), (k4, "K4"),
                     (k5, "K5"), (k5_lse, "K5_lse"), (k6, "K6"), (k7, "K7"),
                     (k8, "K8")):
        rec["launches_phase16"] = last["launches"].get(key, {})
        rec["launches_phase17"] = dp["launches"].get(key, {})
    for rec, key in ((k1, "K1"), (k2, "K2"), (k3, "K3"), (k4, "K4"),
                     (k7, "K7"), (k8, "K8")):
        rec["launches_old_gen"] = old["launches"][key]
        rec["launches_federated_round"] = fed["launches_round"][key]
        rec["federated"] = fed["shapes"][key]
        rec["launches_isic"] = isic["launches"][key]
        rec["launches_on_device_masks"] = masks["launches"][key]
        rec["verify_cli"] = last["verify"]["shapes"][key]
        if key in isic["shapes"]:
            rec["isic"] = isic["shapes"][key]
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
         "launches_swin_train": swin_counts["K4"], "swin_shapes": k4_swin,
         "old_gen_shapes": old["k4"]},
        {"name": "layer_norm_fwd", "route": "cuda",
         "source": "fedvit_torch/csrc/layer_norm_fwd.cu",
         "replaces": "none (XLA fuses the JAX package's forward)",
         "launches": counts["LN"], "launches_swin_train": swin_counts["LN"],
         "shapes": ln_fwd, "verify_cli": last["verify"]["shapes"]["LN"]},
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
        {"name": "rotary_qk", "route": "cuda",
         "source": "fedvit_torch/csrc/rotary.cu",
         "replaces": "none (the JAX package has no EVA-02 block)",
         "launches_eva02_train": eva["counts"]["RoPE"], **eva["rope"]},
        {"name": "layer_norm_fwd_ragged", "route": "cuda",
         "source": "fedvit_torch/csrc/layer_norm_fwd.cu",
         "replaces": "none (XLA fuses the JAX package's forward)",
         "launches_eva02_train": eva["counts"]["LN_ragged"], **eva["ln_fwd"]},
        {"name": "layer_norm_bwd_ragged", "route": "cuda",
         "source": "fedvit_torch/csrc/layer_norm_bwd.cu",
         "replaces": "fedvit_tpu/ops/layer_norm.py:90",
         "launches_eva02_train": eva["counts"]["K4_ragged"], **eva["k4"]},
        *extra]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
