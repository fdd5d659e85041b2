"""The train step (``fedvit_tpu/train/step.py::make_train_step``).

One step takes a macro batch of ``accum · micro`` images, labels and metadata.
The images arrive already augmented (NHWC, normalised), or, when the step is
built with ``augment`` (``data/pipeline.py::make_device_augment(cfg, True)``),
as raw uint8 canvases that the augment turns into model input on the device,
drawing from the state's ``torch.Generator`` (``fedvit_tpu``'s fused augment,
step.py:106-111). Then:

1. ``accumulate_grads``: the macro batch is cut into ``accum`` micro-batches,
   run in order with the model in training mode (BatchNorm statistics thread
   through them in the module's buffers). Each draws its mix, runs forward
   and loss, and adds its gradients to the parameters' ``.grad``; then
   grads ← sum / accum and loss ← mean.
2. ``apply_update``: clip, AdamW with LLRD, LR (``train/optim.py``), then the
   EMA, then ``step += 1``.

Metrics are ``loss`` and ``grad_norm``, the global norm of the averaged
gradients before clipping, as tensors on the model's device (reading them
waits for the device).

The stages are spans (``utils/profiling.py``): ``train.augment`` (a fused
augment), ``train.forward_backward`` (the micro-batches and the gradients'
average), ``train.allreduce`` (data-parallel only) and ``train.update``
(``apply_update``).

Data-parallel (``data``, ``parallel/data.py``): under SPMD semantics every
rank is given the whole macro batch, augments and mixes it from the same
draws, and runs forward and backward on its rows of each micro-batch
(``row_piece``: even pieces where the ranks divide the micro-batch, else
the first pieces a row longer), each rank's loss its share of the whole
micro-batch's. Per shard, each rank runs the plain step on its shard. At
the end of ``accumulate_grads`` one flat all-reduce over the group sums the
gradients and the loss (SPMD: the unsharded step's; per shard: their mean,
with the BatchNorm statistics's mean in a second), so ``apply_update``
clips the global gradient and every rank makes the same update.

Parameters are fp32 and are cast to the compute dtype where they are used
(``models/layers.py::Dense``), as flax does: no ``torch.autocast`` and no
GradScaler, since bf16 has fp32's exponent range.

In the old generation's JointLoss mode (``models/isic.py::is_joint_loss``)
each micro-batch's loss adds ``loss.seg_weight`` × ``bce_dice_loss`` of the
model's ``seg_mask`` against the 4th channel of the mixed input mapped back
to [0, 1] (x·0.5 + 0.5): the mask rides the augment and the mix as a target.

On a CUDA model every LayerNorm runs K4 backward and every attention a
forward and a backward kernel (``ops/``): K2 and K3 in a ViT (per micro-batch
of a ViT-B, 12, 12 and 25 K4 launches), K5's log-sum-exp entry and K6 in a
SwinV2 (per micro-batch of a SwinV2-L, 24, 24 and 53 K4 launches). With
``model.remat`` the backward runs each block's forward again, so the forward
kernel under grad launches twice as often (24 K2 a ViT-B micro-batch, 48 of
K5's entry a SwinV2-L one); the others as without. ``attention_impl`` ``xla``
(and ``packed`` on a SwinV2) launches no attention kernel. The train
augment, fused or called before the step, launches 12 K7 and 3 K8 a macro
batch (``ops/row_shift.py``, ``ops/randaugment.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from fedvit_torch.core.config import Config
from fedvit_torch.eval.serve import _to_device
from fedvit_torch.train.ema import ema_update
from fedvit_torch.models.isic import is_joint_loss
from fedvit_torch.parallel.data import (DataParallel, Rows, all_reduce_flat,
                                        holding)
from fedvit_torch.parallel.mesh import row_piece
from fedvit_torch.train.losses import LossFn, bce_dice_loss, mixup_criterion
from fedvit_torch.train.mixup import make_mix_fn
from fedvit_torch.train.optim import global_norm
from fedvit_torch.train.state import TrainState
from fedvit_torch.utils.profiling import span


class TrainStep:
    """``step(state, batch) → (state, metrics)``, and its two halves."""

    def __init__(self, cfg: Config, loss_fn: LossFn,
                 augment: Optional[Callable] = None,
                 data: Optional[DataParallel] = None):
        t = cfg.training
        self.loss_fn = loss_fn
        self.augment = augment
        self.data = data
        self.accum = max(1, t.gradient_accumulation_steps)
        self.use_meta = cfg.model.metadata.enabled
        self.ema_enabled = t.ema.enabled
        self.ema_decay = t.ema.decay
        self.mix = make_mix_fn(cfg.augmentation)
        self.seg_weight = float(cfg.loss.seg_weight) if is_joint_loss(cfg) \
            else 0.0

    def accumulate_grads(self, state: TrainState, batch: Dict
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                    Dict[str, torch.Tensor]]:
        """(grads by parameter name, mean loss, BatchNorm statistics by
        buffer name) of one macro batch. The grads are the parameters'
        ``.grad`` tensors."""
        model = state.model
        model.train()
        device = next(model.parameters()).device
        batch = _to_device(batch, device)
        if self.augment is not None:
            with span("train.augment"):
                batch = self.augment(batch, state.generator)
        images, labels = batch["image"], batch["label"].long()
        metadata = batch.get("metadata") if self.use_meta else None
        b = images.shape[0]
        micro = b // self.accum
        if micro * self.accum != b:
            raise ValueError(f"batch {b} not divisible by accumulation steps "
                             f"{self.accum}")
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with span("train.forward_backward"):
            loss_sum, grads = self._micro_batches(state, params, images,
                                                  labels, metadata, micro)
        stats = {name: t for name, t in model.named_buffers()
                 if name.endswith(("running_mean", "running_var"))}
        loss = loss_sum * (1.0 / self.accum)
        if self.data is not None:
            # SPMD: the ranks' shares sum to the unsharded gradients and
            # loss; per shard: the mean over the shards (JAX's pmean), the
            # BatchNorm statistics too
            group, scale = self.data.group, 1.0
            with span("train.allreduce"):
                if not self.data.spmd:
                    scale = 1.0 / self.data.size
                    all_reduce_flat(list(stats.values()), group, scale)
                all_reduce_flat(list(grads.values()) + [loss], group, scale)
        return grads, loss, stats

    def _micro_batches(self, state: TrainState, params, images, labels,
                       metadata, micro: int):
        """(loss sum, grads by name): each micro-batch's mix, forward, loss
        and backward, then the gradients averaged over them."""
        model = state.model
        spmd = self.data is not None and self.data.spmd
        loss_sum = torch.zeros((), device=images.device)
        for i in range(self.accum):
            sl = slice(i * micro, (i + 1) * micro)
            x, y = images[sl], labels[sl]
            meta = metadata[sl] if metadata is not None else None
            ya = yb = lam = None
            if self.mix is not None:
                x, ya, yb, lam = self.mix(x, y, rng=state.np_rng,
                                          generator=state.generator)
            if not spmd:
                loss = self._micro_loss(model, state, x, y, meta, ya, yb, lam)
                loss.backward()
            else:
                # every rank mixed the whole micro-batch from the same draws
                # (the partners of its rows are augmented and mixed here, not
                # gathered); it runs its own rows, under which the layers
                # and the losses see the whole micro-batch
                lo, hi = row_piece(micro, self.data.size, self.data.index)
                rows = Rows(self.data.group, lo, hi, micro)
                own = rows.held
                with holding(rows):
                    loss = self._micro_loss(
                        model, state, x[own], y[own],
                        None if meta is None else meta[own],
                        None if ya is None else ya[own],
                        None if yb is None else yb[own], lam)
                    loss.backward()
            loss_sum += loss.detach()
        grads = {}
        for name, p in params.items():
            # a branch this batch did not use (the embedding style's
            # MetadataEmbedding, which no entry point runs) takes a zero
            # gradient; AdamW's weight decay alone then moves it, which
            # changes no output
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if self.accum > 1:
                p.grad.mul_(1.0 / self.accum)
            grads[name] = p.grad
        return loss_sum, grads

    def _micro_loss(self, model, state: TrainState, x, y, meta, ya, yb, lam
                    ) -> torch.Tensor:
        out = model(x, meta, generator=state.generator)
        logits = out["logits"]
        if self.mix is None:
            loss = self.loss_fn(logits, y)
        else:
            loss = mixup_criterion(self.loss_fn, logits, ya, yb, lam)
        if self.seg_weight > 0:
            loss = loss + self.seg_weight * bce_dice_loss(
                out["seg_mask"], x[..., 3:4] * 0.5 + 0.5)
        return loss

    def apply_update(self, state: TrainState,
                     grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Optimizer update, EMA and ``step += 1``, in place; returns the
        global norm of ``grads`` before clipping (all of them, also where the
        optimizer updates only the head)."""
        with span("train.update"):
            grad_norm = global_norm(grads.values())
            state.tx.step(state.model, grads, state.opt_state)
            if self.ema_enabled and state.ema is not None:
                ema_update(state.ema, state.model, self.ema_decay)
            for p in state.model.parameters():
                p.grad = None
            state.step += 1
        return grad_norm

    def __call__(self, state: TrainState, batch: Dict
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        grads, loss, _ = self.accumulate_grads(state, batch)
        grad_norm = self.apply_update(state, grads)
        return state, {"loss": loss, "grad_norm": grad_norm}


def make_train_step(cfg: Config, loss_fn: LossFn,
                    augment: Optional[Callable] = None,
                    data: Optional[DataParallel] = None) -> TrainStep:
    """The train step for ``cfg``. With ``augment`` (fn(batch, generator),
    the on-device train augment) the batch arrives as raw uint8 canvases;
    without it, already augmented. ``model.remat`` is the model's
    (``build_model``): its blocks recompute their forward in the backward.
    With ``data`` the step is data-parallel over its group: SPMD (every rank
    given the whole macro batch) or per shard (each its shard)."""
    return TrainStep(cfg, loss_fn, augment, data)
