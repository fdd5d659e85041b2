"""Serving loop — the eval step, full-dataset evaluation and 8-view TTA.

Counterparts: ``fedvit_tpu/train/step.py::make_eval_step`` and
``fedvit_tpu/train/loop.py``'s ``_pad_batch``, ``_evaluate``, ``_softmax``,
``_make_tta_step`` and ``evaluate_with_tta`` (the 8 deterministic views, or
the old generation's named views of ``training.tta.views``). The model carries its own
weights (the JAX functions take ``params``/``batch_stats``; the fold trainer
evaluates on the EMA shadow by swapping it into the model, ``TrainState.
ema_weights``), batches arrive as dicts of uint8 canvases, numpy on the host
or tensors already on the device (``DeviceDataSource``), and go to the
model's device, and every forward runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fedvit_torch.core.config import Config
from fedvit_torch.eval.metrics import compute_metrics
from fedvit_torch.ops import image as I
from fedvit_torch.utils.profiling import span


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every entry of a batch of numpy arrays or tensors, as a tensor on
    ``device``."""
    return {k: torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.asarray(v)).to(device)
            for k, v in batch.items()}


def make_eval_step(model: nn.Module, cfg: Config,
                   augment: Optional[Callable] = None) -> Callable:
    """eval_step(batch) → logits (B, C) fp32 on the model's device.

    ``batch`` is a host dict of numpy arrays; with ``augment`` (the eval
    transform from ``make_device_augment``) its "image" is the raw uint8
    canvas. The model runs in evaluation mode (``deterministic=True`` in
    the JAX step), whatever mode a train step left it in. ``_evaluate``
    computes the loss the JAX step returns beside the logits. The copy to
    the device, the augment and the forward are the spans ``serve.copy``,
    ``serve.augment`` and ``serve.forward`` (``utils/profiling.py``)."""
    use_meta = cfg.model.metadata.enabled
    device = _device_of(model)

    @torch.inference_mode()
    def eval_step(batch: Dict) -> torch.Tensor:
        model.eval()
        with span("serve.copy"):
            batch = _to_device(batch, device)
        if augment is not None:
            with span("serve.augment"):
                batch = augment(batch)
        metadata = batch.get("metadata") if use_meta else None
        with span("serve.forward"):
            return model(batch["image"], metadata)["logits"]

    return eval_step


def _pad_batch(batch: Dict, batch_size: int) -> Dict:
    """Pad every value to batch_size rows by repeating the last row — on its
    device for a tensor, in numpy otherwise."""
    out = {}
    for k, v in batch.items():
        pad = batch_size - v.shape[0]
        if pad <= 0:
            out[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = torch.cat([v, v[-1:].expand((pad,) + v.shape[1:])])
        else:
            out[k] = np.concatenate([v, np.repeat(v[-1:], pad, 0)])
    return out


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _softmax(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _evaluate(eval_step: Callable, source, batch_size: int,
              num_classes: int, loss_fn: Optional[Callable] = None) -> Dict:
    """Full-dataset eval → metric dict (reference validate/evaluate), plus
    "loss", "probs" and raw "logits". A ragged last batch is padded to
    batch_size (every forward sees one shape) and its outputs trimmed. The
    loss (``loss_fn`` of the trimmed logits and labels, on the model's
    device; 0 without one) is the mean over batches weighted by each batch's
    size, so the padding does not bias it."""
    y_true: List[int] = []
    y_pred: List[int] = []
    all_logits: List[np.ndarray] = []
    losses: List[Tuple[float, int]] = []
    for batch in source.sequential_batches(batch_size):
        n = len(batch["label"])
        if n < batch_size:
            batch = _pad_batch(batch, batch_size)
        logits = eval_step(batch)[:n]
        labels_n = _host(batch["label"])[:n]
        if loss_fn is not None:
            labels = torch.as_tensor(labels_n, device=logits.device).long()
            losses.append((float(loss_fn(logits.float(), labels)), n))
        logits_n = logits.float().cpu().numpy()
        y_true.extend(labels_n.tolist())
        y_pred.extend(logits_n.argmax(-1).tolist())
        all_logits.append(logits_n)
    logits_all = (np.concatenate(all_logits) if all_logits
                  else np.zeros((0, num_classes), np.float32))
    probs = _softmax(logits_all) if all_logits else np.zeros((0, num_classes))
    m = compute_metrics(y_true, y_pred, num_classes,
                        probs if all_logits else None)
    total = sum(n for _, n in losses) or 1
    m["loss"] = sum(value * n for value, n in losses) / total
    m["probs"] = probs
    m["logits"] = logits_all
    return m


def _make_tta_step(model: nn.Module, size: int, use_mask: bool,
                   use_meta: bool, named_views: Tuple[str, ...] = ()
                   ) -> Callable:
    """tta_step(raw (B, H, W, 3|4) uint8, metadata (B, 13)) → view-averaged
    logits (B, C): the views go through one forward of B·T images. They are
    the 8 of ``tta_views``, or with ``named_views`` those of
    ``tta_views_named`` on the RGB channels. The mask comes only from a
    packed 4th channel, as in JAX, which never segments here: a mask model
    given 3-channel canvases (those of ``data.on_device_masks``) is refused
    where JAX's forward fails on them."""

    @torch.inference_mode()
    def tta_step(raw: torch.Tensor, metadata: torch.Tensor) -> torch.Tensor:
        if use_mask and not named_views and raw.shape[-1] != 4:
            raise ValueError(
                "TTA takes the mask from a 4th canvas channel and does not "
                "segment: with data.use_segmentation_mask and "
                "data.on_device_masks the canvases have 3 channels, so TTA "
                "cannot run (the JAX package fails here too); set "
                "training.tta.enabled: false, or predict without --tta")
        model.eval()
        img = I.to_float(raw[..., :3])
        mask = (I.to_float(raw[..., 3:4])
                if use_mask and raw.shape[-1] == 4 else None)
        if named_views:
            views, mviews = I.tta_views_named(img, named_views, size), None
        else:
            views, mviews = I.tta_views(img, mask, out_size=size)
        if mviews is not None:
            views = torch.cat([views, mviews], dim=-1)
        b, t = views.shape[:2]
        flat = views.reshape((b * t,) + views.shape[2:])
        meta = metadata.repeat_interleave(t, dim=0) if use_meta else None
        logits = model(flat, meta)["logits"]
        return logits.reshape(b, t, -1).mean(dim=1)

    return tta_step


def evaluate_with_tta(cfg: Config, model: nn.Module, source,
                      batch_size: Optional[int] = None
                      ) -> Tuple[List[int], List[int], np.ndarray]:
    """TTA eval: 8 deterministic views, or the named views of
    ``training.tta.views``, logits averaged over the views (reference
    utils.py:200-230 + TTADataset; data_old.py:208-304). Returns (y_pred,
    y_true, logits (N, C)). Named views are a 3-channel pipeline and refuse
    ``data.use_segmentation_mask``, as JAX's do."""
    named_views = tuple(cfg.training.tta.views)
    if named_views and cfg.data.use_segmentation_mask:
        raise ValueError(
            "tta.views (old-gen corner-crop TTA, data_old.py:208-304) is a "
            "3-channel pipeline — the old generation feeds masks to the "
            "segmentation branch, not as a 4th input channel")
    bs = batch_size or max(1, cfg.training.batch_size // 4)
    device = _device_of(model)
    tta_step = _make_tta_step(model, cfg.model.image_size,
                              cfg.data.use_segmentation_mask,
                              cfg.model.metadata.enabled, named_views)
    y_true, y_pred, all_logits = [], [], []
    for batch in source.sequential_batches(bs):
        n = len(batch["label"])
        if n < bs:
            batch = _pad_batch(batch, bs)
        dev = _to_device({"image": batch["image"],
                          "metadata": batch["metadata"]}, device)
        logits = tta_step(dev["image"], dev["metadata"])[:n]
        logits = logits.float().cpu().numpy()
        y_true.extend(_host(batch["label"])[:n].tolist())
        y_pred.extend(logits.argmax(-1).tolist())
        all_logits.append(logits)
    return y_pred, y_true, (np.concatenate(all_logits) if all_logits
                            else np.zeros((0, cfg.num_classes), np.float32))
