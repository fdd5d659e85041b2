"""Synthetic ISIC-like dataset, numpy only (a copy of
``fedvit_tpu/data/synthetic.py``): class-conditional images, so that training
can demonstrably learn, with correlated metadata and lesion-like masks. The
same arguments give the same arrays in both packages.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from fedvit_torch.data.constants import NUM_CLASSES, encode_metadata_batch


def make_synthetic_dataset(
    n: int = 256,
    image_size: int = 64,
    channels: int = 3,
    num_classes: int = NUM_CLASSES,
    seed: int = 0,
    noise: float = 0.25,
    class_skew: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Returns {"image" (N,H,W,C) float32 in [0,1], "label" (N,) int32,
    "metadata" (N,13), "mask" (N,H,W,1)}.

    Each class gets a distinct mean colour and spatial frequency pattern, so
    a small model can reach high accuracy quickly."""
    rng = np.random.default_rng(seed)
    if class_skew is None:
        labels = rng.integers(0, num_classes, size=n)
    else:
        labels = rng.choice(num_classes, size=n, p=class_skew)

    h = w = image_size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    images = np.empty((n, h, w, channels), dtype=np.float32)
    base_colors = rng.uniform(0.2, 0.8, size=(num_classes, channels)).astype(np.float32)
    freqs = np.linspace(1, num_classes, num_classes).astype(np.float32)

    for i in range(n):
        c = labels[i]
        pattern = 0.15 * np.sin(2 * np.pi * freqs[c] * xx / w) \
            * np.cos(2 * np.pi * freqs[c] * yy / h)
        img = base_colors[c][None, None, :] + pattern[:, :, None]
        img = img + rng.normal(0, noise, size=img.shape).astype(np.float32)
        images[i] = np.clip(img, 0.0, 1.0)

    # lesion-like circular mask at a random position
    masks = np.zeros((n, h, w, 1), dtype=np.float32)
    cy = rng.uniform(0.3, 0.7, n) * h
    cx = rng.uniform(0.3, 0.7, n) * w
    r = rng.uniform(0.15, 0.3, n) * min(h, w)
    for i in range(n):
        masks[i, :, :, 0] = (((yy - cy[i]) ** 2 + (xx - cx[i]) ** 2)
                             <= r[i] ** 2).astype(np.float32)

    # metadata correlated with class (age clusters per class)
    age = np.clip((labels / num_classes) + rng.normal(0, 0.1, n), 0, 1)
    sex = rng.integers(0, 3, n)
    site = labels % 9  # site correlated with class
    metadata = encode_metadata_batch(age, sex, site)

    return {
        "image": images,
        "label": labels.astype(np.int32),
        "metadata": metadata,
        "mask": masks,
    }


def batch_iterator(data: Dict[str, np.ndarray], batch_size: int,
                   seed: int = 0, shuffle: bool = True,
                   drop_last: bool = True,
                   include_mask_channel: bool = False,
                   epochs: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side batches over the synthetic arrays. No path of the port
    calls it yet: it is the batch source of the single-site trainer's
    synthetic runs once ``cli/train`` is ported, as the JAX package's step
    tests use its own (ROADMAP.md, "Order")."""
    n = len(data["label"])
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        stop = (n // batch_size) * batch_size if drop_last else n
        for s in range(0, stop, batch_size):
            sel = idx[s:s + batch_size]
            img = data["image"][sel]
            if include_mask_channel:
                img = np.concatenate([img, data["mask"][sel]], axis=-1)
            yield {
                "image": img,
                "label": data["label"][sel],
                "metadata": data["metadata"][sel],
            }
        epoch += 1
