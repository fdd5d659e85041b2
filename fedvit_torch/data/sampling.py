"""Class-balancing sampler and epoch batch plans, numpy only (a copy of
``fedvit_tpu/data/sampling.py``): the same ``numpy.random.Generator`` gives
the same plan in both packages.

Parity: the reference's WeightedRandomSampler (reference data.py:457-464):
weights = 1/class-count (empty classes counted as 1), num_samples = N,
replacement=True, drop_last=True.
"""

from __future__ import annotations

import numpy as np

from fedvit_torch.data.constants import NUM_CLASSES


def class_balanced_weights(labels: np.ndarray,
                           num_classes: int = NUM_CLASSES) -> np.ndarray:
    """Per-sample probability ∝ 1/class-count (reference data.py:459-463)."""
    labels = np.asarray(labels, dtype=np.int64)
    counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
    counts[counts == 0] = 1.0
    w = (1.0 / counts)[labels]
    return w / w.sum()


def compute_class_weights(labels: np.ndarray,
                          num_classes: int = NUM_CLASSES) -> np.ndarray:
    """sklearn "balanced" class weights: N / (C · count_c)
    (old-gen compute_class_weights, data_old.py:455-463)."""
    labels = np.asarray(labels, dtype=np.int64)
    counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
    present = counts > 0
    w = np.zeros(num_classes)
    w[present] = len(labels) / (present.sum() * counts[present])
    return w.astype(np.float32)


def epoch_indices(labels: np.ndarray, batch_size: int, rng: np.random.Generator,
                  weighted: bool = True, drop_last: bool = True) -> np.ndarray:
    """One epoch of sample indices, shaped (steps, batch_size)."""
    n = len(labels)
    if weighted:
        p = class_balanced_weights(labels)
        idx = rng.choice(n, size=n, replace=True, p=p)
    else:
        idx = rng.permutation(n)
    steps = n // batch_size if drop_last else int(np.ceil(n / batch_size))
    idx = (idx[:steps * batch_size] if drop_last
           else np.resize(idx, steps * batch_size))
    return idx.reshape(steps, batch_size)
