"""Cross-validation splitters — the port's own copy of
``fedvit_tpu/data/splits.py`` (numpy only), so a seed gives the same folds in
both packages, index for index.

Replaces sklearn.model_selection.{StratifiedKFold, StratifiedGroupKFold}
(reference train.py:422-431: StratifiedGroupKFold on `lesion_id` when
available, else StratifiedKFold; shuffle=True, random_state=seed).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray]


def stratified_kfold(labels: np.ndarray, n_splits: int = 5,
                     shuffle: bool = True, seed: int = 42) -> List[Split]:
    """Per-class round-robin fold assignment → (train_idx, val_idx) list."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    fold_of = np.empty(len(labels), dtype=np.int64)
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        if shuffle:
            rng.shuffle(idx)
        fold_of[idx] = np.arange(len(idx)) % n_splits
    splits = []
    for f in range(n_splits):
        val = np.flatnonzero(fold_of == f)
        train = np.flatnonzero(fold_of != f)
        splits.append((train, val))
    return splits


def stratified_group_kfold(labels: np.ndarray, groups: np.ndarray,
                           n_splits: int = 5, seed: int = 42) -> List[Split]:
    """Greedy group-to-fold assignment: groups never straddle folds; each
    group goes to the fold where it least increases the per-class standard
    deviation across folds (the sklearn StratifiedGroupKFold heuristic)."""
    labels = np.asarray(labels)
    groups = np.asarray(groups)
    rng = np.random.default_rng(seed)
    classes, y = np.unique(labels, return_inverse=True)
    n_classes = len(classes)

    uniq, ginv = np.unique(groups, return_inverse=True)
    n_groups = len(uniq)
    # per-group class-count matrix
    gc = np.zeros((n_groups, n_classes), dtype=np.int64)
    np.add.at(gc, (ginv, y), 1)

    # process groups with most samples first (ties broken randomly)
    order = np.lexsort((rng.permutation(n_groups), -gc.sum(axis=1)))
    fold_counts = np.zeros((n_splits, n_classes), dtype=np.float64)
    fold_of_group = np.empty(n_groups, dtype=np.int64)

    for g in order:
        best_fold, best_eval = 0, np.inf
        for f in range(n_splits):
            fold_counts[f] += gc[g]
            # std over folds per class, averaged over classes
            ev = fold_counts.std(axis=0).mean()
            fold_counts[f] -= gc[g]
            if ev < best_eval:
                best_eval, best_fold = ev, f
        fold_counts[best_fold] += gc[g]
        fold_of_group[g] = best_fold

    fold_of = fold_of_group[ginv]
    splits = []
    for f in range(n_splits):
        val = np.flatnonzero(fold_of == f)
        train = np.flatnonzero(fold_of != f)
        splits.append((train, val))
    return splits


def make_cv_splits(labels: np.ndarray, groups: Optional[np.ndarray],
                   n_splits: int = 5, seed: int = 42) -> List[Split]:
    """The reference's split choice (train.py:422-431): group K-fold when a
    usable group column exists (more than one distinct group), else plain
    stratified K-fold."""
    if groups is not None and len(np.unique(groups)) > 1:
        return stratified_group_kfold(labels, groups, n_splits, seed)
    return stratified_kfold(labels, n_splits, shuffle=True, seed=seed)
