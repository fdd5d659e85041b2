"""Federated client partitioners, numpy only (a copy of
``fedvit_tpu/fed/partition.py``): the same labels and seed give the same
clients in both packages.

Each partitioner returns a list of sorted index arrays, one per client.
"""

from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(labels: np.ndarray, num_clients: int,
                  seed: int = 0) -> List[np.ndarray]:
    """Uniform random split."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0,
                        min_samples: int = 1) -> List[np.ndarray]:
    """Non-IID class-skew split: for each class, distribute its samples over
    clients with proportions ~ Dirichlet(α). Small α → heavy skew.

    Retries, drawing on from the same generator, until every client has at
    least ``min_samples``."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    for _attempt in range(100):
        client_idx: List[List[int]] = [[] for _ in range(num_clients)]
        for c in range(num_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(props)[:-1] * len(idx_c)).astype(int)
            for client, part in enumerate(np.split(idx_c, cuts)):
                client_idx[client].extend(part.tolist())
        if min(len(ci) for ci in client_idx) >= min_samples:
            return [np.sort(np.array(ci, dtype=np.int64)) for ci in client_idx]
    raise RuntimeError(
        f"dirichlet_partition: could not give every client ≥{min_samples} "
        f"samples (α={alpha}, clients={num_clients})")


def shard_partition(labels: np.ndarray, num_clients: int,
                    shards_per_client: int = 2, seed: int = 0
                    ) -> List[np.ndarray]:
    """McMahan-style pathological split: sort by label, cut into
    num_clients·shards_per_client shards, deal shards to clients."""
    rng = np.random.default_rng(seed)
    order = np.argsort(np.asarray(labels), kind="stable")
    shards = np.array_split(order, num_clients * shards_per_client)
    shard_ids = rng.permutation(len(shards))
    out = []
    for c in range(num_clients):
        ids = shard_ids[c * shards_per_client:(c + 1) * shards_per_client]
        out.append(np.sort(np.concatenate([shards[i] for i in ids])))
    return out


def partition(kind: str, labels: np.ndarray, num_clients: int,
              alpha: float = 0.5, seed: int = 0) -> List[np.ndarray]:
    if kind == "iid":
        return iid_partition(labels, num_clients, seed)
    if kind == "dirichlet":
        return dirichlet_partition(labels, num_clients, alpha, seed)
    if kind == "shards":
        return shard_partition(labels, num_clients, seed=seed)
    raise ValueError(f"Unknown partition kind: {kind}")


def client_weights(parts: List[np.ndarray]) -> np.ndarray:
    """FedAvg weights ∝ per-client sample counts, float32."""
    sizes = np.array([len(p) for p in parts], dtype=np.float64)
    return (sizes / sizes.sum()).astype(np.float32)
