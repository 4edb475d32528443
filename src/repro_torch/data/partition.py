"""Non-iid client partitioning (paper Sec. VI-A).

The paper partitions CIFAR/EMNIST across clients with a symmetric
Dirichlet distribution over label proportions, concentration ``Dir``
(default 0.1; smaller = more heterogeneous). ``dirichlet_partition``
reproduces that exactly: for each class, a Dirichlet(Dir) draw over the
N clients splits that class's examples.
"""

from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, dir_alpha: float,
                        seed: int = 0, min_per_client: int = 1
                        ) -> List[np.ndarray]:
    """Return per-client index arrays partitioning ``labels``.

    Retries until every client has at least ``min_per_client`` examples
    (standard practice; Dir=0.1 frequently starves clients otherwise).
    """
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        idx_by_client = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet([dir_alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx_c, cuts)):
                idx_by_client[client].append(part)
        parts = [np.concatenate(p) for p in idx_by_client]
        if min(len(p) for p in parts) >= min_per_client:
            for p in parts:
                rng.shuffle(p)
            return parts
    raise RuntimeError("dirichlet_partition: could not satisfy min_per_client")


def iid_partition(n_examples: int, n_clients: int, seed: int = 0
                  ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_examples)
    return list(np.array_split(idx, n_clients))


def heterogeneity_index(parts: List[np.ndarray], labels: np.ndarray) -> float:
    """Mean TV distance between per-client label dists and the global one
    (0 = iid). Used by tests to assert Dir ordering."""
    n_classes = int(labels.max()) + 1
    global_p = np.bincount(labels, minlength=n_classes) / len(labels)
    tv = []
    for p in parts:
        cp = np.bincount(labels[p], minlength=n_classes) / max(len(p), 1)
        tv.append(0.5 * np.abs(cp - global_p).sum())
    return float(np.mean(tv))
