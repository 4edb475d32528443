"""Client-sharded batching for federated rounds.

``FederatedBatcher`` owns the per-client index partitions and yields, for
round t, the stacked per-client batches expected by
``repro_torch.core.fl.make_slab_round_step`` — leaves shaped (N, b, ...) (or
(N, k, b, ...) when local_steps > 1).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.data.partition import (dirichlet_partition, heterogeneity_index,
                                  iid_partition)
from repro_torch.data.synthetic import ClassificationData


class FederatedBatcher:
    def __init__(self, data: ClassificationData, n_clients: int,
                 batch_size: int, dir_alpha: Optional[float] = 0.1,
                 local_steps: int = 1, seed: int = 0):
        self.data = data
        self.n_clients = n_clients
        self.batch_size = batch_size
        self.local_steps = local_steps
        if dir_alpha is None:
            self.parts = iid_partition(len(data.y), n_clients, seed)
        else:
            # min_per_client=1: the sampler below draws with replacement
            # when a client's shard is smaller than its batch.
            self.parts = dirichlet_partition(data.y, n_clients, dir_alpha,
                                             seed, min_per_client=1)
        self.rng = np.random.default_rng(seed + 1)

    def __call__(self, round_idx: int, key=None) -> Dict[str, np.ndarray]:
        del round_idx, key
        k, b = self.local_steps, self.batch_size
        xs, ys = [], []
        for part in self.parts:
            take = self.rng.choice(part, size=k * b, replace=len(part) < k * b)
            xs.append(self.data.x[take])
            ys.append(self.data.y[take])
        x = np.stack(xs)     # (N, k*b, ...)
        y = np.stack(ys)
        if k > 1:
            x = x.reshape(self.n_clients, k, b, *x.shape[2:])
            y = y.reshape(self.n_clients, k, b)
        return {"x": x, "y": y}

    def heterogeneity(self) -> float:
        return heterogeneity_index(self.parts, self.data.y)
