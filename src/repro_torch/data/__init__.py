"""Synthetic data, client partitions and federated batching.

The port's own copy of ``repro.data`` (numpy only): the same seeds give
the same arrays as the JAX package's modules.
"""

from repro_torch.data.partition import (dirichlet_partition,
                                        heterogeneity_index, iid_partition)
from repro_torch.data.pipeline import FederatedBatcher
from repro_torch.data.synthetic import (ClassificationData, gaussian_mixture,
                                        lm_batches, synthetic_images,
                                        token_stream)

__all__ = ["dirichlet_partition", "heterogeneity_index", "iid_partition",
           "FederatedBatcher", "ClassificationData", "gaussian_mixture",
           "lm_batches", "synthetic_images", "token_stream"]
