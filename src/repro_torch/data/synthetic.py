"""Synthetic datasets (the container is offline — no CIFAR/EMNIST
downloads). Each generator keeps the statistical knobs the paper varies:
class structure for the classification tasks, and a power-law token
distribution for the LM tasks.
"""

from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass
class ClassificationData:
    x: np.ndarray          # (N, d) float32 or (N, H, W, C) images
    y: np.ndarray          # (N,) int64
    n_classes: int


def gaussian_mixture(n: int, d: int, n_classes: int, seed: int = 0,
                     sep: float = 2.0, noise: float = 1.0
                     ) -> ClassificationData:
    """EMNIST-like stand-in: one Gaussian blob per class (separation
    ``sep``), the regime where logistic regression is the right model —
    matching the paper's convex EMNIST experiment."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, sep, (n_classes, d)).astype(np.float32)
    y = rng.integers(0, n_classes, n).astype(np.int64)
    x = means[y] + noise * rng.normal(0, 1, (n, d)).astype(np.float32)
    return ClassificationData(x, y, n_classes)


def synthetic_images(n: int, size: int = 16, channels: int = 3,
                     n_classes: int = 10, seed: int = 0
                     ) -> ClassificationData:
    """CIFAR-like stand-in: class-specific low-frequency templates +
    pixel noise; requires conv features to separate well (exercises the
    ResNet-tiny model the way CIFAR exercises ResNet-18)."""
    rng = np.random.default_rng(seed)
    # Low-frequency class templates via random 4x4 patterns upsampled.
    small = rng.normal(0, 1, (n_classes, 4, 4, channels)).astype(np.float32)
    templates = np.repeat(np.repeat(small, size // 4, 1), size // 4, 2)
    y = rng.integers(0, n_classes, n).astype(np.int64)
    x = templates[y] + 0.8 * rng.normal(0, 1, (n, size, size, channels)
                                        ).astype(np.float32)
    return ClassificationData(x.astype(np.float32), y, n_classes)


def token_stream(n_tokens: int, vocab: int, seed: int = 0,
                 order: int = 2) -> np.ndarray:
    """Synthetic LM corpus: Zipfian unigram mixed with a deterministic
    bigram rule so there is actual structure to learn (loss falls below
    the unigram entropy when the model works)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks
    p /= p.sum()
    toks = rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)
    # Deterministic structure: with prob 1/2, next token = (prev * 7 + 3) % vocab.
    mask = rng.random(n_tokens) < 0.5
    for i in range(1, n_tokens):
        if mask[i]:
            toks[i] = (toks[i - 1] * 7 + 3) % vocab
    return toks


def lm_batches(tokens: np.ndarray, batch: int, seq: int, n_batches: int,
               seed: int = 0) -> np.ndarray:
    """Sample (n_batches, batch, seq) windows from a token stream."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(tokens) - seq - 1, (n_batches, batch))
    return np.stack([[tokens[s:s + seq] for s in row] for row in starts])
