"""On-line estimation of the interference tail index alpha (paper Remark 3).

PyTorch counterpart of ``repro.core.tail_index``. For
X ~ S(alpha, beta=0, c, 0) the log-moment estimator (Ma & Nikias, 1995)
uses

    E[log|X|]   = euler_gamma * (1/alpha - 1) + log c
    Var[log|X|] = (pi^2 / 6) * (1/alpha^2 + 1/2)

so 1/alpha^2 = 6 Var[log|X|] / pi^2 - 1/2, clipped into alpha in
(1.01, 2]. The channel and receive kernels reduce the injected residual
to ``[count, sum log|r|, sum log^2|r|]`` (``log_moment_stats``);
``alpha_from_log_moments`` turns those into the same estimate, and
``update_alpha_ema`` folds it into the resident ``alpha_hat``.

Every function stays on the tensors' device and reads nothing back to
the host: the branches are ``torch.where``, so a tracked round makes no
device sync.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EULER = 0.5772156649015329
_TINY = torch.finfo(torch.float32).tiny


def log_moment_estimate(samples: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha_hat, scale_hat) of a symmetric alpha-stable law from raw
    i.i.d. samples, alpha clipped to (1.01, 2.0]."""
    x = torch.abs(samples.float().reshape(-1))
    lx = torch.log(torch.clamp_min(x, _TINY))
    mean = torch.mean(lx)
    var = torch.var(lx, correction=0)
    inv_a2 = torch.clamp_min(6.0 * var / (math.pi ** 2) - 0.5, 1e-6)
    alpha = torch.clamp(1.0 / torch.sqrt(inv_a2), 1.01, 2.0)
    scale = torch.exp(mean - _EULER * (1.0 / alpha - 1.0))
    return alpha, scale


def hill_estimate(samples: torch.Tensor, k_frac: float = 0.05
                  ) -> torch.Tensor:
    """Hill estimator over the k largest |samples| (a cross-check of the
    log-moment estimator, not used by the optimizer). ``k = max(8,
    k_frac n)`` clamped to ``n - 1``; the result is clipped to
    [0.5, 4.0], which keeps all-equal samples and n == 1 finite."""
    x = torch.abs(samples.float().reshape(-1))
    n = x.shape[0]
    k = min(max(8, int(k_frac * n)), n - 1)
    top = torch.topk(x, k + 1).values
    logs = torch.log(torch.clamp_min(top, _TINY))
    denom = torch.sum(logs[:k] - logs[k])
    alpha = k / torch.clamp_min(denom, _TINY)
    return torch.clamp(alpha, 0.5, 4.0)


def log_moment_stats(residual: torch.Tensor) -> torch.Tensor:
    """``[count, sum log|r|, sum log^2|r|]`` over the NONZERO entries of
    a pilot residual. The zero mask drops the slab's padding tail and
    the disabled channel; statistics of disjoint slices add."""
    r = torch.abs(residual.float().reshape(-1))
    m = r > 0.0
    logr = torch.where(m, torch.log(torch.clamp_min(r, _TINY)),
                       torch.zeros_like(r))
    return torch.stack([m.float().sum(), logr.sum(), (logr * logr).sum()])


def alpha_from_log_moments(stats: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha_hat, scale_hat) from reduced ``[count, sum log|r|,
    sum log^2|r|]`` statistics. ``count == 0`` returns the (meaningless)
    clip values; callers gate on ``stats[0]``."""
    count = torch.clamp_min(stats[0], 1.0)
    mean = stats[1] / count
    var = torch.clamp_min(stats[2] / count - mean * mean, 0.0)
    inv_a2 = torch.clamp_min(6.0 * var / (math.pi ** 2) - 0.5, 1e-6)
    alpha = torch.clamp(1.0 / torch.sqrt(inv_a2), 1.01, 2.0)
    scale = torch.exp(mean - _EULER * (1.0 / alpha - 1.0))
    return alpha, scale


def update_alpha_ema(alpha_hat: torch.Tensor, stats: torch.Tensor,
                     rho: float = 0.1) -> torch.Tensor:
    """One step of the resident EMA. ``alpha_hat == 0`` is the unseeded
    sentinel: the first round with an observed residual adopts the raw
    estimate, later rounds blend with weight ``rho``, and rounds with no
    residual (``stats[0] == 0``) pass the previous value through."""
    est, _ = alpha_from_log_moments(stats)
    blended = torch.where(alpha_hat > 0.0,
                          (1.0 - rho) * alpha_hat + rho * est, est)
    return torch.where(stats[0] > 0.0, blended, alpha_hat)


def effective_alpha(alpha_hat: torch.Tensor) -> torch.Tensor:
    """The tail index the update consumes under tracking: the EMA once
    seeded, else the Gaussian endpoint 2.0."""
    return torch.where(alpha_hat > 0.0, alpha_hat,
                       torch.full_like(alpha_hat, 2.0))


def estimate_from_gradient_residual(g_clean: torch.Tensor,
                                    g_noisy: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate alpha from the residual of a known-clean reference
    gradient against the over-the-air one."""
    return log_moment_estimate((g_noisy - g_clean).reshape(-1))
