"""ADOTA server optimizers (Algorithm 1 of the paper) on slabs.

PyTorch counterpart of the slab side of ``repro.core.adaptive``:

    Delta_t = beta1 * Delta_{t-1} + (1 - beta1) * g_t            (Eq. 8)
    v_t     = v_{t-1} + |Delta_t|^alpha                          (AdaGrad-OTA, Eq. 9)
    v_t     = beta2 * v_{t-1} + (1 - beta2) * |Delta_t|^alpha    (Adam-OTA,   Eq. 10)
    w_{t+1} = w_t - eta * Delta_t / (v_t + eps)^{1/alpha}        (Eq. 11)

plus the AMSGrad-OTA and Yogi-OTA extensions and the FedAvgM / FedAvg
baselines. The whole model is updated by ONE ``adaptive_update_slab``
launch over the resident slabs (``slab_update_slabs``). The per-leaf
pytree optimizers of the JAX package are not ported: the port's round is
slab-resident only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.kernels.adaptive_update import adaptive_update_slab


def _abs_pow(x: torch.Tensor, alpha) -> torch.Tensor:
    """Entrywise |x|^alpha, safe at x == 0 for fractional alpha."""
    ax = torch.abs(x)
    return torch.where(ax == 0, torch.zeros_like(ax), ax ** alpha)


def _alpha_root(x: torch.Tensor, alpha) -> torch.Tensor:
    """Entrywise x^{1/alpha} for x >= 0."""
    return torch.clamp_min(x, 0.0) ** (1.0 / alpha)


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Hyper-parameters of the ADOTA family (paper Sec. IV-B, Sec. VI).

    Fields, defaults and checks as in ``repro.core.adaptive.AdaptiveConfig``,
    without ``backend`` and ``interpret``. ``alpha="auto"`` (the closed
    tail-index loop) is accepted here and refused by the round until
    ROADMAP item A7 ports it.
    """

    optimizer: str = "adam_ota"   # adagrad_ota | adam_ota | amsgrad_ota |
                                  # yogi_ota | fedavgm | fedavg
    lr: float = 1e-2              # eta
    beta1: float = 0.9            # momentum on Delta_t
    beta2: float = 0.3            # Adam-OTA amortization (paper fig.4 best: 0.3)
    alpha: Any = 1.5              # interference tail index of the v-update,
                                  # a float or "auto"
    alpha_ema: float = 0.1        # EMA weight of the tracked estimate
    eps: float = 1e-8             # ill-conditioning guard (inside the root)
    momentum: float = 0.9         # FedAvgM server momentum

    def __post_init__(self):
        if isinstance(self.alpha, str) and self.alpha != "auto":
            raise ValueError(
                f'alpha must be a float tail index or "auto" (online '
                f'tracking), got {self.alpha!r}')
        if not (0.0 < self.alpha_ema <= 1.0):
            raise ValueError(
                f"alpha_ema must be in (0, 1], got {self.alpha_ema}")

    @property
    def track_alpha(self) -> bool:
        return self.alpha == "auto"

    def resolve_alpha(self, alpha):
        """An explicit override wins; otherwise the static config float."""
        if alpha is not None:
            return alpha
        if self.track_alpha:
            raise NotImplementedError(
                'AdaptiveConfig.alpha == "auto" (the closed tail-index '
                'loop) is not ported yet: ROADMAP item A7')
        return self.alpha


# Optimizer name -> fused-kernel mode of repro_torch.kernels.adaptive_update.
_SLAB_MODES = {
    "adagrad_ota": "adagrad",
    "adam_ota": "adam",
    "amsgrad_ota": "amsgrad",
    "yogi_ota": "yogi",
    "fedavgm": "momentum",
    "fedavg": "sgd",
}


def _mode(cfg: AdaptiveConfig) -> str:
    if cfg.optimizer not in _SLAB_MODES:
        raise ValueError(f"unknown server optimizer {cfg.optimizer!r}; "
                         f"options: {sorted(_SLAB_MODES)}")
    return _SLAB_MODES[cfg.optimizer]


def state_slab_rows(cfg: AdaptiveConfig) -> Tuple[str, ...]:
    """Names of the optimizer-state slabs the fused kernel carries, in
    the fixed row order of ``slab_update_slabs``: empty for sgd,
    ("delta",) for momentum, ("delta", "nu", "vmax") for amsgrad,
    ("delta", "nu") otherwise."""
    mode = _mode(cfg)
    if mode == "sgd":
        return ()
    if mode == "momentum":
        return ("delta",)
    if mode == "amsgrad":
        return ("delta", "nu", "vmax")
    return ("delta", "nu")


def slab_update_slabs(cfg: AdaptiveConfig, g_slab: torch.Tensor,
                      state_slabs: Tuple[torch.Tensor, ...],
                      w_slab: torch.Tensor, alpha=None
                      ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """ONE fused ``adaptive_update_slab`` launch on raw 1-D slabs.

    ``state_slabs`` is in ``state_slab_rows`` order. ``alpha`` optionally
    overrides ``cfg.alpha``. Returns ``(new_state_slabs, w')``.
    """
    mode = _mode(cfg)
    a = 2.0 if mode in ("momentum", "sgd") else cfg.resolve_alpha(alpha)
    kw = dict(lr=cfg.lr,
              beta1=cfg.momentum if mode == "momentum" else cfg.beta1,
              beta2=cfg.beta2, alpha=a, eps=cfg.eps, mode=mode)
    if mode == "sgd":
        (w_n,) = adaptive_update_slab(g_slab, None, None, w_slab, **kw)
        return (), w_n
    if mode == "momentum":
        d_n, w_n = adaptive_update_slab(g_slab, state_slabs[0], None, w_slab,
                                        **kw)
        return (d_n,), w_n
    if mode == "amsgrad":
        d_s, v_s, m_s = state_slabs
        d_n, v_n, m_n, w_n = adaptive_update_slab(g_slab, d_s, v_s, w_slab,
                                                  nu_max=m_s, **kw)
        return (d_n, v_n, m_n), w_n
    d_s, v_s = state_slabs
    d_n, v_n, w_n = adaptive_update_slab(g_slab, d_s, v_s, w_slab, **kw)
    return (d_n, v_n), w_n
