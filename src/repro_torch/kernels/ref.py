"""Plain PyTorch versions of the port's kernels.

Counterparts of ``repro.kernels.ref`` (``adaptive_update_ref``,
``ota_channel_ref``) and of ``repro.core.tail_index.log_moment_stats``.
They are the CPU path of the kernel wrappers, the versions the tests
hold against the JAX package, and the versions ``chip_smoke.py`` holds
each CUDA kernel against on the card. The expressions are written out
op for op as in the JAX oracles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.channel import CMS_E_FLOOR, CMS_U_BOUND

_TINY = torch.finfo(torch.float32).tiny


def adaptive_update_ref(g: torch.Tensor, delta, nu, w: torch.Tensor, *,
                        lr: float, beta1: float, beta2: float, alpha,
                        eps: float, mode: str, nu_max=None
                        ) -> Tuple[torch.Tensor, ...]:
    """One fused server update on a flat parameter slab (paper Eq. 8-11).

    mode: "adagrad" -> v += |Delta|^a ; "adam" -> v = b2 v + (1-b2)|Delta|^a ;
    "amsgrad" -> adam v plus non-decreasing vmax denominator ; "yogi" ->
    sign-controlled additive v ; "momentum" -> FedAvgM (Delta = b1 Delta + g,
    no v; beta1 is the momentum coefficient) ; "sgd" -> plain FedAvg.
    State is f32; w keeps its dtype. ``alpha`` is a float or a 0-dim f32
    tensor. Returns ``(*updated_state, w')`` in (delta, nu, nu_max) order.
    """
    gf = g.float()
    wf = w.float()
    if mode == "sgd":
        return ((wf - lr * gf).to(w.dtype),)
    gain = 1.0 if mode == "momentum" else (1.0 - beta1)
    delta = beta1 * delta + gain * gf
    if mode == "momentum":
        return delta, (wf - lr * delta).to(w.dtype)
    ad = torch.abs(delta)
    da = torch.where(ad == 0.0, torch.zeros_like(ad), ad ** alpha)
    if mode == "adagrad":
        nu = nu + da
    elif mode == "adam":
        nu = beta2 * nu + (1.0 - beta2) * da
    elif mode == "amsgrad":
        nu = beta2 * nu + (1.0 - beta2) * da
        nu_max = torch.maximum(nu_max, nu)
    elif mode == "yogi":
        nu = nu - (1.0 - beta2) * torch.sign(nu - da) * da
    else:
        raise ValueError(mode)
    denom_v = nu_max if mode == "amsgrad" else nu
    denom = torch.clamp_min(denom_v + eps, 0.0) ** (1.0 / alpha)
    w_new = (wf - lr * delta / denom).to(w.dtype)
    if mode == "amsgrad":
        return delta, nu, nu_max, w_new
    return delta, nu, w_new


def log_moment_stats(residual: torch.Tensor) -> torch.Tensor:
    """``[count, sum log|r|, sum log^2|r|]`` over the NONZERO entries of
    a pilot residual (``repro.core.tail_index.log_moment_stats``). The
    zero mask drops the slab's padding tail and the disabled channel."""
    r = torch.abs(residual.float().reshape(-1))
    m = r > 0.0
    logr = torch.where(m, torch.log(torch.clamp_min(r, _TINY)),
                       torch.zeros_like(r))
    return torch.stack([m.float().sum(), logr.sum(), (logr * logr).sum()])


def ota_channel_ref(grads: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                    e: torch.Tensor, *, alpha: float, scale: float,
                    n_total: Optional[int] = None,
                    pilot_stats: bool = False):
    """Fused OTA MAC on a slab: (1/n_total) sum_n h_n grads[n] + scale*xi,
    xi the guarded CMS transform of (u, e).

    grads: (N, d); h: (N,); u, e: (d,). ``n_total`` overrides the 1/N
    normalisation (defaults to N). Returns (d,) f32, plus the (3,)
    residual log-moment statistics when ``pilot_stats=True``.
    """
    n = grads.shape[0]
    if n_total is None:
        n_total = n
    agg = torch.einsum("n,nd->d", h.float(), grads.float()) / n_total
    a = alpha
    u = torch.clamp(u, -CMS_U_BOUND, CMS_U_BOUND)
    e = torch.clamp_min(e, CMS_E_FLOOR)
    xi = (torch.sin(a * u) / torch.cos(u) ** (1.0 / a)
          * (torch.cos((1.0 - a) * u) / e) ** ((1.0 - a) / a))
    out = agg + scale * xi
    if pilot_stats:
        return out, log_moment_stats(scale * xi)
    return out
