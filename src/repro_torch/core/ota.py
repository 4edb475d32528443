"""Analog over-the-air (A-OTA) gradient aggregation on slabs (Eq. 7).

    g_t = (1/N) * sum_n h_{n,t} * grad_n  +  xi_t

PyTorch counterpart of the slab path of ``repro.core.ota``. The client
gradients are stacked into one (N, padded) slab and the whole MAC is ONE
``ota_channel_slab`` launch: fading reduction and CMS interference
synthesis in a single read of the gradients.

The JAX function derives its draws from the round key inside the round
(``kh, kx = split(key)``); here they arrive as ``RoundDraws``
(``repro_torch.core.draws``), so the same draws can come from the JAX
package (the parity tests) or from a torch generator (standalone runs).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import RoundDraws
from repro_torch.core.slab import SlabSpec, stack_to_slab
from repro_torch.kernels.ota_channel import ota_channel_slab

PyTree = Any


def _interference_slab_inputs(draws: RoundDraws, cfg: OTAChannelConfig,
                              spec: SlabSpec
                              ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(u, e, scale) of the interference-injection stage; the disabled
    channel degenerates to the (0, 1, 0.0) fixed point (xi == 0)."""
    if draws.u.shape != (spec.padded,) or draws.e.shape != (spec.padded,):
        raise ValueError(f"draws.u/e must be ({spec.padded},), got "
                         f"{tuple(draws.u.shape)}/{tuple(draws.e.shape)}")
    if cfg.interference:
        return draws.u, draws.e, cfg.xi_scale
    return (torch.zeros_like(draws.u), torch.ones_like(draws.e), 0.0)


def ota_aggregate_slab(draws: RoundDraws, cfg: OTAChannelConfig,
                       client_grads: PyTree, spec: SlabSpec,
                       pilot_stats: bool = False,
                       ef: Optional[torch.Tensor] = None):
    """Slab-engine OTA MAC, single device, f32 uplink.

    ``spec`` is the slab layout of ONE client's gradient. Returns
    ``(g_slab, h, grads_slab, stats, ef_new)`` as the JAX function does:
    the (padded,) noisy aggregate, the fading draw (N,), the stacked
    (N, padded) gradient slab, the (3,) residual statistics when
    ``pilot_stats=True`` (else None), and None for the error-feedback
    residual.
    """
    if cfg.uplink.quantized:
        raise NotImplementedError(
            f"uplink={cfg.uplink.mode!r} is not ported yet (quantized "
            "wire): ROADMAP item A8")
    if ef is not None:
        raise NotImplementedError(
            "error feedback belongs to the quantized uplink, which is not "
            "ported yet: ROADMAP item A8")
    grads_slab = stack_to_slab(spec, client_grads)
    n = grads_slab.shape[0]
    if draws.h.shape != (n,):
        raise ValueError(f"draws.h must be ({n},), got {tuple(draws.h.shape)}")
    u, e, scale = _interference_slab_inputs(draws, cfg, spec)
    g_slab = ota_channel_slab(grads_slab, draws.h, u, e, alpha=cfg.alpha,
                              scale=scale, pilot_stats=pilot_stats)
    stats = None
    if pilot_stats:
        g_slab, stats = g_slab
    return g_slab, draws.h, grads_slab, stats, None
