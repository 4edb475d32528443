"""Analog over-the-air (A-OTA) gradient aggregation on slabs (Eq. 7).

    g_t = (1/N) * sum_n h_{n,t} * grad_n  +  xi_t

PyTorch counterpart of the slab path of ``repro.core.ota``. The client
gradients are stacked into one (N, padded) slab. The f32 uplink is ONE
``ota_channel_slab`` launch: fading reduction and CMS interference
synthesis in a single read of the gradients. A quantized uplink
(``UplinkConfig.mode`` "int8" or "sign") stages it: ONE
``ota_transmit_slab`` launch quantizes the faded partial sum (plus the
error-feedback residual) on write, the sign payload is packed into
uint32 words for the ``fold`` / ``planes`` wires (plain torch, as the
JAX package packs outside its kernel), and ONE ``ota_receive_slab``
launch dequantizes and adds the interference.

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
from repro_torch.kernels.ota_channel import (INT8_MAX, LANE, ota_channel_slab,
                                             ota_receive_slab,
                                             ota_transmit_slab,
                                             pack_sign_slab)

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


def restore_zero_tail(x: Optional[torch.Tensor], spec: SlabSpec
                      ) -> Optional[torch.Tensor]:
    """Re-pin the slab's zero padding tail after the folded sign wire.

    The 1-bit ``fold`` container cannot carry a 0: padding coordinates
    in the slab's last partial 128-block ride as +1 and dequantize to
    +scale. Padding is layout, not model state, so the slab layer
    re-masks the fold wire's outputs here, as the JAX package does. The
    pilot statistics are taken before this mask. None passes through.
    """
    if x is None:
        return x
    pos = torch.arange(x.shape[-1], device=x.device)
    return torch.where(pos < spec.total, x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def downlink_quantize_slab(w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Simulated int8 model broadcast: quantize the (d,) weight slab per
    128-block (scale max|x|/127, 1 for an all-zero block) with stochastic
    rounding ``r`` and return the dequantized (d,) f32 the clients see.
    Plain torch, as the JAX package writes it in plain jnp; the server
    keeps the f32 master."""
    d = w.shape[0]
    a = w.float().reshape(d // LANE, LANE)
    maxabs = torch.amax(torch.abs(a), dim=1, keepdim=True)
    s = torch.where(maxabs > 0.0, maxabs / INT8_MAX, torch.ones_like(maxabs))
    q = torch.clamp(torch.floor(a / s + r.reshape(d // LANE, LANE)),
                    -INT8_MAX, INT8_MAX)
    return (q * s).reshape(-1)


def ota_aggregate_slab(draws: RoundDraws, cfg: OTAChannelConfig,
                       client_grads: PyTree, spec: SlabSpec,
                       pilot_stats: bool = False,
                       ef: Optional[torch.Tensor] = None):
    """Slab-engine OTA MAC, single device: the staged uplink.

    ``spec`` is the slab layout of ONE client's gradient. Returns
    ``(g_slab, h, grads_slab, stats, ef_new)`` as the JAX function does:
    the (padded,) noisy aggregate, the fading draw (N,), the stacked
    (N, padded) gradient slab, the (3,) residual statistics when
    ``pilot_stats=True`` (else None), and, when ``ef`` (the carried
    (padded,) error-feedback residual) is given, the fresh residual to
    carry into the next round (else None).
    """
    grads_slab = stack_to_slab(spec, client_grads)
    n = grads_slab.shape[0]
    if draws.h.shape != (n,):
        raise ValueError(f"draws.h must be ({n},), got {tuple(draws.h.shape)}")
    g_slab, stats, ef_new = mac_slab(draws, cfg, spec, grads_slab, draws.h,
                                     pilot_stats=pilot_stats, ef=ef)
    return g_slab, draws.h, grads_slab, stats, ef_new


def mac_slab(draws: RoundDraws, cfg: OTAChannelConfig, spec: SlabSpec,
             grads_slab: torch.Tensor, h: torch.Tensor,
             pilot_stats: bool = False, ef: Optional[torch.Tensor] = None,
             n_total: Optional[int] = None):
    """The uplink of a stacked (R, padded) gradient slab with fading h
    (R,), normalised by ``n_total`` (default R). Returns ``(g_slab,
    stats, ef_new)``.

    The f32 uplink is one ``ota_channel_slab`` launch. A quantized
    uplink is a transmit launch and a receive launch; its stochastic
    rounding takes ``draws.r_up``, or on the card under ``sr_inkernel``
    the kernel's own draws keyed by ``draws.sr_seed``. The resident
    round passes its N client rows; the streamed round its completed
    partial as one row with h = 1 and ``n_total=1``.
    """
    u, e, scale = _interference_slab_inputs(draws, cfg, spec)
    stats = None
    up = cfg.uplink
    if not up.quantized:
        if ef is not None:
            raise ValueError("the f32 uplink has no quantization residual; "
                             "error feedback needs a quantized uplink")
        g_slab = ota_channel_slab(grads_slab, h, u, e, alpha=cfg.alpha,
                                  scale=scale, n_total=n_total,
                                  pilot_stats=pilot_stats)
        if pilot_stats:
            g_slab, stats = g_slab
        return g_slab, stats, None

    stochastic = up.stochastic_rounding and up.mode == "int8"
    # The kernel draws its own rounding uniforms only on the card; the
    # plain version always takes the host draw, as the JAX package's
    # interpret and jnp paths do.
    inkernel = (stochastic and up.sr_inkernel
                and grads_slab.device.type == "cuda")
    r = sr_seed = None
    if inkernel:
        sr_seed = draws.sr_seed
        if sr_seed is None:
            raise ValueError("this round needs draws.sr_seed "
                             "(UplinkConfig.sr_inkernel on the card)")
    elif stochastic:
        r = draws.wire("r_up", spec.padded)
    tx = ota_transmit_slab(grads_slab, h, n_total=n_total, quantize=True,
                           r=r, stochastic=stochastic, qmode=up.mode,
                           zero_fold=up.zero_fold, sr_seed=sr_seed, ef=ef,
                           return_residual=ef is not None)
    packed = up.packed_sign
    payload = (pack_sign_slab(tx[0][None], planes=packed == "planes")
               if packed else tx[0][None])
    g_slab = ota_receive_slab(payload, tx[1][None], u, e, alpha=cfg.alpha,
                              scale=scale, packed=packed,
                              pilot_stats=pilot_stats)
    if pilot_stats:
        g_slab, stats = g_slab
    ef_new = tx[2] if ef is not None else None
    if up.zero_fold:
        g_slab = restore_zero_tail(g_slab, spec)
        ef_new = restore_zero_tail(ef_new, spec)
    return g_slab, stats, ef_new
