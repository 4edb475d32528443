"""The draws seam: a round's random inputs as explicit tensors.

The JAX round derives its randomness from a threefry key inside the
round body (``repro.core.ota.ota_aggregate_slab``: ``kh, kx =
split(key)``; ``sample_fading(kh, ...)``; ``_cms_slab_inputs(kx,
spec)``). PyTorch has no threefry generator, so the port's round takes
those draws as data instead: ``RoundDraws(h, u, e)``.

* ``h`` (N,) f32 — the effective fading of each client.
* ``u`` (padded,) f32 — CMS angles, uniform in (-CMS_U_BOUND, CMS_U_BOUND).
* ``e`` (padded,) f32 — CMS Exp(1) draws floored at ``CMS_E_FLOOR``.

The slab's padding tail holds the CMS fixed point u = 0, e = 1, which
synthesizes exactly zero interference.

``TorchDraws`` is the port's own provider: a Philox ``torch.Generator``
on the device (the CPU generator when the caller runs on the CPU),
reseeded from a mix of ``(seed, round index)`` so round t's draws do not
depend on how many rounds ran before it. The parity tests feed the round the
JAX package's own draws through the same seam.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.channel import (CMS_E_FLOOR, CMS_U_BOUND,
                                      OTAChannelConfig, gaussian_from_normal,
                                      power_control, rayleigh_from_uniform)
from repro_torch.core.slab import SlabSpec
from repro_torch.device import DeviceLike, resolve_device

_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class RoundDraws:
    h: torch.Tensor
    u: torch.Tensor
    e: torch.Tensor

    def to(self, device) -> "RoundDraws":
        return RoundDraws(self.h.to(device), self.u.to(device),
                          self.e.to(device))


def sample_fading(cfg: OTAChannelConfig, n: int,
                  generator: torch.Generator) -> torch.Tensor:
    """(n,) effective fading drawn like ``repro.core.channel.sample_fading``."""
    dev = generator.device
    if cfg.fading == "none":
        return torch.ones((n,), dtype=torch.float32, device=dev)
    if cfg.fading == "rayleigh":
        u = torch.rand((n,), generator=generator, device=dev).clamp_min_(_TINY)
        h = rayleigh_from_uniform(u, cfg.mu_c)
    else:
        z = torch.randn((n,), generator=generator, device=dev)
        h = gaussian_from_normal(z, cfg.mu_c, cfg.sigma_c)
    if cfg.power_control:
        h = power_control(h, cfg.pc_threshold)
    return h


def cms_slab_inputs(spec: SlabSpec, generator: torch.Generator):
    """(u, e) over the whole slab; padding gets the fixed point (0, 1)."""
    dev = generator.device
    pad = spec.padded - spec.total
    u = torch.rand((spec.total,), generator=generator, device=dev)
    u = u * (2.0 * CMS_U_BOUND) - CMS_U_BOUND
    r = torch.rand((spec.total,), generator=generator, device=dev)
    e = (-torch.log(r.clamp_min_(_TINY))).clamp_min_(CMS_E_FLOOR)
    u = torch.nn.functional.pad(u, (0, pad))
    e = torch.nn.functional.pad(e, (0, pad), value=1.0)
    return u, e


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection on 64-bit ints whose low 32
    bits depend on every input bit (the CPU generator keeps only the low
    32 bits of a seed; Philox on the card keeps all 64)."""
    m = (1 << 64) - 1
    z = (x + 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return z ^ (z >> 31)


class TorchDraws:
    """Round draws from a Philox generator keyed by ``(seed, round)``.

    ``draws(t)`` returns the ``RoundDraws`` of absolute round ``t``.
    With the interference off, (u, e) is the fixed point everywhere.
    """

    def __init__(self, cfg: OTAChannelConfig, spec: SlabSpec, n_clients: int,
                 seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.spec = spec
        self.n_clients = n_clients
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)

    def __call__(self, t: int) -> RoundDraws:
        if not 0 <= t < 2**32 or not 0 <= self.seed < 2**31:
            raise ValueError("round index must be in [0, 2^32) and seed in "
                             "[0, 2^31)")
        self.generator.manual_seed(_mix64((self.seed << 32) | int(t)))
        h = sample_fading(self.cfg, self.n_clients, self.generator)
        if self.cfg.interference:
            u, e = cms_slab_inputs(self.spec, self.generator)
        else:
            u = torch.zeros((self.spec.padded,), device=self.device)
            e = torch.ones((self.spec.padded,), device=self.device)
        return RoundDraws(h, u, e)
