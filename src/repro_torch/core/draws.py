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
synthesizes exactly zero interference. The quantized wire adds three
optional fields, each present only for a configuration that uses it:

* ``r_up`` (padded,) f32 in [0, 1) — stochastic-rounding uniforms of the
  int8 uplink (``repro.core.ota.uplink_sr_slab_inputs(key, spec)[0]``);
* ``r_dl`` (padded,) f32 in [0, 1) — stochastic-rounding uniforms of the
  int8 downlink (``repro.core.ota.downlink_sr_slab_inputs``);
* ``sr_seed`` int in [0, 2^64) — the key of the transmit kernel's own
  Philox draws under ``UplinkConfig.sr_inkernel`` (the twin of
  ``repro.core.channel.sr_kernel_seed``).

The streamed client axis adds one more, present only under partial
participation (``FLConfig.sample_rate < 1``):

* ``mask`` (N,) f32 in {0, 1} — this round's participation mask
  (``repro.core.stream.participation_mask(key, N, rate)``); None means
  every client takes part.

``TorchDraws`` is the port's own provider: a Philox ``torch.Generator``
on the device (the CPU generator when the caller runs on the CPU),
reseeded from a mix of ``(seed, round index)`` so round t's draws do not
depend on how many rounds ran before it. It draws h, u and e first, the
wire's fields after them and the participation mask last, so a config
without a quantized wire or without sampling gets the same h, u and e
(and wire fields) as it always did. The parity tests feed the round the
JAX package's own draws through the same seam.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.channel import (CMS_E_FLOOR, CMS_U_BOUND,
                                      OTAChannelConfig, gaussian_from_normal,
                                      power_control, rayleigh_from_uniform)
from repro_torch.core.slab import SlabSpec
from repro_torch.device import DeviceLike, resolve_device

_TINY = torch.finfo(torch.float32).tiny


_SR_SALT = 0x5A8    # the JAX package's SR_FOLD separator, reused as a salt


@dataclasses.dataclass(frozen=True)
class RoundDraws:
    h: torch.Tensor
    u: torch.Tensor
    e: torch.Tensor
    r_up: Optional[torch.Tensor] = None
    r_dl: Optional[torch.Tensor] = None
    sr_seed: Optional[int] = None
    mask: Optional[torch.Tensor] = None

    def wire(self, name: str, length: int) -> torch.Tensor:
        """The (length,) wire field ``r_up`` or ``r_dl``; raises when the
        draws were made for a config that does not use it."""
        x = getattr(self, name)
        if x is None or tuple(x.shape) != (length,):
            raise ValueError(
                f"this round needs draws.{name} of shape ({length},), got "
                f"{None if x is None else tuple(x.shape)}; make the draws "
                "for this channel config (TorchDraws does)")
        return x

    def to(self, device) -> "RoundDraws":
        def move(t):
            return None if t is None else t.to(device)
        return RoundDraws(self.h.to(device), self.u.to(device),
                          self.e.to(device), move(self.r_up),
                          move(self.r_dl), self.sr_seed, move(self.mask))


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


def participation_mask(n_clients: int, sample_rate: float,
                       generator: torch.Generator) -> torch.Tensor:
    """(n,) f32 {0, 1} mask, each client in with probability
    ``sample_rate``, as ``repro.core.stream.participation_mask`` draws
    it. ``sample_rate >= 1`` gives all-ones and consumes nothing of the
    generator, so enabling sampling leaves every other draw as it was."""
    dev = generator.device
    if sample_rate >= 1.0:
        return torch.ones((n_clients,), dtype=torch.float32, device=dev)
    u = torch.rand((n_clients,), generator=generator, device=dev)
    return (u < sample_rate).to(torch.float32)


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
    ``r_up`` comes for the int8 uplink with stochastic rounding, except
    on the card under ``sr_inkernel`` (the kernel draws its own, from
    ``sr_seed``); ``r_dl`` for the int8 downlink; ``sr_seed`` under
    ``sr_inkernel``, mixed on the host from ``(seed, t)`` so that making
    it reads nothing back from the card; ``mask`` for ``sample_rate < 1``
    (pass ``FLConfig.sample_rate``), drawn after everything else.
    """

    def __init__(self, cfg: OTAChannelConfig, spec: SlabSpec, n_clients: int,
                 seed: int = 0, device: DeviceLike = None,
                 sample_rate: float = 1.0):
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in (0, 1], got "
                             f"{sample_rate}")
        self.cfg = cfg
        self.spec = spec
        self.n_clients = n_clients
        self.sample_rate = float(sample_rate)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)

    def __call__(self, t: int) -> RoundDraws:
        if not 0 <= t < 2**32 or not 0 <= self.seed < 2**31:
            raise ValueError("round index must be in [0, 2^32) and seed in "
                             "[0, 2^31)")
        mixed = _mix64((self.seed << 32) | int(t))
        self.generator.manual_seed(mixed)
        h = sample_fading(self.cfg, self.n_clients, self.generator)
        padded = self.spec.padded
        if self.cfg.interference:
            u, e = cms_slab_inputs(self.spec, self.generator)
        else:
            u = torch.zeros((padded,), device=self.device)
            e = torch.ones((padded,), device=self.device)
        up = self.cfg.uplink
        sr = up.mode == "int8" and up.stochastic_rounding
        r_up = r_dl = sr_seed = None
        if sr and not (up.sr_inkernel and self.device.type == "cuda"):
            r_up = torch.rand((padded,), generator=self.generator,
                              device=self.device)
        if self.cfg.downlink == "int8":
            r_dl = torch.rand((padded,), generator=self.generator,
                              device=self.device)
        if sr and up.sr_inkernel:
            sr_seed = _mix64(mixed ^ _SR_SALT)
        mask = (participation_mask(self.n_clients, self.sample_rate,
                                   self.generator)
                if self.sample_rate < 1.0 else None)
        return RoundDraws(h, u, e, r_up, r_dl, sr_seed, mask)
