"""Wireless-channel models for analog over-the-air (A-OTA) aggregation.

PyTorch counterpart of ``repro.core.channel``. The uplink MAC is

    g_t = (1/N) * sum_n h_{n,t} * grad_n  +  xi_t                  (Eq. 7)

with i.i.d. fading ``h`` (Rayleigh in the paper's experiments, mean
``mu_c``) and i.i.d. symmetric alpha-stable interference ``xi`` with
tail index ``alpha`` in (1, 2] and scale ``xi_scale``.

The configs mirror the JAX classes field for field, with the same
defaults and checks, less ``OTAChannelConfig.backend`` and
``interpret``: in the port the device decides. The random draws live in
``repro_torch.core.draws``; this module holds the transforms that turn
base uniforms and normals into fading and interference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class UplinkConfig:
    """Payload format of the MAC uplink (see ``repro.core.channel``).

    ``mode`` is "f32" (the analog payload), "int8" (per-128-block
    max|x|/127 scales, stochastic or round-to-nearest rounding) or
    "sign" (1-bit signSGD with per-block mean|x| scales; ``sign_pack``
    "fold", "planes" or the "int8" container). ``error_feedback`` carries
    each transmitter's quantization residual into the next round;
    ``sr_inkernel`` makes the transmit kernel draw its own rounding
    uniforms on the card.
    """

    mode: str = "f32"
    block: int = 128
    stochastic_rounding: bool = True
    error_feedback: bool = False
    sign_pack: str = "fold"
    sr_inkernel: bool = False

    def __post_init__(self):
        if self.mode not in ("f32", "int8", "sign"):
            raise ValueError(f'unknown uplink mode {self.mode!r}; '
                             'options: "f32", "int8", "sign"')
        if self.block != 128:
            raise ValueError(
                f"uplink block must be 128 (the per-block scale width of "
                f"the wire format), got {self.block}")
        if self.error_feedback and self.mode == "f32":
            raise ValueError(
                'error_feedback requires a quantized uplink mode '
                '("int8" or "sign"); the f32 payload has no residual')
        if self.sign_pack not in ("fold", "planes", "int8"):
            raise ValueError(f'unknown sign_pack {self.sign_pack!r}; '
                             'options: "fold", "planes", "int8"')
        if self.sr_inkernel and not (self.mode == "int8"
                                     and self.stochastic_rounding):
            raise ValueError(
                "sr_inkernel needs the int8 uplink with "
                "stochastic_rounding=True (the sign quantizer is "
                "deterministic and f32 has no quantizer)")

    @property
    def quantized(self) -> bool:
        return self.mode != "f32"

    @property
    def packed_sign(self) -> Optional[str]:
        if self.mode != "sign" or self.sign_pack == "int8":
            return None
        return self.sign_pack

    @property
    def zero_fold(self) -> bool:
        return self.mode == "sign" and self.sign_pack == "fold"


@dataclasses.dataclass(frozen=True)
class OTAChannelConfig:
    """Static configuration of the simulated analog OTA channel.

    Fields and checks as in ``repro.core.channel.OTAChannelConfig``,
    without ``backend`` and ``interpret``.
    """

    alpha: float = 1.5
    xi_scale: float = 0.1
    fading: str = "rayleigh"
    mu_c: float = 1.0
    sigma_c: float = 0.2
    interference: bool = True
    power_control: bool = False     # truncated channel inversion: clients
                                    # pre-scale by 1/h, deep fades
                                    # (h < pc_threshold) stay silent
    pc_threshold: float = 0.2
    uplink: UplinkConfig = UplinkConfig()
    downlink: str = "f32"
    comm_buckets: int = 1

    def __post_init__(self):
        if not (1.0 < self.alpha <= 2.0):
            raise ValueError(f"tail index alpha must be in (1, 2], got {self.alpha}")
        if self.fading not in ("rayleigh", "gaussian", "none"):
            raise ValueError(f"unknown fading model: {self.fading}")
        if isinstance(self.uplink, str):
            object.__setattr__(self, "uplink", UplinkConfig(mode=self.uplink))
        if self.downlink not in ("f32", "int8"):
            raise ValueError(f'unknown downlink mode {self.downlink!r}; '
                             'options: "f32", "int8"')
        if self.comm_buckets < 1:
            raise ValueError(f"comm_buckets must be >= 1, got "
                             f"{self.comm_buckets}")

    @property
    def pc_transmit_prob(self) -> float:
        """P(h >= pc_threshold) under the raw fading law."""
        t = self.pc_threshold
        if self.fading == "none":
            return 1.0 if 1.0 >= t else 0.0
        if self.fading == "rayleigh":
            s = self.mu_c / math.sqrt(math.pi / 2.0)
            return math.exp(-(t**2) / (2.0 * s**2))
        return 0.5 * math.erfc((t - self.mu_c) / (self.sigma_c * math.sqrt(2.0)))

    @property
    def fading_mean(self) -> float:
        """Mean of the effective fading (Bernoulli p under power control)."""
        if self.power_control:
            return self.pc_transmit_prob
        return 1.0 if self.fading == "none" else self.mu_c

    @property
    def fading_var(self) -> float:
        """Variance of the effective fading."""
        if self.power_control:
            p = self.pc_transmit_prob
            return p * (1.0 - p)
        if self.fading == "none":
            return 0.0
        if self.fading == "rayleigh":
            return self.mu_c**2 * (4.0 / math.pi - 1.0)
        return self.sigma_c**2


# ---------------------------------------------------------------------------
# Fading transforms: base draws -> effective fading h.
# ---------------------------------------------------------------------------

def rayleigh_from_uniform(u: torch.Tensor, mu_c: float) -> torch.Tensor:
    """Rayleigh fading with mean ``mu_c`` from uniforms in [tiny, 1):
    ``s * sqrt(-2 log u)`` with ``s = mu_c / sqrt(pi/2)``."""
    s = mu_c / math.sqrt(math.pi / 2.0)
    return s * torch.sqrt(-2.0 * torch.log(u))


def gaussian_from_normal(z: torch.Tensor, mu_c: float,
                         sigma_c: float) -> torch.Tensor:
    """Gaussian fading (may be negative; an ablation) from N(0, 1)."""
    return mu_c + sigma_c * z


def power_control(h: torch.Tensor, threshold: float) -> torch.Tensor:
    """Truncated channel inversion: 1 where ``h >= threshold``, else 0."""
    return torch.where(h >= threshold, torch.ones_like(h), torch.zeros_like(h))


# ---------------------------------------------------------------------------
# Chambers-Mallows-Stuck interference synthesis.
# ---------------------------------------------------------------------------

# Angles stay strictly inside (-pi/2, pi/2): at the endpoints f32 cos()
# is a tiny negative number and the fractional powers turn it into NaN.
CMS_U_BOUND = math.pi / 2 - 1e-6
CMS_E_FLOOR = 1e-7


def cms_transform(u: torch.Tensor, e: torch.Tensor, alpha) -> torch.Tensor:
    """Branch-free symmetric Chambers-Mallows-Stuck transform.

        X = sin(alpha u) / cos(u)^{1/alpha}
              * ( cos((1-alpha) u) / e )^{(1-alpha)/alpha}

    u is clipped into the open interval the sampler guarantees and e is
    floored, so the transform is finite for every input, including
    alpha == 2 where it reduces to 2*sin(u)*sqrt(e) ~ N(0, 2).
    """
    u = torch.clamp(u, -CMS_U_BOUND, CMS_U_BOUND)
    e = torch.clamp_min(e, CMS_E_FLOOR)
    a = alpha
    return (torch.sin(a * u) / torch.cos(u) ** (1.0 / a)
            * (torch.cos((1.0 - a) * u) / e) ** ((1.0 - a) / a))


def cms_transform_fast(u: torch.Tensor, e: torch.Tensor, alpha) -> torch.Tensor:
    """CMS transform with both generic powers fused into one exp:

        X = sin(alpha u) * exp( (1/alpha) * ( -log cos(u)
              + (1 - alpha) * log( cos((1-alpha) u) / e ) ) )

    Algebraically identical to :func:`cms_transform`, a few f32 ulps
    apart.
    """
    u = torch.clamp(u, -CMS_U_BOUND, CMS_U_BOUND)
    e = torch.clamp_min(e, CMS_E_FLOOR)
    a = alpha
    inner = -torch.log(torch.cos(u)) + (1.0 - a) * torch.log(
        torch.cos((1.0 - a) * u) / e)
    return torch.sin(a * u) * torch.exp(inner * (1.0 / a))
