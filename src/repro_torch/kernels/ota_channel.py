"""Fused f32 OTA channel: faded client sum plus CMS interference.

PyTorch counterpart of ``repro.kernels.ota_channel.ota_channel_slab``:

    out = (1/n_total) sum_n h[n] * G[n, :]  +  scale * CMS(u, e, alpha)

in one pass over the stacked (N, d) gradient slab, with the optional
pilot-statistics epilogue ``[count, sum log|r|, sum log^2|r|]`` over the
nonzero residuals r = scale * xi (the closed alpha loop's input).

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/ota_channel.cu`` or raises. On a CPU tensor it runs the plain
version, ``kernels.ref.ota_channel_ref``. Nothing else selects between
the two.

The staged transmit/receive kernels of the quantized uplink
(``ota_transmit_slab``, ``ota_receive_slab``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.channel import CMS_E_FLOOR, CMS_U_BOUND
from repro_torch.kernels import build
from repro_torch.kernels.ref import ota_channel_ref

THREADS = 128     # threads per block; each owns `vec` adjacent columns


def ota_channel_slab(grads: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                     e: torch.Tensor, *, alpha: float, scale: float,
                     n_total: Optional[int] = None,
                     pilot_stats: bool = False):
    """Fused f32 channel: grads (N, d) stacked client gradients, h (N,)
    fading, u (d,) angles, e (d,) Exp(1) draws. Returns the (d,) f32
    noisy aggregate, and with ``pilot_stats=True`` also the (3,)
    residual statistics as ``(out, stats)``. ``n_total`` overrides the
    1/N normalisation (defaults to N)."""
    if not (1.0 < alpha <= 2.0):
        raise ValueError(f"tail index alpha must be in (1, 2], got {alpha}")
    if grads.device.type == "cpu":
        return ota_channel_ref(grads, h, u, e, alpha=alpha, scale=scale,
                               n_total=n_total, pilot_stats=pilot_stats)
    if grads.device.type != "cuda":
        raise ValueError(f"ota_channel_slab takes cuda or cpu tensors, got "
                         f"{grads.device}")
    if grads.dim() != 2:
        raise ValueError(f"grads must be (N, d), got {tuple(grads.shape)}")
    n, d = grads.shape
    for name, t, shape in (("grads", grads, (n, d)), ("h", h, (n,)),
                           ("u", u, (d,)), ("e", e, (d,))):
        if t.device != grads.device or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {shape} tensor on "
                             f"{grads.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}")
    if n_total is None:
        n_total = n

    out = torch.empty((d,), dtype=torch.float32, device=grads.device)
    vec = 4 if (d % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in (grads, out))) else 1
    blocks = -(-d // (THREADS * vec))
    rows = (torch.empty((blocks, 3), dtype=torch.float32, device=grads.device)
            if pilot_stats else None)
    a = float(alpha)
    lib = build.load_library()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream(grads.device).cuda_stream
        code = lib.repro_ota_channel(
            vec, int(pilot_stats), grads.data_ptr(), h.data_ptr(),
            u.data_ptr(), e.data_ptr(), out.data_ptr(),
            rows.data_ptr() if pilot_stats else None, n, d, float(n_total),
            float(scale), a, 1.0 / a, 1.0 - a, (1.0 - a) / a, CMS_U_BOUND,
            CMS_E_FLOOR, THREADS, blocks, stream)
    build.check(code, "ota_channel_slab")
    ota_channel_slab.launches += 1
    if pilot_stats:
        return out, torch.sum(rows, dim=0)
    return out


ota_channel_slab.launches = 0
