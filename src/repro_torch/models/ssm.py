"""Selective state-space (Mamba-style) branch of Hymba's hybrid heads.

PyTorch counterpart of ``repro.models.ssm``. Recurrence (per channel c,
state n):

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

with input-dependent dt / B / C ("selective"). The JAX package runs the
sequence form through ``jax.lax.associative_scan``; torch has no such
scan, so the port runs a sequential one (``_scan``): one ``addcmul`` a
step, h_t = a_t h_{t-1} + b_t, the same function within the f32 tier in
another order of the products. It saves about two (B, S, C, N) f32
tensors a layer for the backward, where a doubling scan would save
2 log2(S); the price is S launches a layer. ``ssm_chunk > 0`` keeps the
JAX package's blocked form: a loop over blocks, the scan from zero
inside each, and the carried state added as ``h_local + cumprod(a) h0``.

Decode is one O(1) state update that writes the state and the conv
window into the cache it is given (in place). The prefill conv sums its
K shifted products left to right in the input dtype, the decode conv in
f32, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, dense_init, normal, uniform


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int              # expanded channels (Hymba: ~2x d_model)
    d_state: int = 16
    d_conv: int = 4           # depthwise causal conv width
    dt_rank: int = 0          # 0 -> ceil(d_model / 16)
    chunk: int = 0            # 0 = one scan over S; > 0 = a loop over
                              # S / chunk blocks, a scan inside each

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def ssm_init(gen: torch.Generator, cfg: SSMConfig,
             dtype=torch.bfloat16) -> dict:
    dev = gen.device
    # S4D-real initialisation for A.
    a = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(cfg.d_inner, 1)
    return {
        "in_proj": dense_init(gen, cfg.d_model, (2 * cfg.d_inner,), dtype),
        "conv": normal(gen, (cfg.d_conv, cfg.d_inner),
                       1.0 / math.sqrt(cfg.d_conv), dtype),
        "conv_bias": torch.zeros((cfg.d_inner,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, cfg.d_inner,
                             (cfg.rank + 2 * cfg.d_state,), dtype),
        "dt_proj": dense_init(gen, cfg.rank, (cfg.d_inner,), dtype,
                              use_bias=True),
        "dt_bias": uniform(gen, (cfg.d_inner,), math.log(1e-3),
                           math.log(1e-1), torch.float32),
        "a_log": torch.log(a),
        "d_skip": torch.ones((cfg.d_inner,), dtype=torch.float32,
                             device=dev),
        "out_proj": dense_init(gen, cfg.d_inner, (cfg.d_model,), dtype),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (K, C) depthwise causal conv: K shifted products
    summed left to right in x's dtype."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    segs = [xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(k)]
    return sum(segs) + b[None, None, :]


def _selective_terms(p: dict, cfg: SSMConfig, xc: torch.Tensor):
    """From the conv output xc (..., S, C): dt (..., S, C), B and C
    (..., S, N)."""
    proj = dense(p["x_proj"], xc).float()
    dt_lo = proj[..., :cfg.rank]
    b_t = proj[..., cfg.rank:cfg.rank + cfg.d_state]
    c_t = proj[..., cfg.rank + cfg.d_state:]
    dt = F.softplus(dense(p["dt_proj"], dt_lo.to(xc.dtype)).float()
                    + p["dt_bias"][None, None, :])
    return dt, b_t, c_t


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, every h_t
    (the second half of the associative scan's pair (prod a, h)). The
    steps read ``unbind``'s views: its backward stacks their gradients
    once, where an index a step would scatter each into a zero tensor
    of the whole sequence."""
    a_t, b_t = a.unbind(1), b.unbind(1)
    h = b_t[0]
    hs = [h]
    for t in range(1, len(a_t)):
        h = torch.addcmul(b_t[t], a_t[t], h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def ssm_forward(p: dict, cfg: SSMConfig, x: torch.Tensor,
                return_state: bool = False):
    """x: (B, S, d_model) -> (B, S, d_model). With ``return_state`` also
    returns the decode cache after the last token (h state + conv
    window)."""
    xz = dense(p["in_proj"], x)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_depthwise_conv(xi, p["conv"], p["conv_bias"]).float()
                ).to(x.dtype)
    dt, b_t, c_t = _selective_terms(p, cfg, xc)
    a = -torch.exp(p["a_log"])                                   # (C, N)
    if cfg.chunk and x.shape[1] > cfg.chunk:
        # discretised a block at a time, so the (B, chunk, C, N) f32
        # tensors never cover the whole sequence
        b_sz, s_len = x.shape[0], x.shape[1]
        n = -(-s_len // cfg.chunk)
        pad = (0, 0, 0, n * cfg.chunk - s_len)
        dt_p, bt_p, ct_p, xc_p = (F.pad(t, pad) for t in
                                  (dt, b_t, c_t, xc.float()))
        h0 = torch.zeros((b_sz, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=x.device)
        ys = []
        for j in range(n):
            blk = slice(j * cfg.chunk, (j + 1) * cfg.chunk)
            dtj, btj, ctj, xcj = (t[:, blk] for t in (dt_p, bt_p, ct_p,
                                                      xc_p))
            ab = torch.exp(dtj[..., None] * a[None, None])   # (B,c,C,N)
            bb = (dtj * xcj)[..., None] * btj[..., None, :]
            a_cum = torch.cumprod(ab, dim=1)
            h_full = _scan(ab, bb) + a_cum * h0[:, None]
            ys.append(torch.einsum("bscn,bsn->bsc", h_full, ctj))
            h0 = h_full[:, -1]
        h_last = h0
        y = torch.cat(ys, dim=1)[:, :s_len]
        y = y + p["d_skip"] * xc.float()
    else:
        abar = torch.exp(dt[..., None] * a[None, None])         # (B,S,C,N)
        bx = (dt * xc.float())[..., None] * b_t[..., None, :]
        h = _scan(abar, bx)
        h_last = h[:, -1]
        y = (torch.einsum("bscn,bsn->bsc", h, c_t)
             + p["d_skip"] * xc.float())
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = dense(p["out_proj"], y)
    if not return_state:
        return out
    kc = cfg.d_conv - 1
    if x.shape[1] >= kc:
        conv_win = xi[:, -kc:]
    else:
        conv_win = F.pad(xi, (0, 0, kc - x.shape[1], 0))
    # copies: a view would keep the whole sequence's h and xi alive
    return out, {"h": h_last.clone(), "conv": conv_win.clone()}


def init_ssm_cache(batch: int, cfg: SSMConfig, dtype=torch.float32,
                   device=None) -> dict:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(p: dict, cfg: SSMConfig, x: torch.Tensor, cache: dict
                    ) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d_model); the O(1) state update, written into ``cache``
    (the state and the conv window), which it returns."""
    xz = dense(p["in_proj"], x)
    xi, z = torch.chunk(xz, 2, dim=-1)                            # (B,1,C)
    window = torch.cat([cache["conv"], xi.to(cache["conv"].dtype)],
                       dim=1)                                     # (B,K,C)
    w = p["conv"].float()
    xc = torch.sum(window.float() * w[None], dim=1, keepdim=True)
    xc = F.silu(xc + p["conv_bias"].float()[None, None])
    xc = xc.to(x.dtype)
    dt, b_t, c_t = _selective_terms(p, cfg, xc)                   # (B,1,*)
    a = -torch.exp(p["a_log"])
    abar = torch.exp(dt[..., None] * a[None, None])[:, 0]         # (B,C,N)
    bx = ((dt * xc.float())[..., None] * b_t[..., None, :])[:, 0]
    h = cache["h"]
    h.copy_(h * abar + bx)
    cache["conv"].copy_(window[:, 1:])
    y = (torch.einsum("bcn,bn->bc", h, c_t[:, 0])
         + p["d_skip"] * xc[:, 0].float())
    y = y[:, None].to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return dense(p["out_proj"], y), cache
