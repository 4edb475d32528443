"""RWKV-6 "Finch": attention-free token mixing with data-dependent decay.

PyTorch counterpart of ``repro.models.rwkv``. Per head (key dim D =
value dim D):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t            (state, D x D)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with a per-channel, per-token decay w_t = exp(-exp(wlog_t)) produced
from the input, and token-shift ddlerp input mixing.

The sequence runs in the chunked form: within a chunk of length L the
contributions are an L x L product with decay ratios; across chunks only
the (B, H, D, D) f32 state is carried, by a Python loop over the chunks
where the JAX package has ``lax.scan`` (the same cumprods, clamps, mask
and sums). What does not read the state (the decayed r and k, the masked
scores, the diagonal term, each chunk's k^T v to its end) is computed
for all chunks at once before the loop, so the loop is two products and
an update a chunk. Decode carries S directly, O(1) a token, and writes
the state and the two token-shift registers into the cache it is given
(in place).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense, dense_init, layernorm,
                                       layernorm_init, normal)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    n_heads: int               # head_dim = d_model // n_heads
    d_ff: int
    lora_rank: int = 64        # decay/mix LoRA rank
    chunk: int = 64            # chunked-scan block length

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def time_mix_init(gen: torch.Generator, cfg: RWKVConfig,
                  dtype=torch.bfloat16) -> dict:
    d, r = cfg.d_model, cfg.lora_rank
    h, hd = cfg.n_heads, cfg.head_dim
    dev = gen.device
    return {
        # ddlerp token-shift mixing: 5 targets (r, k, v, w, g).
        "mix_base": torch.zeros((5, d), dtype=torch.float32, device=dev),
        "mix_w1": dense_init(gen, d, (5 * r,), dtype),
        "mix_w2": normal(gen, (5, r, d), 0.01, dtype),
        "wr": dense_init(gen, d, (d,), dtype),
        "wk": dense_init(gen, d, (d,), dtype),
        "wv": dense_init(gen, d, (d,), dtype),
        "wg": dense_init(gen, d, (d,), dtype),
        "wo": dense_init(gen, d, (d,), dtype),
        # data-dependent decay: w = exp(-exp(w0 + lora(x_w)))
        "w0": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
        "w_lora_a": dense_init(gen, d, (r,), dtype),
        "w_lora_b": normal(gen, (r, d), 0.01, dtype),
        "u": normal(gen, (h, hd), 0.1, torch.float32),
        "ln_x": layernorm_init(d, device=dev),
    }


def channel_mix_init(gen: torch.Generator, cfg: RWKVConfig,
                     dtype=torch.bfloat16) -> dict:
    dev = gen.device
    return {
        "mix_k": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "mix_r": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "wk": dense_init(gen, cfg.d_model, (cfg.d_ff,), dtype),
        "wr": dense_init(gen, cfg.d_model, (cfg.d_model,), dtype),
        "wv": dense_init(gen, cfg.d_ff, (cfg.d_model,), dtype),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1}, with ``prev`` at t == 0. x: (B, S, d)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(p: dict, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Data-dependent lerp producing the 5 mixed inputs (5, B, S, d), f32
    (``mix_base`` is f32 and promotes, as in the JAX package)."""
    base = x[None] + xx[None] * p["mix_base"][:, None, None]
    lo = torch.tanh(dense(p["mix_w1"], x + xx * 0.5))
    lo = torch.movedim(lo.reshape(*lo.shape[:-1], 5, -1), -2, 0)  # (5,B,S,r)
    delta = torch.einsum("fbsr,frd->fbsd", lo.float(), p["mix_w2"].float())
    return base + xx[None] * delta.to(x.dtype)


def _rkvwg(p: dict, cfg: RWKVConfig, x: torch.Tensor, x_prev: torch.Tensor):
    xx = _token_shift(x, x_prev) - x
    m = _ddlerp(p, x, xx)
    r = dense(p["wr"], m[0])
    k = dense(p["wk"], m[1])
    v = dense(p["wv"], m[2])
    lora = torch.tanh(dense(p["w_lora_a"], m[3]))
    wlog = (p["w0"][None, None]
            + torch.einsum("bsr,rd->bsd", lora.float(),
                           p["w_lora_b"].float()))
    w = torch.exp(-torch.exp(torch.clamp(wlog, -10.0, 2.0)))  # in (0, 1)
    g = F.silu(dense(p["wg"], m[4]).float()).to(x.dtype)
    hshape = x.shape[:-1] + (cfg.n_heads, cfg.head_dim)
    return (r.reshape(hshape), k.reshape(hshape), v.reshape(hshape),
            w.reshape(hshape), g)


def _wkv_chunked(r, k, v, w, u, chunk: int):
    """Chunked WKV recurrence. r, k, v, w: (B, S, H, D) (w in f32, decay
    in (0, 1)); u: (H, D). Returns y (B, S, H, D) f32 and the final state
    (B, H, D, D) f32."""
    b, s, h, d = r.shape
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        padw = (0, 0, 0, 0, 0, pad)
        r, k, v = (F.pad(t, padw) for t in (r, k, v))
        w = F.pad(w, padw, value=1.0)
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))

    def chunked(t):                               # (n, B, H, L, D)
        return t.reshape(b, n, chunk, h, d).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(chunked, (rf, kf, vf, wf))
    a_ex = torch.cumprod(wc, dim=-2) / wc         # exclusive cumprod A_t
    a_in = torch.cumprod(wc, dim=-2)              # inclusive cumprod
    tot = a_in[..., -1:, :]                       # whole-chunk decay
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    # what does not read the carried state, for every chunk at once
    r_dec = rc * a_ex                                     # (n,B,H,L,D)
    k_inc = kc / torch.clamp_min(a_in, 1e-30)
    scores = torch.einsum("nbhld,nbhmd->nbhlm", r_dec, k_inc)
    scores = torch.where(mask, scores, 0.0)
    diag = torch.einsum("nbhld,nbhld->nbhl", rc * u[:, None, :], kc)
    intra = (torch.einsum("nbhlm,nbhmd->nbhld", scores, vc)
             + diag[..., None] * vc)
    carry_k = kc * (tot / torch.clamp_min(a_in, 1e-30))   # to chunk end
    kv = torch.einsum("nbhld,nbhle->nbhde", carry_k, vc)
    decay = tot[..., 0, :, None]                          # (n,B,H,D,1)
    # the loop over chunks carries S: S_new[d, e] = tot[d] * S[d, e] +
    # sum_l carry_k[l, d] v[l, e]
    state = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    ys = []
    for j in range(n):
        ys.append(intra[j] + torch.einsum("bhld,bhde->bhle", r_dec[j],
                                          state))
        state = state * decay[j] + kv[j]
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, n * chunk, h, d)
    return y[:, :s], state


def time_mix_forward(p: dict, cfg: RWKVConfig, x: torch.Tensor,
                     x_prev=None, return_state: bool = False):
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, 0])
    r, k, v, w, g = _rkvwg(p, cfg, x, x_prev)
    y, s_fin = _wkv_chunked(r, k, v, w, p["u"], cfg.chunk)
    y = y.reshape(x.shape).to(x.dtype)
    y = layernorm(p["ln_x"], y)
    out = dense(p["wo"], y * g)
    if return_state:
        return out, s_fin, x[:, -1]
    return out


def _channel_mix(p: dict, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    xk = x + xx * p["mix_k"].to(x.dtype)
    xr = x + xx * p["mix_r"].to(x.dtype)
    kk = torch.square(F.relu(dense(p["wk"], xk).float()))
    rr = torch.sigmoid(dense(p["wr"], xr).float())
    return (rr * dense(p["wv"], kk.to(x.dtype)).float()).to(x.dtype)


def channel_mix_forward(p: dict, cfg: RWKVConfig, x: torch.Tensor,
                        x_prev=None) -> torch.Tensor:
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, 0])
    return _channel_mix(p, x, _token_shift(x, x_prev) - x)


# --------------------------------------------------------------------------
# O(1) decode.
# --------------------------------------------------------------------------

def init_rwkv_cache(batch: int, cfg: RWKVConfig, dtype=torch.bfloat16,
                    device=None) -> dict:
    return {
        "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim,
                              cfg.head_dim), dtype=torch.float32,
                             device=device),
        "x_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device),       # time-mix shift
        "x_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device),       # channel-mix shift
    }


def time_mix_decode(p: dict, cfg: RWKVConfig, x: torch.Tensor, cache: dict
                    ) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d). The S_t update and output in O(D^2) a head; writes
    the state and the shift register into ``cache`` and returns it."""
    r, k, v, w, g = _rkvwg(p, cfg, x, cache["x_tm"])
    rf, kf, vf = (t.float()[:, 0] for t in (r, k, v))         # (B,H,D)
    wf = w.float()[:, 0]
    s = cache["state"]
    kv = torch.einsum("bhd,bhe->bhde", kf, vf)
    y = torch.einsum("bhd,bhde->bhe", rf, s + p["u"][None, ..., None] * kv)
    s.copy_(s * wf[..., None] + kv)                # after y has read S
    cache["x_tm"].copy_(x[:, 0])
    y = y.reshape(x.shape[0], 1, -1).to(x.dtype)
    y = layernorm(p["ln_x"], y)
    return dense(p["wo"], y * g), cache


def channel_mix_decode(p: dict, cfg: RWKVConfig, x: torch.Tensor, cache: dict
                       ) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d), the layernormed channel-mix input; writes it into the
    cache's shift register and returns the cache."""
    xx = cache["x_cm"][:, None] - x
    cache["x_cm"].copy_(x[:, 0])
    return _channel_mix(p, x, xx), cache
