"""Multi-head Latent Attention (MLA), the MiniCPM3 / DeepSeek-V2 family.

PyTorch counterpart of ``repro.models.mla``. Queries come through a
low-rank latent, or with ``q_lora_rank=None`` (DeepSeek-V2-Lite, which
the JAX package does not have) through one direct projection ``wq``;
keys / values come through a low-rank latent; the decode cache holds ONLY the
compressed latent ``c_kv`` (kv_lora_rank) and the shared rotary key
``k_pe`` (qk_rope_head_dim) per token. Decode uses the *absorbed* form:
the up-projections ``W_uk`` / ``W_uv`` fold into the query and output
sides, so scores and weighted sums are computed in latent space.

All of it is plain torch in f32, as the JAX package computes it in XLA:
the prefill attention decompresses K / V and runs masked causal MHA with
a query-key head dim of 96 and a value head dim of 64, which the
flash-attention kernel (B5, one head dim for q, k and v) does not take.
So the mla family launches no B5. ``mla_decode_step`` writes the token
into the cache it is given (in place), as the dense decode does.

With ``yarn`` set (DeepSeek-V2's ``rope_scaling`` of type yarn), the
rotary frequencies are YaRN's (``yarn_inv_freq``: DeepSeek-V2's
``DeepseekV2YarnRotaryEmbedding``) and the softmax scale takes the
factor ``yarn_mscale(factor, mscale_all_dim) ** 2`` on every path. The
rotary pairs stay the port's (``layers.apply_rope``: column i with
column i + D/2); the published code pairs interleaved columns, which is
a fixed permutation of the rope columns of ``wq`` and ``wkv_a``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.attention import NEG_INF
from repro_torch.models.layers import (apply_rope, dense, dense_init, rmsnorm,
                                       rmsnorm_init)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: Optional[int] = 768      # None: the direct projection wq
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64
    rope_theta: float = 10000.0
    # YaRN: (factor, original length, beta_fast, beta_slow, mscale,
    # mscale_all_dim), or None for plain rotary frequencies
    yarn: Optional[Tuple[float, int, float, float, float, float]] = None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def yarn_mscale(factor: float, mscale: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(cfg: MLAConfig) -> Tuple[int, int]:
    """The rotary pairs where YaRN's ramp starts and ends: DeepSeek-V2's
    ``yarn_find_correction_range`` from beta_fast and beta_slow."""
    factor, original, fast, slow = cfg.yarn[:4]
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta

    def at(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    return max(math.floor(at(fast)), 0), min(math.ceil(at(slow)), dim - 1)


_YARN: Dict[tuple, torch.Tensor] = {}


def yarn_inv_freq(cfg: MLAConfig, device) -> torch.Tensor:
    """YaRN's inverse frequencies, (qk_rope_head_dim / 2,) f32, as
    DeepSeek-V2 computes them: each pair's plain frequency where the
    ramp is 0, divided by the factor where it is 1, mixed linearly
    between. Computed once a config and device (a constant of every
    call)."""
    key = (cfg, str(device))
    if key not in _YARN:
        dim, factor = cfg.qk_rope_head_dim, cfg.yarn[0]
        exponent = torch.arange(0, dim, 2, dtype=torch.float32) / dim
        extra = 1.0 / (cfg.rope_theta ** exponent)
        inter = 1.0 / (factor * cfg.rope_theta ** exponent)
        low, high = yarn_range(cfg)
        ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32)
                            - low) / max(high - low, 1e-3), 0.0, 1.0)
        mask = 1.0 - ramp
        _YARN[key] = (inter * (1.0 - mask) + extra * mask).to(device)
    return _YARN[key]


def softmax_scale(cfg: MLAConfig) -> float:
    """1 / sqrt(qk_head_dim), times YaRN's mscale(factor,
    mscale_all_dim) squared where it is set (DeepSeek-V2's
    ``softmax_scale``)."""
    scale = 1.0 / math.sqrt(cfg.qk_head_dim)
    if cfg.yarn is not None and cfg.yarn[5]:
        m = yarn_mscale(cfg.yarn[0], cfg.yarn[5])
        scale = scale * m * m
    return scale


def _rope(cfg: MLAConfig, x, positions):
    """The rotary embedding of ``x`` (B, S, H, rope): plain, or YaRN's
    frequencies with DeepSeek-V2's cos / sin factor mscale(factor,
    mscale) / mscale(factor, mscale_all_dim) (1 where the two are
    equal, as in DeepSeek-V2-Lite)."""
    if cfg.yarn is None:
        return apply_rope(x, positions, cfg.rope_theta)
    out = apply_rope(x, positions, freqs=yarn_inv_freq(cfg, x.device))
    factor, mscale, mscale_all = cfg.yarn[0], cfg.yarn[4], cfg.yarn[5]
    amp = yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all)
    return out if amp == 1.0 else (out.float() * amp).to(out.dtype)


def mla_init(gen: torch.Generator, cfg: MLAConfig,
             dtype=torch.bfloat16) -> dict:
    dev = gen.device
    if cfg.q_lora_rank is None:
        q = {"wq": dense_init(gen, cfg.d_model,
                              (cfg.n_heads, cfg.qk_head_dim), dtype)}
    else:
        q = {"wq_a": dense_init(gen, cfg.d_model, (cfg.q_lora_rank,), dtype),
             "q_norm": rmsnorm_init(cfg.q_lora_rank, device=dev),
             "wq_b": dense_init(gen, cfg.q_lora_rank,
                                (cfg.n_heads, cfg.qk_head_dim), dtype)}
    return {
        **q,
        "wkv_a": dense_init(gen, cfg.d_model,
                            (cfg.kv_lora_rank + cfg.qk_rope_head_dim,), dtype),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, device=dev),
        "wkv_b": dense_init(gen, cfg.kv_lora_rank,
                            (cfg.n_heads,
                             cfg.qk_nope_head_dim + cfg.v_head_dim), dtype),
        "wo": dense_init(gen, cfg.n_heads * cfg.v_head_dim, (cfg.d_model,),
                         dtype),
    }


def _queries(p, cfg: MLAConfig, x, positions):
    if cfg.q_lora_rank is None:
        q = dense(p["wq"], x)
    else:
        q = dense(p["wq_b"], rmsnorm(p["q_norm"], dense(p["wq_a"], x)))
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_pe = _rope(cfg, q[..., cfg.qk_nope_head_dim:], positions)
    return q_nope, q_pe                       # (B,S,H,nope), (B,S,H,rope)


def _latents(p, cfg: MLAConfig, x, positions):
    kv = dense(p["wkv_a"], x)
    c_kv = rmsnorm(p["kv_norm"], kv[..., :cfg.kv_lora_rank])
    k_pe = _rope(cfg, kv[..., None, cfg.kv_lora_rank:],
                 positions)[:, :, 0]        # (B,S,rope), shared by heads
    return c_kv, k_pe


def mla_self_attention(p: dict, cfg: MLAConfig, x: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Training / prefill path: decompress K / V and run causal MHA."""
    b, s, _ = x.shape
    q_nope, q_pe = _queries(p, cfg, x, positions)
    c_kv, k_pe = _latents(p, cfg, x, positions)
    kv = dense(p["wkv_b"], c_kv)                       # (B,S,H,nope+v)
    k_nope = kv[..., :cfg.qk_nope_head_dim]
    v = kv[..., cfg.qk_nope_head_dim:]
    scale = softmax_scale(cfg)
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
              + torch.einsum("bqhr,bkr->bhqk", q_pe.float(), k_pe.float())
              ) * scale
    pos = positions if positions.dim() == 2 else positions[None, :]
    causal = pos[:, None, :, None] >= pos[:, None, None, :]
    scores = torch.where(causal, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return dense(p["wo"], o.reshape(b, s, -1).to(x.dtype))


def init_mla_cache(batch: int, length: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {
        "c_kv": torch.zeros((batch, length, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_pe": torch.zeros((batch, length, cfg.qk_rope_head_dim),
                            dtype=dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


def mla_prefill(p: dict, cfg: MLAConfig, x: torch.Tensor,
                positions: torch.Tensor, length: int
                ) -> Tuple[torch.Tensor, dict]:
    """Prefill attention over the prompt and its latent cache of
    ``length`` positions. A prompt longer than ``length`` raises
    ``ValueError`` (the JAX package's ``dynamic_update_slice`` refuses
    an update larger than the cache too)."""
    s = x.shape[1]
    if s > length:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{length} positions")
    y = mla_self_attention(p, cfg, x, positions)
    c_kv, k_pe = _latents(p, cfg, x, positions)
    cache = init_mla_cache(x.shape[0], length, cfg, dtype=c_kv.dtype,
                           device=x.device)
    cache["c_kv"][:, :s] = c_kv
    cache["k_pe"][:, :s] = k_pe
    cache["pos"][:s] = torch.arange(s, dtype=torch.int32, device=x.device)
    return y, cache


def mla_decode_step(p: dict, cfg: MLAConfig, x: torch.Tensor, cache: dict,
                    pos: int) -> Tuple[torch.Tensor, dict]:
    """Absorbed one-token decode against the latent cache; ``pos`` is the
    absolute position (a Python int). Writes the token into ``cache`` in
    place (at ``pos``, clamped to the last slot as JAX's
    ``dynamic_update_slice`` clamps it) and returns it.

    score_h(s) = q_nope_h^T W_uk_h c_s + q_pe_h^T k_pe_s
    out_h      = (sum_s p_s c_s)^T W_uv_h
    """
    b = x.shape[0]
    slot = min(pos, cache["c_kv"].shape[1] - 1)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_pe = _queries(p, cfg, x, posv)            # (B,1,H,*)
    c_new, k_pe_new = _latents(p, cfg, x, posv)
    ck, kp, cpos = cache["c_kv"], cache["k_pe"], cache["pos"]
    ck[:, slot] = c_new[:, 0].to(ck.dtype)
    kp[:, slot] = k_pe_new[:, 0].to(kp.dtype)
    cpos[slot] = pos
    w_uk = p["wkv_b"]["kernel"][..., :cfg.qk_nope_head_dim]   # (r,H,nope)
    w_uv = p["wkv_b"]["kernel"][..., cfg.qk_nope_head_dim:]   # (r,H,v)
    # Absorb W_uk into the query: (B,1,H,nope) x (r,H,nope) -> (B,1,H,r)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk.float())
    scale = softmax_scale(cfg)
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, ck.float())
              + torch.einsum("bqhr,bsr->bhqs", q_pe.float(), kp.float())
              ) * scale
    valid = (cpos >= 0) & (cpos <= pos)
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", probs, ck.float())
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv.float())
    y = dense(p["wo"], o.reshape(b, 1, -1).to(x.dtype))
    return y, cache
