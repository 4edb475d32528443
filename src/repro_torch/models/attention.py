"""Attention: MHA/GQA, causal + sliding-window masking and the KV cache
(full-length, and a ring buffer for a sliding window).

PyTorch counterpart of ``repro.models.attention`` for self-attention.

``attend`` computes masked GQA attention. A call without positions
(``q_pos = k_pos = None``, meaning 0..S-1 for queries and keys alike)
and without a key mask is self-attention over the whole sequence: the
training forward and prefill, whose callers build exactly those
positions. It goes to the flash-attention kernel
(``kernels.flash_attention``, B5), which builds the same causal / window
mask from the indices. That is the function the JAX package computes
there through its plain, ``kv_chunk`` and ``window_block`` branches (the
last two are its perf levers; all three give the same result), so the
port keeps neither lever. A call with positions, one-token decode
against the cache with ``k_valid`` above all, is plain torch and honours
any positions, as the JAX package leaves it to XLA. The choice is by the
call's arguments; there is no switch.

The decode cache is updated in place: ``decode_self_attention`` writes
the token's k / v / position into the cache tensors it is given and
returns them (the JAX package returns new arrays).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_rope, dense, dense_init, rmsnorm,
                                       rmsnorm_init)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window size; None = full
    causal: bool = True


def attn_init(gen: torch.Generator, cfg: AttentionConfig,
              dtype=torch.bfloat16) -> dict:
    p = {
        "wq": dense_init(gen, cfg.d_model, (cfg.n_heads, cfg.head_dim), dtype,
                         use_bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, (cfg.n_kv_heads, cfg.head_dim),
                         dtype, use_bias=cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, (cfg.n_kv_heads, cfg.head_dim),
                         dtype, use_bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * cfg.head_dim, (cfg.d_model,),
                         dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim, device=gen.device)
        p["k_norm"] = rmsnorm_init(cfg.head_dim, device=gen.device)
    return p


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int],
               k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive mask bias (..., S_q, S_k) from query/key absolute positions."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    if k_valid is not None:
        ok &= k_valid[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, NEG_INF)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor,
                scale: float) -> torch.Tensor:
    """q: (B,Sq,H,D), k: (B,Sk,K,D) -> scores (B,K,G,Sq,Sk) with H = K*G."""
    b, sq, h, d = q.shape
    kheads = k.shape[2]
    qg = q.reshape(b, sq, kheads, h // kheads, d)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale


def _gqa_out(probs: torch.Tensor, v: torch.Tensor,
             out_dtype) -> torch.Tensor:
    """probs: (B,K,G,Sq,Sk), v: (B,Sk,K,D) -> (B,Sq,H,D)."""
    b, kheads, g, sq, _ = probs.shape
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return o.reshape(b, sq, kheads * g, v.shape[-1]).to(out_dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: Optional[torch.Tensor], k_pos: Optional[torch.Tensor],
           causal: bool, window: Optional[int],
           k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked GQA attention. Shapes: q (B,Sq,H,D); k,v (B,Sk,K,D);
    q_pos (B,Sq) or (Sq,); k_pos (B,Sk) or (Sk,); k_valid optional (B,Sk).
    ``q_pos = k_pos = None`` means positions 0..S-1 for both (Sq == Sk):
    the flash-attention kernel's call (module docstring).
    """
    if q_pos is None or k_pos is None:
        if (q_pos is not k_pos or k_valid is not None
                or q.shape[1] != k.shape[1]):
            raise ValueError(
                "attend without positions is self-attention over 0..S-1: "
                "both positions None, no k_valid, as many keys as queries")
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q_pos.dim() == 1:
        q_pos = q_pos[None, :]
    if k_pos.dim() == 1:
        k_pos = k_pos[None, :]
    bias = _mask_bias(q_pos, k_pos, causal, window, k_valid)  # (B,Sq,Sk)
    scores = _gqa_scores(q, k, scale) + bias[:, None, None]
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v, q.dtype)


def _project_qkv(p: dict, cfg: AttentionConfig, xq: torch.Tensor,
                 xkv: torch.Tensor, q_pos: Optional[torch.Tensor],
                 k_pos: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = dense(p["wq"], xq)
    k = dense(p["wk"], xkv)
    v = dense(p["wv"], xkv)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if cfg.rope and q_pos is not None:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    return q, k, v


def _sequence_positions(x: torch.Tensor,
                        positions: Optional[torch.Tensor]) -> torch.Tensor:
    if positions is not None:
        return positions
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def self_attention(p: dict, cfg: AttentionConfig, x: torch.Tensor,
                   positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training/prefill self-attention over the whole sequence.
    ``positions=None`` means 0..S-1, which runs the flash kernel."""
    pos = _sequence_positions(x, positions)
    q, k, v = _project_qkv(p, cfg, x, x, pos, pos)
    o = attend(q, k, v, positions, positions, cfg.causal, cfg.window)
    return dense(p["wo"], o.reshape(*o.shape[:-2], -1))


# --------------------------------------------------------------------------
# KV cache (full-length and ring-buffer for sliding window).
# --------------------------------------------------------------------------

def init_kv_cache(batch: int, length: int, cfg: AttentionConfig,
                  dtype=torch.bfloat16, device=None) -> dict:
    """length = S_max for full attention; = window for ring (windowed) cache."""
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


def decode_self_attention(p: dict, cfg: AttentionConfig, x: torch.Tensor,
                          cache: dict, pos: int) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, d_model); pos: the absolute position
    (a Python int). Full attention uses slot = pos; sliding window uses
    a ring buffer with slot = pos % window, so cache memory is O(window),
    not O(S). Writes into ``cache`` in place and returns it.
    """
    length = cache["k"].shape[1]
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, x, pos_t, pos_t)
    slot = pos % length if cfg.window is not None else min(pos, length - 1)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = pos
    k_valid = (cache["pos"] >= 0)[None, :]
    o = attend(q, cache["k"], cache["v"], pos_t, cache["pos"][None, :],
               cfg.causal, cfg.window, k_valid=k_valid)
    y = dense(p["wo"], o.reshape(*o.shape[:-2], -1))
    return y, cache


def prefill_kv_cache(p: dict, cfg: AttentionConfig, x: torch.Tensor,
                     length: int) -> Tuple[torch.Tensor, dict]:
    """Run prefill self-attention over positions 0..S-1 AND build the
    decode cache in one pass. Without a window the cache must hold the
    whole prompt: a prompt longer than ``length`` raises ``ValueError``
    (the JAX package refuses it too)."""
    s = x.shape[1]
    if cfg.window is None and s > length:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{length} positions (no sliding window)")
    pos = _sequence_positions(x, None)
    q, k, v = _project_qkv(p, cfg, x, x, pos, pos)
    o = attend(q, k, v, None, None, cfg.causal, cfg.window)
    y = dense(p["wo"], o.reshape(*o.shape[:-2], -1))
    if cfg.window is not None and s > length:
        # Keep only the last `window` tokens, ring-aligned.
        ps = torch.arange(s - length, s, dtype=torch.int32, device=x.device)
        order = torch.argsort(ps % length)
        return y, {"k": k[:, -length:][:, order], "v": v[:, -length:][:, order],
                   "pos": ps[order]}
    cache = init_kv_cache(x.shape[0], length, cfg, dtype=k.dtype,
                          device=x.device)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    cache["pos"][:s] = torch.arange(s, dtype=torch.int32, device=x.device)
    return y, cache
