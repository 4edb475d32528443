"""Attention: MHA/GQA, causal + sliding-window masking, the KV cache
(full-length, and a ring buffer for a sliding window), and the JAX
package's two memory levers on the plain path.

PyTorch counterpart of ``repro.models.attention``: self-attention and
cross-attention.

``attend`` computes masked GQA attention and picks its path by the
call's arguments:

* without positions (``q_pos = k_pos = None``, meaning 0..S-1 for
  queries and keys alike) and without a key mask it is attention over
  whole sequences for inference: prefill, ``forward`` and the
  cross-attention of decode, whose callers build exactly those
  positions. It goes to the flash-attention kernel
  (``kernels.flash_attention``, B5), which builds the same causal /
  window mask from the indices. As many keys as queries, or, with
  neither a causal nor a window mask (the encoder's bidirectional
  attention, cross-attention over an image or the encoder's output,
  decode's one query row against it), any number of keys: there the
  result does not depend on positions. B5 is itself a blocked online
  softmax, so this path ignores ``kv_chunk`` and ``window_block``: the
  JAX package computes the same function there through whichever of
  its plain, chunked and block-local branches the config picks. B5 has
  no backward (the TPU kernel has none either), and its wrapper refuses
  tensors that require grad or lie under a ``torch.func`` transform;
* with positions it is plain torch and honours any positions, as the
  JAX package leaves it to XLA. Two callers: the training forward
  (``models.model``'s ``loss_fn``), which passes 0..S-1 explicitly so
  that ``torch.func.grad`` and ``vmap`` differentiate the masked plain
  path, as the JAX training forward computes attention in XLA and never
  in its Pallas kernel; and one-token decode against the cache, with
  ``k_valid``. Here the levers act as in the JAX package
  (``attention.py:100-112``), by its exact conditions:
  ``window_block`` (a window, causal, ``Sq == Sk > 2 * window``, no
  ``k_valid``) goes to ``_attend_window_blocked``, window-sized query
  blocks over their {previous, own} key blocks; ``kv_chunk`` with
  ``Sk > kv_chunk`` goes to ``_attend_chunked``, an online softmax over
  key chunks. Both are Python loops where the JAX package scans.

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
    kv_chunk: Optional[int] = None        # online-softmax KV chunk (lever)
    window_block: bool = False            # window-sized Q blocks (lever)


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
           k_valid: Optional[torch.Tensor] = None,
           kv_chunk: Optional[int] = None,
           window_block: bool = False) -> torch.Tensor:
    """Masked GQA attention. Shapes: q (B,Sq,H,D); k,v (B,Sk,K,D);
    q_pos (B,Sq) or (Sq,); k_pos (B,Sk) or (Sk,); k_valid optional (B,Sk).
    ``q_pos = k_pos = None`` means positions 0..S-1 for both: the
    flash-attention kernel's call, for inference only (it has no
    backward), with Sq == Sk, or any Sk when neither ``causal`` nor
    ``window`` masks (no mask depends on positions then); the levers
    are not read there. Positions given take the masked plain path,
    which autograd and ``torch.func`` differentiate, through the
    ``window_block`` or ``kv_chunk`` branch where the JAX package takes
    it (module docstring).
    """
    if q_pos is None or k_pos is None:
        unmasked = not causal and window is None
        if (q_pos is not k_pos or k_valid is not None
                or (q.shape[1] != k.shape[1] and not unmasked)):
            raise ValueError(
                "attend without positions is attention over 0..S-1: both "
                "positions None, no k_valid, and as many keys as queries "
                "unless the call is neither causal nor windowed")
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if (window_block and window is not None and causal
            and q.shape[1] == k.shape[1] and q.shape[1] > 2 * window
            and k_valid is None):
        return _attend_window_blocked(q, k, v, window, scale)
    if q_pos.dim() == 1:
        q_pos = q_pos[None, :]
    if k_pos.dim() == 1:
        k_pos = k_pos[None, :]
    if kv_chunk is not None and k.shape[1] > kv_chunk:
        # the chunked layout takes a position row per batch entry
        k_pos_b = k_pos.expand(k.shape[0], k.shape[1])
        return _attend_chunked(q, k, v, q_pos, k_pos_b, causal, window,
                               k_valid, kv_chunk, scale)
    bias = _mask_bias(q_pos, k_pos, causal, window, k_valid)  # (B,Sq,Sk)
    scores = _gqa_scores(q, k, scale) + bias[:, None, None]
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v, q.dtype)


def _pad_keys(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` (B, S, ...) with ``pad`` zero rows after its S."""
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _attend_chunked(q, k, v, q_pos, k_pos, causal, window, k_valid,
                    chunk: int, scale: float) -> torch.Tensor:
    """Online softmax over KV chunks (``repro.models.attention.
    _attend_chunked``): the keys padded to whole chunks (positions -1,
    invalid), then the running max, sum and f32 accumulator carried
    from chunk to chunk. The forward's working set is O(Sq * chunk)
    scores; under a backward every chunk's probabilities are kept."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    if pad:
        k, v = _pad_keys(k, pad), _pad_keys(v, pad)
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
        valid_pad = (torch.arange(n_chunks * chunk, device=k.device)
                     < sk)[None, :]
        k_valid = (valid_pad if k_valid is None else
                   torch.nn.functional.pad(k_valid, (0, pad)) & valid_pad)
        k_valid = k_valid.expand(b, n_chunks * chunk)
    kheads = k.shape[2]
    g = h // kheads
    f32 = torch.float32
    m = torch.full((b, kheads, g, sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, kheads, g, sq), dtype=f32, device=q.device)
    acc = torch.zeros((b, kheads, g, sq, d), dtype=f32, device=q.device)
    for j in range(n_chunks):
        cols = slice(j * chunk, (j + 1) * chunk)
        bias = _mask_bias(q_pos, k_pos[:, cols], causal, window,
                          None if k_valid is None else k_valid[:, cols])
        s = _gqa_scores(q, k[:, cols], scale) + bias[:, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = torch.einsum("bkgqs,bskd->bkgqd", p, v[:, cols].float())
        acc = acc * corr[..., None] + o
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]          # (B,K,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _attend_window_blocked(q, k, v, window: int,
                           scale: float) -> torch.Tensor:
    """Causal sliding-window self-attention in window-sized query blocks
    (``repro.models.attention._attend_window_blocked``): block i attends
    to key blocks {i-1, i} (a zero block before block 0) under the
    position mask of the 2W-wide stripe, so every in-window key is
    covered and each step holds O(W * 2W) scores. Positions 0..S-1."""
    b, s, h, d = q.shape
    kheads = k.shape[2]
    w = window
    n = -(-s // w)
    pad = n * w - s
    if pad:
        q, k, v = _pad_keys(q, pad), _pad_keys(k, pad), _pad_keys(v, pad)
    qc = q.reshape(b, n, w, h, d)
    kc = k.reshape(b, n, w, kheads, d)
    vc = v.reshape(b, n, w, kheads, d)
    zero = torch.zeros_like(kc[:, :1])
    k2 = torch.cat([torch.cat([zero, kc[:, :-1]], 1), kc], dim=2)
    v2 = torch.cat([torch.cat([zero, vc[:, :-1]], 1), vc], dim=2)
    outs = []
    for i in range(n):
        q_pos = i * w + torch.arange(w, device=q.device)
        k_pos = (i - 1) * w + torch.arange(2 * w, device=q.device)
        dpos = q_pos[:, None] - k_pos[None, :]
        ok = ((dpos >= 0) & (dpos < w) & (k_pos >= 0)[None, :]
              & (q_pos < s)[:, None] & (k_pos < s)[None, :])
        zero_bias = torch.zeros((), dtype=torch.float32, device=q.device)
        bias = torch.where(ok, zero_bias, NEG_INF)
        sc = _gqa_scores(qc[:, i], k2[:, i], scale) + bias
        outs.append(_gqa_out(torch.softmax(sc, dim=-1), v2[:, i], q.dtype))
    return torch.stack(outs, dim=1).reshape(b, n * w, h, d)[:, :s]


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
    """Self-attention over the whole sequence. ``positions=None`` means
    0..S-1 and runs the flash kernel (prefill, ``forward``); the training
    forward passes its positions and runs the plain path, which has a
    backward."""
    pos = _sequence_positions(x, positions)
    q, k, v = _project_qkv(p, cfg, x, x, pos, pos)
    o = attend(q, k, v, positions, positions, cfg.causal, cfg.window,
               kv_chunk=cfg.kv_chunk, window_block=cfg.window_block)
    return dense(p["wo"], o.reshape(*o.shape[:-2], -1))


def cross_attention(p: dict, cfg: AttentionConfig, x: torch.Tensor,
                    kv_source: torch.Tensor,
                    positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Cross-attention of ``x`` (B, Sq, d) over ``kv_source`` (B, Sk, d),
    projected here: no mask and no rope on either side; ``qk_norm`` is
    honoured. ``positions=None`` runs the flash kernel (prefill,
    ``forward``, decode at Sq = 1); the training forward passes the
    query positions and runs the plain path, with the keys at 0..Sk-1
    (the JAX package's call; unmasked, the result does not depend on
    them)."""
    q, k, v = _project_qkv(p, cfg, x, kv_source, None, None)
    k_pos = (None if positions is None else
             torch.arange(kv_source.shape[1], dtype=torch.int32,
                          device=x.device))
    o = attend(q, k, v, positions, k_pos, causal=False, window=None,
               kv_chunk=cfg.kv_chunk)
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
               cfg.causal, cfg.window, k_valid=k_valid,
               kv_chunk=cfg.kv_chunk)
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
