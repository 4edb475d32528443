"""Shared neural-net primitives, as functions over parameter dicts.

PyTorch counterpart of ``repro.models.layers``, with its conventions:

* params are nested dicts of tensors; init functions take an explicit
  ``torch.Generator`` (on the device the parameters go to) where the JAX
  package takes a key. The values differ from the JAX package's (another
  generator); the parity tests carry the JAX parameters across with
  ``repro_torch.convert``;
* the compute dtype follows the kernel's storage dtype (bf16 by
  default); norms, softmax-like nonlinearities and rope run in f32;
* all matmuls go through ``dense`` so dtype promotion is uniform;
* ``softmax_xent`` is the training loss of the language models, in f32.

Random leaves are drawn in f32 pieces of at most ``DRAW_CHUNK`` entries
and written into the leaf, so at full width no f32 temporary is larger
than one leaf's worth of a piece. Inside ``draw_into`` the leaf is a
tensor the caller hands out (``transformer.stack_init`` hands out the
leaf's slice of the layer stack) instead of a new one; ``allocator``
gives the allocator in force, which a nested stack allocates through.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F

DRAW_CHUNK = 1 << 26          # entries of one f32 draw (256 MB)
_TRUNC = math.erf(2.0 / math.sqrt(2.0))   # CDF span of [-2, 2] on [-1, 1]
Alloc = Callable[[tuple, torch.dtype, torch.device], torch.Tensor]
_SINKS: List[Alloc] = []      # the allocators of the open draw_into blocks


@contextlib.contextmanager
def draw_into(alloc: Alloc) -> Iterator[None]:
    """Inside the block every random leaf is drawn into the contiguous
    tensor ``alloc(shape, dtype, device)`` returns, in the order the
    leaves are drawn, instead of into a new tensor. The draws and their
    values do not change."""
    _SINKS.append(alloc)
    try:
        yield
    finally:
        _SINKS.pop()


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def allocator() -> Alloc:
    """The allocator a random leaf drawn now goes into: the innermost
    open ``draw_into`` block's, else a new tensor."""
    return _SINKS[-1] if _SINKS else _empty


def _drawn(shape, dtype, gen: torch.Generator,
           draw: Callable[[torch.Tensor], None]) -> torch.Tensor:
    """A leaf of ``shape`` / ``dtype`` on the generator's device, filled
    piece by piece: ``draw(t)`` fills an f32 piece in place."""
    out = allocator()(tuple(shape), dtype, gen.device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), DRAW_CHUNK):
        piece = torch.empty(min(DRAW_CHUNK, flat.numel() - i),
                            dtype=torch.float32, device=gen.device)
        draw(piece)
        flat[i:i + piece.numel()] = piece
    return out


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """``jax.random.normal(key, shape, f32) * std`` cast to ``dtype``, in
    law."""
    return _drawn(shape, dtype, gen,
                  lambda t: t.normal_(0.0, std, generator=gen))


def uniform(gen: torch.Generator, shape, low: float, high: float,
            dtype) -> torch.Tensor:
    """``jax.random.uniform(key, shape, f32, low, high)`` cast to
    ``dtype``, in law."""
    return _drawn(shape, dtype, gen,
                  lambda t: t.uniform_(low, high, generator=gen))


def truncated_normal(gen: torch.Generator, shape, std: float,
                     dtype) -> torch.Tensor:
    """A normal of standard deviation ``std`` truncated to [-2, 2] std
    (inverse CDF): ``jax.random.truncated_normal(key, -2, 2, shape) * std``
    in law."""
    def draw(t):
        t.uniform_(-_TRUNC, _TRUNC, generator=gen)
        t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)

    return _drawn(shape, dtype, gen, draw)


def truncated_normal_init(gen: torch.Generator, shape, scale: float,
                          dtype) -> torch.Tensor:
    """He/depth-scaled normal truncated to [-2, 2] std (inverse CDF)."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    return truncated_normal(gen, shape, scale / math.sqrt(max(fan_in, 1)),
                            dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_shape: Sequence[int],
               dtype=torch.bfloat16, use_bias: bool = False,
               scale: float = 1.0) -> dict:
    shape = (in_dim, *out_shape)
    p = {"kernel": truncated_normal_init(gen, shape, scale, dtype)}
    if use_bias:
        p["bias"] = torch.zeros(tuple(out_shape), dtype=dtype,
                                device=gen.device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (..., in_dim) @ kernel (in_dim, *out) -> (..., *out), in the
    kernel's storage dtype."""
    k = p["kernel"]
    y = x.to(k.dtype).reshape(-1, k.shape[0]) @ k.reshape(k.shape[0], -1)
    y = y.reshape(*x.shape[:-1], *k.shape[1:])
    if "bias" in p:
        y = y + p["bias"].to(k.dtype)
    return y


def rmsnorm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.bfloat16) -> dict:
    return {"table": normal(gen, (vocab, dim), 1.0 / math.sqrt(dim), dtype)}


def embed(p: dict, ids: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    return p["table"][ids].to(compute_dtype)


def sinusoidal_embed(positions: torch.Tensor, dim: int,
                     max_timescale: float = 10000.0) -> torch.Tensor:
    """Transformer sin/cos position embeddings in f32, (..., dim), with
    the JAX package's frequencies exp(-ln(max_timescale) i / half).
    positions: (...,) integers."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_timescale)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# --------------------------------------------------------------------------
# Rotary position embeddings.
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                       # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate pairs. x: (B, S, H, D), positions: (B, S) or (S,);
    ``freqs`` (D/2,) in place of the plain frequencies of ``theta``."""
    d = x.shape[-1]
    if freqs is None:
        freqs = rope_frequencies(d, theta, device=x.device)   # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs          # (B,S,D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLPs.
# --------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.bfloat16) -> dict:
    return {
        "gate": dense_init(gen, d_model, (d_ff,), dtype),
        "up": dense_init(gen, d_model, (d_ff,), dtype),
        "down": dense_init(gen, d_ff, (d_model,), dtype),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(dense(p["gate"], x).float()).to(x.dtype)
    return dense(p["down"], g * dense(p["up"], x))


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.bfloat16, use_bias: bool = True) -> dict:
    return {
        "up": dense_init(gen, d_model, (d_ff,), dtype, use_bias=use_bias),
        "down": dense_init(gen, d_ff, (d_model,), dtype, use_bias=use_bias),
    }


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation; so is this."""
    h = F.gelu(dense(p["up"], x).float(), approximate="tanh").to(x.dtype)
    return dense(p["down"], h)


# --------------------------------------------------------------------------
# Losses.
# --------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 weights: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted-mean token cross-entropy, as ``repro.models.layers``
    computes it.

    logits: (..., V) float; labels: (...) integer ids; weights:
    per-*example* weights broadcastable to labels' shape from the left
    (the OTA faded-loss formulation); mask: 0/1 validity per token.

    Normalised by the *unweighted* token count (clamped at 1), so that
    with fading weights h the result is exactly mean_i h_i * nll_i, not
    a self-normalised ratio.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    m = torch.ones_like(nll) if mask is None else mask.float()
    wn = nll * m
    if weights is not None:
        w = weights.reshape(weights.shape + (1,) * (nll.dim() - weights.dim()))
        wn = wn * torch.broadcast_to(w, nll.shape).float()
    return torch.sum(wn) / torch.clamp_min(torch.sum(m), 1.0)
