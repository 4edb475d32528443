"""Shared neural-net primitives, as functions over parameter dicts.

PyTorch counterpart of ``repro.models.layers``, with its conventions:

* params are nested dicts of tensors; init functions take an explicit
  ``torch.Generator`` (on the device the parameters go to) where the JAX
  package takes a key. The values differ from the JAX package's (another
  generator); the parity tests carry the JAX parameters across with
  ``repro_torch.convert``;
* the compute dtype follows the kernel's storage dtype (bf16 by
  default); norms, softmax-like nonlinearities and rope run in f32;
* all matmuls go through ``dense`` so dtype promotion is uniform.

Random leaves are drawn in f32 pieces of at most ``DRAW_CHUNK`` entries
and written into the leaf, so at full width no f32 temporary is larger
than one leaf's worth of a piece.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

DRAW_CHUNK = 1 << 26          # entries of one f32 draw (256 MB)
_TRUNC = math.erf(2.0 / math.sqrt(2.0))   # CDF span of [-2, 2] on [-1, 1]


def _drawn(shape, dtype, gen: torch.Generator,
           draw: Callable[[torch.Tensor], None]) -> torch.Tensor:
    """A leaf of ``shape`` / ``dtype`` on the generator's device, filled
    piece by piece: ``draw(t)`` fills an f32 piece in place."""
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), DRAW_CHUNK):
        piece = torch.empty(min(DRAW_CHUNK, flat.numel() - i),
                            dtype=torch.float32, device=gen.device)
        draw(piece)
        flat[i:i + piece.numel()] = piece
    return out


def truncated_normal_init(gen: torch.Generator, shape, scale: float,
                          dtype) -> torch.Tensor:
    """He/depth-scaled normal truncated to [-2, 2] std (inverse CDF)."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    std = scale / math.sqrt(max(fan_in, 1))

    def draw(t):
        t.uniform_(-_TRUNC, _TRUNC, generator=gen)
        t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)

    return _drawn(shape, dtype, gen, draw)


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
    std = 1.0 / math.sqrt(dim)
    return {"table": _drawn((vocab, dim), dtype, gen,
                            lambda t: t.normal_(0.0, std, generator=gen))}


def embed(p: dict, ids: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    return p["table"][ids].to(compute_dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings.
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                       # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate pairs. x: (B, S, H, D), positions: (B, S) or (S,)."""
    d = x.shape[-1]
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
