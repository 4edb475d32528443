"""Transformer blocks and the layer-stack helpers.

PyTorch counterpart of ``repro.models.transformer`` for the dense family
(pre-norm GQA attention + SwiGLU or GeLU MLP). Per-layer parameters are
stacked on a leading layer axis, as in the JAX package, so
``convert.params_from_numpy`` carries a JAX model across leaf for leaf;
where the JAX package scans over that axis, the port runs a Python loop
over the layers (``stack_*``). The other families (mla, moe, rwkv,
hybrid, encdec, vlm) are ROADMAP A13c.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.slab import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import attention as attn
from repro_torch.models.layers import (gelu_mlp, gelu_mlp_init, layernorm,
                                       layernorm_init, rmsnorm, rmsnorm_init,
                                       swiglu, swiglu_init)

PyTree = Any


def _norm_init(kind: str, dim: int, device=None) -> dict:
    return (rmsnorm_init(dim, device=device) if kind == "rmsnorm"
            else layernorm_init(dim, device=device))


def _norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


def _mlp_init(kind: str, gen: torch.Generator, d_model: int, d_ff: int,
              dtype) -> dict:
    return (swiglu_init(gen, d_model, d_ff, dtype) if kind == "swiglu"
            else gelu_mlp_init(gen, d_model, d_ff, dtype))


def _mlp(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(p, x) if kind == "swiglu" else gelu_mlp(p, x)


def _layer(stacked: PyTree, i: int) -> PyTree:
    return tree_map(lambda a: a[i], stacked)


def _depth(stacked: PyTree) -> int:
    return tree_flatten(stacked)[0][0].shape[0]


def stack_init(block_init: Callable, gen: torch.Generator,
               n_layers: int) -> PyTree:
    """Init ``n_layers`` layers one after the other into stacked leaves
    (n_layers, ...): the stack is allocated after the first layer, so the
    peak is the stack plus one layer."""
    first = block_init(gen)
    leaves, treedef = tree_flatten(first)
    stacked = [torch.empty((n_layers, *l.shape), dtype=l.dtype,
                           device=l.device) for l in leaves]
    for s, l in zip(stacked, leaves):
        s[0] = l
    del first, leaves
    for i in range(1, n_layers):
        for s, l in zip(stacked, tree_flatten(block_init(gen))[0]):
            s[i] = l
    return tree_unflatten(treedef, stacked)


def stack_apply(block_fn: Callable, stacked: PyTree, x: torch.Tensor,
                aux0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``block_fn(layer_params, x) -> (x', aux)`` over the layer axis; aux
    accumulates additively."""
    aux = aux0
    for i in range(_depth(stacked)):
        x, a = block_fn(_layer(stacked, i), x)
        aux = aux + a if aux is not None else None
    return x, aux


def stack_decode(block_fn: Callable, stacked: PyTree, caches: PyTree,
                 x: torch.Tensor) -> Tuple[torch.Tensor, PyTree]:
    """``block_fn(layer_params, cache, x) -> (x', cache)`` over the layers.
    Each layer's cache is a view of the stacked caches, which the block
    updates in place; returns the stacked caches."""
    for i in range(_depth(stacked)):
        x, _ = block_fn(_layer(stacked, i), _layer(caches, i), x)
    return x, caches


def stack_prefill(block_fn: Callable, stacked: PyTree, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, PyTree]:
    """``block_fn(layer_params, x) -> (x', cache)`` over the layers,
    collecting the per-layer caches stacked on the layer axis."""
    caches = []
    for i in range(_depth(stacked)):
        x, cache = block_fn(_layer(stacked, i), x)
        caches.append(cache)
    leaves = [tree_flatten(c)[0] for c in caches]
    treedef = tree_flatten(caches[0])[1]
    return x, tree_unflatten(treedef, [torch.stack(ls) for ls in
                                       zip(*leaves)])


# --------------------------------------------------------------------------
# Block definitions. Each returns (init_fn(gen) -> params,
#                                  fwd(params, x) -> (x, aux),
#                                  decode(params, cache, x, pos) -> (x, cache),
#                                  init_cache(batch, length, device) -> cache,
#                                  pfl(params, x, length) -> (x, cache))
# --------------------------------------------------------------------------

def dense_block(cfg) -> tuple:
    acfg = cfg.attn_config()
    norm, mlpk = cfg.norm, cfg.mlp

    def init(gen):
        return {
            "ln1": _norm_init(norm, cfg.d_model, gen.device),
            "attn": attn.attn_init(gen, acfg, cfg.dtype),
            "ln2": _norm_init(norm, cfg.d_model, gen.device),
            "mlp": _mlp_init(mlpk, gen, cfg.d_model, cfg.d_ff, cfg.dtype),
        }

    def fwd(p, x):
        x = x + attn.self_attention(p["attn"], acfg, _norm(norm, p["ln1"], x))
        x = x + _mlp(mlpk, p["mlp"], _norm(norm, p["ln2"], x))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def decode(p, cache, x, pos):
        y, kv = attn.decode_self_attention(
            p["attn"], acfg, _norm(norm, p["ln1"], x), cache["kv"], pos)
        x = x + y
        x = x + _mlp(mlpk, p["mlp"], _norm(norm, p["ln2"], x))
        return x, {**cache, "kv": kv}

    def init_cache(batch, length, device=None):
        return {"kv": attn.init_kv_cache(batch, length, acfg, cfg.dtype,
                                         device=device)}

    def pfl(p, x, length):
        y, kv = attn.prefill_kv_cache(p["attn"], acfg,
                                      _norm(norm, p["ln1"], x), length)
        x = x + y
        x = x + _mlp(mlpk, p["mlp"], _norm(norm, p["ln2"], x))
        return x, {"kv": kv}

    return init, fwd, decode, init_cache, pfl
