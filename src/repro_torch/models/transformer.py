"""Transformer blocks and the layer-stack helpers.

PyTorch counterpart of ``repro.models.transformer`` for its seven
families:

  dense  -- pre-norm GQA attention + (SwiGLU | GeLU) MLP
  mla    -- pre-norm MLA attention + SwiGLU MLP (MiniCPM3; ``models.mla``)
  moe    -- pre-norm GQA attention + top-k MoE FFN (+ shared expert;
            ``models.moe``)
  rwkv   -- RWKV-6 time mix + channel mix (``models.rwkv``)
  hybrid -- Hymba: GQA attention and an SSM branch in parallel on the
            same input, averaged, + MLP (``models.ssm``)
  encdec -- Whisper: bidirectional encoder; decoder with self- and
            cross-attention over the encoder's output
  vlm    -- Llama-3.2-Vision: groups of 1 gated cross-attention layer
            over the image tokens + (cross_attn_period - 1) dense layers

Per-layer parameters are stacked on a leading layer axis, as in the JAX
package (a vlm group's dense layers on a second one, ``selfs``), so
``convert.params_from_numpy`` carries a JAX model across leaf for leaf;
where the JAX package scans over that axis, the port runs a Python loop
over the layers (``stack_*``), and where it checkpoints the scanned
block, ``stack_apply(remat=True)`` recomputes each layer in the
backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.core.slab import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (allocator, draw_into, gelu_mlp,
                                       gelu_mlp_init, layernorm,
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


def _positions(x: torch.Tensor) -> torch.Tensor:
    """The positions 0..S-1 of a (B, S, d) sequence."""
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def _layer(stacked: PyTree, i: int) -> PyTree:
    return tree_map(lambda a: a[i], stacked)


def _depth(stacked: PyTree) -> int:
    return tree_flatten(stacked)[0][0].shape[0]


def stack_init(block_init: Callable, gen: torch.Generator,
               n_layers: int) -> PyTree:
    """Init ``n_layers`` layers one after the other into stacked leaves
    (n_layers, ...), the values of ``n_layers`` calls of ``block_init`` in
    a row. Each random leaf is drawn straight into its slice of the stack
    (``layers.draw_into``); layer 0's draws allocate the stacks. So the
    peak is the stack plus one draw piece and one layer's non-random
    leaves (norm scales, biases, copied in after the layer), and a
    1-layer stack holds its layer once. A stack nested in a layer (a vlm
    group's ``selfs``) allocates its random leaves' stacks through the
    enclosing stack's allocator, so they too are drawn in place, into
    the enclosing stack's slice."""
    alloc = allocator()
    stacks: List[torch.Tensor] = []     # the random leaves', in draw order
    handed: List[torch.Tensor] = []     # layer 0's slices of them
    at = {"layer": 0, "draw": 0}

    def into(shape, dtype, device):
        k = at["draw"]
        at["draw"] += 1
        if at["layer"] == 0:
            stacks.append(alloc((n_layers, *shape), dtype, device))
            handed.append(stacks[k][0])
            return handed[k]
        return stacks[k][at["layer"]]

    with draw_into(into):
        first = block_init(gen)
    leaves, treedef = tree_flatten(first)
    # layer 0's random leaves are the slices its draws were handed, alive
    # in ``first``, so their ids name them
    drawn = {id(s): k for k, s in enumerate(handed)}
    stacked, own = [], []
    for j, l in enumerate(leaves):
        if id(l) in drawn:
            stacked.append(stacks[drawn[id(l)]])
        else:
            stacked.append(torch.empty((n_layers, *l.shape), dtype=l.dtype,
                                       device=l.device))
            stacked[j][0] = l
            own.append(j)
    del first, leaves, handed
    for i in range(1, n_layers):
        at["layer"], at["draw"] = i, 0
        with draw_into(into):
            layer = tree_flatten(block_init(gen))[0]
        for j in own:
            stacked[j][i] = layer[j]
    return tree_unflatten(treedef, stacked)


def _run_layer(block_fn, treedef, n_leaves, args):
    """``block_fn`` on the layer rebuilt from its flattened leaves (the
    first ``n_leaves`` of ``args``) and the rest of ``args``."""
    layer = tree_unflatten(treedef, list(args[:n_leaves]))
    return block_fn(layer, *args[n_leaves:])


class _Remat(torch.autograd.Function):
    """One layer of ``stack_apply(remat=True)``, the twin of
    ``jax.checkpoint`` around the block: the forward keeps only the
    layer's inputs (its parameter leaves, ``x`` and the extras), and the
    backward computes the block again under ``torch.func.vjp`` to get
    their gradients. ``torch.utils.checkpoint`` does not compose with
    ``torch.func`` (saved-tensor hooks under ``grad``, no
    ``setup_context`` when reentrant); this Function does, and
    ``generate_vmap_rule`` batches it under ``vmap``. Every tensor the
    block reads must come in as an input: a tensor it closes over would
    get no gradient. One of these must not run another inside it
    (functorch's interpreter levels assert), so a stack inside a
    rematerialized block runs plain."""

    generate_vmap_rule = True

    @staticmethod
    def forward(block_fn, treedef, n_leaves, *args):
        # Record nothing, whatever grad mode a torch.func transform runs
        # the forward under (functorch turns it on at the level below a
        # grad transform): the backward computes the layer again.
        with torch.no_grad():
            return _run_layer(block_fn, treedef, n_leaves, args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        block_fn, treedef, n_leaves, *args = inputs
        ctx.call = (block_fn, treedef, n_leaves)
        ctx.save_for_backward(*args)

    @staticmethod
    def backward(ctx, *grads_out):
        args = list(ctx.saved_tensors)
        # differentiate the floating inputs; positions and other integer
        # tensors go in as they are
        wrt = [i for i, a in enumerate(args)
               if a is not None and a.is_floating_point()]

        def block(*primals):
            full = list(args)
            for i, t in zip(wrt, primals):
                full[i] = t
            return _run_layer(*ctx.call, full)

        with torch.enable_grad():
            _, vjp_fn = torch.func.vjp(block, *(args[i] for i in wrt))
            # With grad on the vjp records its own backward (for a higher
            # derivative, which remat does not offer), and the gradients'
            # graph would hold every recomputed layer alive to the end of
            # the backward: detached, the layer's go with it. (Its
            # backward under no_grad would take other formulas and part
            # from the plain stack's bits.)
            grads = [g.detach() for g in vjp_fn(grads_out)]
        out = [None] * len(args)
        for i, g in zip(wrt, grads):
            out[i] = g
        return (None, None, None, *out)


def stack_apply(block_fn: Callable, stacked: PyTree, x: torch.Tensor,
                aux0: Optional[torch.Tensor] = None, extras: tuple = (),
                remat: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``block_fn(layer_params, x, *extras) -> (x', aux)`` over the layer
    axis; aux accumulates additively. ``extras`` are the tensors every
    layer reads beside ``x`` (positions, the image tokens, the encoder's
    output). ``remat`` recomputes each layer in the backward instead of
    keeping its activations (``_Remat``; ``jax.checkpoint`` in the JAX
    package): the same values, less memory, a second forward."""
    aux = aux0
    for i in range(_depth(stacked)):
        layer = _layer(stacked, i)
        if remat:
            leaves, treedef = tree_flatten(layer)
            x, a = _Remat.apply(block_fn, treedef, len(leaves), *leaves, x,
                                *extras)
        else:
            x, a = block_fn(layer, x, *extras)
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
#                                  fwd(params, x, positions=None) -> (x, aux),
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

    def fwd(p, x, positions=None):
        # positions=None: the flash kernel (inference); the training
        # forward passes 0..S-1 and takes the plain path (a backward)
        x = x + attn.self_attention(p["attn"], acfg, _norm(norm, p["ln1"], x),
                                    positions)
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


def mla_block(cfg) -> tuple:
    mcfg = cfg.mla_config()
    norm, mlpk = cfg.norm, cfg.mlp

    def init(gen):
        return {
            "ln1": _norm_init(norm, cfg.d_model, gen.device),
            "attn": mla_mod.mla_init(gen, mcfg, cfg.dtype),
            "ln2": _norm_init(norm, cfg.d_model, gen.device),
            "mlp": _mlp_init(mlpk, gen, cfg.d_model, cfg.d_ff, cfg.dtype),
        }

    def fwd(p, x, positions=None):
        # MLA is plain torch on every path (no flash kernel)
        pos = _positions(x) if positions is None else positions
        x = x + mla_mod.mla_self_attention(p["attn"], mcfg,
                                           _norm(norm, p["ln1"], x), pos)
        x = x + _mlp(mlpk, p["mlp"], _norm(norm, p["ln2"], x))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def decode(p, cache, x, pos):
        y, kv = mla_mod.mla_decode_step(p["attn"], mcfg,
                                        _norm(norm, p["ln1"], x),
                                        cache["kv"], pos)
        x = x + y
        x = x + _mlp(mlpk, p["mlp"], _norm(norm, p["ln2"], x))
        return x, {**cache, "kv": kv}

    def init_cache(batch, length, device=None):
        return {"kv": mla_mod.init_mla_cache(batch, length, mcfg, cfg.dtype,
                                             device=device)}

    def pfl(p, x, length):
        y, kv = mla_mod.mla_prefill(p["attn"], mcfg,
                                    _norm(norm, p["ln1"], x), _positions(x),
                                    length)
        x = x + y
        x = x + _mlp(mlpk, p["mlp"], _norm(norm, p["ln2"], x))
        return x, {"kv": kv}

    return init, fwd, decode, init_cache, pfl


def moe_block(cfg) -> tuple:
    acfg = cfg.attn_config()
    ecfg = cfg.moe_config()
    norm = cfg.norm

    def init(gen):
        return {
            "ln1": _norm_init(norm, cfg.d_model, gen.device),
            "attn": attn.attn_init(gen, acfg, cfg.dtype),
            "ln2": _norm_init(norm, cfg.d_model, gen.device),
            "moe": moe_mod.moe_init(gen, ecfg, cfg.dtype),
        }

    def fwd(p, x, positions=None):
        # positions=None: the flash kernel (inference), as dense_block
        x = x + attn.self_attention(p["attn"], acfg, _norm(norm, p["ln1"], x),
                                    positions)
        y, aux = moe_mod.moe_apply(p["moe"], ecfg, _norm(norm, p["ln2"], x))
        return x + y, aux

    def decode(p, cache, x, pos):
        y, kv = attn.decode_self_attention(
            p["attn"], acfg, _norm(norm, p["ln1"], x), cache["kv"], pos)
        x = x + y
        y, _ = moe_mod.moe_apply(p["moe"], ecfg, _norm(norm, p["ln2"], x))
        return x + y, {**cache, "kv": kv}

    def init_cache(batch, length, device=None):
        return {"kv": attn.init_kv_cache(batch, length, acfg, cfg.dtype,
                                         device=device)}

    def pfl(p, x, length):
        y, kv = attn.prefill_kv_cache(p["attn"], acfg,
                                      _norm(norm, p["ln1"], x), length)
        x = x + y
        y, _ = moe_mod.moe_apply(p["moe"], ecfg, _norm(norm, p["ln2"], x))
        return x + y, {"kv": kv}

    return init, fwd, decode, init_cache, pfl


def rwkv_block(cfg) -> tuple:
    rcfg = cfg.rwkv_config()

    def init(gen):
        return {
            "ln1": layernorm_init(cfg.d_model, device=gen.device),
            "tmix": rwkv_mod.time_mix_init(gen, rcfg, cfg.dtype),
            "ln2": layernorm_init(cfg.d_model, device=gen.device),
            "cmix": rwkv_mod.channel_mix_init(gen, rcfg, cfg.dtype),
        }

    def fwd(p, x, positions=None):
        del positions  # attention-free: every path is plain torch
        x = x + rwkv_mod.time_mix_forward(p["tmix"], rcfg,
                                          layernorm(p["ln1"], x))
        x = x + rwkv_mod.channel_mix_forward(p["cmix"], rcfg,
                                             layernorm(p["ln2"], x))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def decode(p, cache, x, pos):
        del pos  # O(1) state, position-free
        y, c = rwkv_mod.time_mix_decode(p["tmix"], rcfg,
                                        layernorm(p["ln1"], x), cache["r"])
        x = x + y
        y, c = rwkv_mod.channel_mix_decode(p["cmix"], rcfg,
                                           layernorm(p["ln2"], x), c)
        return x + y, {**cache, "r": c}

    def init_cache(batch, length, device=None):
        del length  # O(1) state
        return {"r": rwkv_mod.init_rwkv_cache(batch, rcfg, cfg.dtype,
                                              device=device)}

    def pfl(p, x, length):
        del length
        h1 = layernorm(p["ln1"], x)
        y, s_fin, x_tm = rwkv_mod.time_mix_forward(p["tmix"], rcfg, h1,
                                                   return_state=True)
        x = x + y
        h2 = layernorm(p["ln2"], x)
        x = x + rwkv_mod.channel_mix_forward(p["cmix"], rcfg, h2)
        # copies: a view would keep the layer's (B, S, d) inputs alive
        return x, {"r": {"state": s_fin, "x_tm": x_tm.clone(),
                         "x_cm": h2[:, -1].clone()}}

    return init, fwd, decode, init_cache, pfl


def hybrid_block(cfg) -> tuple:
    """Hymba: attention and SSM branches in parallel on the same normed
    input, per-branch output norms, averaged; then the MLP."""
    acfg = cfg.attn_config()
    scfg = cfg.ssm_config()
    norm, mlpk = cfg.norm, cfg.mlp

    def init(gen):
        return {
            "ln1": _norm_init(norm, cfg.d_model, gen.device),
            "attn": attn.attn_init(gen, acfg, cfg.dtype),
            "ssm": ssm_mod.ssm_init(gen, scfg, cfg.dtype),
            "attn_out_norm": rmsnorm_init(cfg.d_model, device=gen.device),
            "ssm_out_norm": rmsnorm_init(cfg.d_model, device=gen.device),
            "ln2": _norm_init(norm, cfg.d_model, gen.device),
            "mlp": _mlp_init(mlpk, gen, cfg.d_model, cfg.d_ff, cfg.dtype),
        }

    def _mix(p, x, ya, ys):
        ya = rmsnorm(p["attn_out_norm"], ya)
        ys = rmsnorm(p["ssm_out_norm"], ys)
        x = x + 0.5 * (ya + ys)
        return x + _mlp(mlpk, p["mlp"], _norm(norm, p["ln2"], x))

    def fwd(p, x, positions=None):
        # positions=None: the flash kernel (inference), as dense_block
        h = _norm(norm, p["ln1"], x)
        ya = attn.self_attention(p["attn"], acfg, h, positions)
        ys = ssm_mod.ssm_forward(p["ssm"], scfg, h)
        return (_mix(p, x, ya, ys),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def decode(p, cache, x, pos):
        h = _norm(norm, p["ln1"], x)
        ya, ckv = attn.decode_self_attention(p["attn"], acfg, h,
                                             cache["kv"], pos)
        ys, ch = ssm_mod.ssm_decode_step(p["ssm"], scfg, h, cache["ssm"])
        return _mix(p, x, ya, ys), {**cache, "kv": ckv, "ssm": ch}

    def init_cache(batch, length, device=None):
        return {"kv": attn.init_kv_cache(batch, length, acfg, cfg.dtype,
                                         device=device),
                "ssm": ssm_mod.init_ssm_cache(batch, scfg, cfg.dtype,
                                              device=device)}

    def pfl(p, x, length):
        h = _norm(norm, p["ln1"], x)
        ya, kv = attn.prefill_kv_cache(p["attn"], acfg, h, length)
        ys, sc = ssm_mod.ssm_forward(p["ssm"], scfg, h, return_state=True)
        return _mix(p, x, ya, ys), {"kv": kv, "ssm": sc}

    return init, fwd, decode, init_cache, pfl


def encdec_blocks(cfg) -> tuple:
    """Whisper: returns ((enc_init, enc_fwd), (dec_init, dec_fwd,
    dec_decode, dec_init_cache, dec_pfl)). No rope (the sinusoidal
    positions are added at the embedding); the encoder attends both ways,
    and each decoder block attends over the encoder's output after its
    causal self-attention."""
    acfg = dataclasses.replace(cfg.attn_config(), rope=False)
    enc_acfg = dataclasses.replace(acfg, causal=False)
    x_acfg = dataclasses.replace(acfg, causal=False)
    norm, mlpk = cfg.norm, cfg.mlp

    def enc_init(gen):
        return {
            "ln1": _norm_init(norm, cfg.d_model, gen.device),
            "attn": attn.attn_init(gen, enc_acfg, cfg.dtype),
            "ln2": _norm_init(norm, cfg.d_model, gen.device),
            "mlp": _mlp_init(mlpk, gen, cfg.d_model, cfg.d_ff, cfg.dtype),
        }

    def enc_fwd(p, x, positions=None):
        # positions=None: the flash kernel (inference), as dense_block
        x = x + attn.self_attention(p["attn"], enc_acfg,
                                    _norm(norm, p["ln1"], x), positions)
        x = x + _mlp(mlpk, p["mlp"], _norm(norm, p["ln2"], x))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def dec_init(gen):
        return {
            "ln1": _norm_init(norm, cfg.d_model, gen.device),
            "self": attn.attn_init(gen, acfg, cfg.dtype),
            "lnx": _norm_init(norm, cfg.d_model, gen.device),
            "cross": attn.attn_init(gen, x_acfg, cfg.dtype),
            "ln2": _norm_init(norm, cfg.d_model, gen.device),
            "mlp": _mlp_init(mlpk, gen, cfg.d_model, cfg.d_ff, cfg.dtype),
        }

    def _cross_mlp(p, x, enc_out, positions=None):
        x = x + attn.cross_attention(p["cross"], x_acfg,
                                     _norm(norm, p["lnx"], x), enc_out,
                                     positions)
        return x + _mlp(mlpk, p["mlp"], _norm(norm, p["ln2"], x))

    def dec_fwd(p, x, enc_out, positions=None):
        x = x + attn.self_attention(p["self"], acfg, _norm(norm, p["ln1"], x),
                                    positions)
        return (_cross_mlp(p, x, enc_out, positions),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def dec_decode(p, cache, x, pos, enc_out):
        y, kv = attn.decode_self_attention(
            p["self"], acfg, _norm(norm, p["ln1"], x), cache["kv"], pos)
        return _cross_mlp(p, x + y, enc_out), {**cache, "kv": kv}

    def dec_init_cache(batch, length, device=None):
        return {"kv": attn.init_kv_cache(batch, length, acfg, cfg.dtype,
                                         device=device)}

    def dec_pfl(p, x, length, enc_out):
        y, kv = attn.prefill_kv_cache(p["self"], acfg,
                                      _norm(norm, p["ln1"], x), length)
        return _cross_mlp(p, x + y, enc_out), {"kv": kv}

    return ((enc_init, enc_fwd),
            (dec_init, dec_fwd, dec_decode, dec_init_cache, dec_pfl))


def vlm_group(cfg) -> tuple:
    """One Llama-3.2-Vision group: a gated cross-attention layer over the
    image tokens (``x_attn``, gate ``tanh(x_gate)``), a gated MLP
    (``x_mlp``, ``tanh(x_mlp_gate)``; the gates f32 scalars cast to the
    activation dtype), then ``cross_attn_period - 1`` dense layers
    stacked as ``selfs``. The model stacks groups, so their parameters
    and caches are (n_groups, n_self, ...)."""
    x_acfg = dataclasses.replace(cfg.attn_config(), causal=False, rope=False)
    norm, mlpk = cfg.norm, cfg.mlp
    n_self = cfg.cross_attn_period - 1
    d_init, d_fwd, d_decode, d_init_cache, d_pfl = dense_block(cfg)

    def init(gen):
        dev = gen.device
        return {
            "x_ln": _norm_init(norm, cfg.d_model, dev),
            "x_attn": attn.attn_init(gen, x_acfg, cfg.dtype),
            "x_gate": torch.zeros((), dtype=torch.float32, device=dev),
            "x_ln2": _norm_init(norm, cfg.d_model, dev),
            "x_mlp": _mlp_init(mlpk, gen, cfg.d_model, cfg.d_ff, cfg.dtype),
            "x_mlp_gate": torch.zeros((), dtype=torch.float32, device=dev),
            "selfs": stack_init(d_init, gen, n_self),
        }

    def _gated(p, x, img, positions=None):
        y = attn.cross_attention(p["x_attn"], x_acfg,
                                 _norm(norm, p["x_ln"], x), img, positions)
        x = x + torch.tanh(p["x_gate"]).to(x.dtype) * y
        y = _mlp(mlpk, p["x_mlp"], _norm(norm, p["x_ln2"], x))
        return x + torch.tanh(p["x_mlp_gate"]).to(x.dtype) * y

    def fwd(p, x, img, positions=None):
        # positions=None: the flash kernel (inference), as dense_block
        x = _gated(p, x, img, positions)
        # plain even under the model's remat: the model's stack
        # recomputes the whole group, and a remat inside another asserts
        # (_Remat); JAX checkpoints these layers too
        x, _ = stack_apply(d_fwd, p["selfs"], x, extras=(positions,))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def decode(p, cache, x, pos, img):
        x, selfs = stack_decode(lambda lp, ch, xx: d_decode(lp, ch, xx, pos),
                                p["selfs"], cache["selfs"],
                                _gated(p, x, img))
        return x, {**cache, "selfs": selfs}

    def init_cache(batch, length, device=None):
        one = d_init_cache(batch, length, device)
        return {"selfs": tree_map(lambda a: torch.stack([a] * n_self), one)}

    def pfl(p, x, length, img):
        x, caches = stack_prefill(lambda lp, xx: d_pfl(lp, xx, length),
                                  p["selfs"], _gated(p, x, img))
        return x, {"selfs": caches}

    return init, fwd, decode, init_cache, pfl
