"""Mixture-of-Experts layer: top-k routing, capacity-bounded sort-based
dispatch through an (E, C, d) buffer, batched expert SwiGLU,
Switch-style load-balance auxiliary loss, optional always-on shared
expert (Kimi-K2 style).

PyTorch counterpart of ``repro.models.moe`` for one device. It keeps
the JAX package's semantics exactly, its drops included:

* each token's k routed slots, flattened in (token, k) order, take their
  rank within their expert from a *stable* sort; a slot whose rank
  reaches the capacity ``max(1, int(T k cf / E))`` is dropped, T being
  the tokens of the call. A decode step's T is its batch, so at
  Qwen3-MoE's batch-4 decode the capacity is 1 and a second token routed
  to the same expert is dropped, as in JAX;
* the router runs in f32; the expert products have bf16 operands and
  f32 results (the JAX einsums' ``preferred_element_type=f32``,
  ``_expert_product``); the combine sums each token's k gated slots in
  f32, in k order (the order of JAX's scatter-add), and casts once.

No expert kernel: the JAX package computes the layer in XLA, not in
Pallas. The capacity comes from static shapes and nothing reads a value
back to the host, so ``torch.func.vmap(grad_and_value)`` over clients
runs it. JAX's shard_map expert-parallel path (``set_moe_sharding`` /
``_moe_apply_sharded``) is not ported: ``ModelConfig.moe_config()``
leaves out ``moe_sharded``, so the port computes the plain path, as JAX
does when no mesh is set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, swiglu, swiglu_init,
                                       truncated_normal)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    n_shared_experts: int = 0      # always-on experts (Kimi-K2 has 1)
    capacity_factor: float = 1.25
    normalize_topk: bool = True    # renormalise the k gates to sum to 1
    aux_loss_weight: float = 0.01


def moe_init(gen: torch.Generator, cfg: MoEConfig,
             dtype=torch.bfloat16) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(gen, d, (e,), torch.float32),
        "gate": truncated_normal(gen, (e, d, f), 1.0 / math.sqrt(d), dtype),
        "up": truncated_normal(gen, (e, d, f), 1.0 / math.sqrt(d), dtype),
        "down": truncated_normal(gen, (e, f, d), 1.0 / math.sqrt(f), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(gen, d, cfg.d_ff * cfg.n_shared_experts,
                                  dtype)
    return p


def _positions_in_expert(expert_ids: torch.Tensor,
                         n_experts: int) -> torch.Tensor:
    """For each flat slot, its arrival rank within its expert: a stable
    argsort, then each sorted slot's distance from the start of its
    expert's run (O(n log n), no (n, E) one-hot)."""
    del n_experts
    n = expert_ids.shape[0]
    order = torch.argsort(expert_ids, stable=True)
    sorted_e = expert_ids[order]
    idx = torch.arange(n, dtype=torch.int64, device=expert_ids.device)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool,
                                     device=expert_ids.device),
                          sorted_e[1:] != sorted_e[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    pos_sorted = idx - seg_start
    return torch.zeros_like(idx).scatter(0, order, pos_sorted)


def _expert_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, C, x) @ (E, x, y) with an f32 result from operands of one
    dtype: products exact in f32, sums in f32. On the card a bf16
    inference call takes cuBLAS's f32 output (``torch.bmm(out_dtype=)``,
    which has no derivative and no batching rule); training (an operand
    that requires grad or lies under a ``torch.func`` transform), f32 and
    the CPU multiply the operands cast to f32, the same function."""
    if (a.is_cuda and a.dtype == b.dtype == torch.bfloat16
            and not any(t.requires_grad or _under_transform(t)
                        for t in (a, b))):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _under_transform(t: torch.Tensor) -> bool:
    """Whether ``t`` lies under a ``torch.func`` transform. torch has no
    public test; its private one (torch 2.11 and 2.13 have it) is read
    defensively, and where it is gone the answer is yes, which picks the
    cast-to-f32 product: the same function, correct everywhere."""
    check = getattr(getattr(torch._C, "_functorch", None),
                    "is_functorch_wrapped_tensor", None)
    return check is None or bool(check(t))


def _route(p: dict, cfg: MoEConfig, xt: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 router logits, softmax and top-k: (probs (T, E), gates (T, k),
    expert ids (T, k)), the gates renormalised to sum to 1."""
    logits = xt.float() @ p["router"]["kernel"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.normalize_topk:
        gate_vals = gate_vals / torch.clamp_min(
            torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def _slots(cfg: MoEConfig, expert_idx: torch.Tensor) -> tuple:
    """The (T, k) routing flattened into T k slots in (token, k) order:
    each slot's expert and token, whether it is kept (its rank in its
    expert below the capacity ``max(1, int(T k cf / E))``), its rank
    clamped to the capacity, and the capacity."""
    t, k = expert_idx.shape
    e_flat = expert_idx.reshape(t * k)
    tok_flat = torch.arange(t, device=e_flat.device).repeat_interleave(k)
    pos = _positions_in_expert(e_flat, cfg.n_experts)
    capacity = max(1, int(t * k * cfg.capacity_factor / cfg.n_experts))
    return (e_flat, tok_flat, pos < capacity,
            torch.clamp_max(pos, capacity - 1), capacity)


def moe_apply(p: dict, cfg: MoEConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar f32)."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    xt = x.reshape(t, d)
    probs, gate_vals, expert_idx = _route(p, cfg, xt)

    e_flat, tok_flat, keep, pos_c, capacity = _slots(cfg, expert_idx)

    # Dispatch: (E, C, d) buffer; a dropped slot adds zero (to a slot of
    # its expert's last row), so every add is exact.
    vals = xt[tok_flat] * keep[:, None].to(x.dtype)
    buf = torch.zeros((e, capacity, d), dtype=x.dtype, device=x.device
                      ).index_put((e_flat, pos_c), vals, accumulate=True)

    # Expert SwiGLU, batched over E, f32 results.
    g = F.silu(_expert_product(buf, p["gate"]))
    u = _expert_product(buf, p["up"])
    h = (g * u).to(x.dtype)
    out_buf = _expert_product(h, p["down"])                  # (E, C, d) f32

    # Combine: each slot's result, gated, summed over k in f32 in k order.
    slot_out = (out_buf[e_flat, pos_c] * keep[:, None]
                * gate_vals.reshape(t * k, 1)).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + slot_out[:, j]
    y = y.to(x.dtype).reshape(b, s, d)

    if cfg.n_shared_experts:
        y = y + swiglu(p["shared"], x)

    # Switch-style load-balance loss: E * sum_e f_e * P_e.
    f_e = torch.zeros(e, dtype=torch.float32, device=x.device).index_add(
        0, e_flat, keep.float()) / max(t * k, 1)
    p_e = torch.mean(probs, dim=0)
    aux = cfg.aux_loss_weight * e * torch.sum(f_e * p_e)
    return y, aux


def moe_reference_dense(p: dict, cfg: MoEConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """Oracle: every token through ALL experts, mixed by the
    (renormalised) top-k gates. E/k times the flops; only for tests of
    the dispatch path (with a capacity factor large enough that nothing
    is dropped)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, gate_vals, expert_idx = _route(p, cfg, xt)
    full_gates = torch.zeros_like(probs).scatter(1, expert_idx, gate_vals)
    xe = xt[None].expand(cfg.n_experts, -1, -1)
    g = F.silu(_expert_product(xe, p["gate"]))
    u = _expert_product(xe, p["up"])
    h = (g * u).to(x.dtype)
    o = _expert_product(h, p["down"])                        # (E, T, d) f32
    y = torch.einsum("etd,te->td", o, full_gates).to(x.dtype)
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + swiglu(p["shared"], x)
    return y
