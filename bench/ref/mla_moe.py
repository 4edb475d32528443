"""Plain reference of the mla_moe family (DeepSeek-V2-Lite's layers, one
expert-parallel share): its parameter layout and its next-token loss,
in float32.

The model as the port defines it (``models/mla.py``, ``models/moe.py``,
the mla_moe family of ``models/model.py``), written out again from the
layer equations of DeepSeek-V2 (arXiv:2405.04434):

* ``n_dense_layers`` leading layers (``dense_blocks``) of pre-RMSNorm
  MLA and a pre-RMSNorm SwiGLU MLP of width ``d_ff``; then the layers
  ``blocks`` of pre-RMSNorm MLA and a pre-RMSNorm MoE;
* MLA with no query latent: q = x W_q per head, ``qk_nope_head_dim``
  columns and ``qk_rope_head_dim`` rotary ones; [c; k_pe] = x W_kva,
  c RMS-normed, k_pe shared by the heads; [k_nope; v] = c W_kvb; rotary
  embedding on q_pe and k_pe at YaRN's frequencies (written out here),
  each column i paired with column i + D/2 (the port's pairing; the
  published code pairs interleaved columns, a fixed permutation of the
  weights' rope columns); scores (q_nope.k_nope + q_pe.k_pe) times
  mscale(factor, mscale_all_dim)^2 / sqrt(nope + rope), causal;
* the MoE: p = softmax(x W_r) over all ``n_experts``; the ``top_k``
  largest give the ids and the gates p[ids] (renormalised under
  ``normalize_topk``); each (token, k) slot's arrival rank within its
  expert, in (token, k) order, is counted by a one-hot cumulative sum,
  and a slot whose rank reaches the capacity max(1, int(T k cf / E)) is
  dropped; the layer holds experts [first_expert, first_expert +
  experts_held) and adds, for each held expert, its SwiGLU of the kept
  tokens routed to it times their gates; plus the shared experts' SwiGLU
  of width ``expert_d_ff * n_shared_experts``; the balance loss
  sequence-wise (DeepSeek-V2's ``seq_aux``: per sequence, each expert's
  top-k count before any drop over S k / E, times its mean probability,
  summed over experts, the mean over sequences, times
  ``aux_loss_weight``), added to the loss.

RMSNorm takes eps 1e-6. Every product runs in float32 (the caller turns
TF32 off), the router's and the experts' through ``dense.linear``, so the
control (``"precision": "fp8"``) holds their operands in fp8 too.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F

_spec = importlib.util.spec_from_file_location(
    "portbench_ref_dense", Path(__file__).with_name("dense.py"))
dense = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dense)


def layout(m: dict) -> dict:
    d, h = m["d_model"], m["n_heads"]
    kvr = m["kv_lora_rank"]
    nope, rope_d, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                        m["v_head_dim"])
    n_dense = m["n_dense_layers"]
    n_moe = m["n_layers"] - n_dense
    e, held = m["n_experts"], m.get("experts_held") or m["n_experts"]
    f = m["expert_d_ff"]
    dt = m["param_dtype"]
    ones = ("ones",)

    def attn(lead):
        return {"wq": dense._dense(lead, d, (h, nope + rope_d), dt),
                "wkv_a": dense._dense(lead, d, (kvr + rope_d,), dt),
                "kv_norm": {"scale": (lead + (kvr,), "float32", ones)},
                "wkv_b": dense._dense(lead, kvr, (h, nope + vd), dt),
                "wo": dense._dense(lead, h * vd, (d,), dt)}

    def norms(lead):
        return {"ln1": {"scale": (lead + (d,), "float32", ones)},
                "ln2": {"scale": (lead + (d,), "float32", ones)}}

    lead = (n_moe,)
    fs = f * m["n_shared_experts"]
    return {
        "embed": {"table": ((m["vocab"], d), dt,
                            ("normal", 1.0 / math.sqrt(d)))},
        "dense_blocks": {**norms((n_dense,)), "attn": attn((n_dense,)),
                         "mlp": dense.mlp_layout(m, (n_dense,), dt)},
        "blocks": {
            **norms(lead), "attn": attn(lead),
            "moe": {
                "router": dense._dense(lead, d, (e,), dt),
                "gate": (lead + (held, d, f), dt,
                         ("normal", 1.0 / math.sqrt(d))),
                "up": (lead + (held, d, f), dt,
                       ("normal", 1.0 / math.sqrt(d))),
                "down": (lead + (held, f, d), dt,
                         ("normal", 1.0 / math.sqrt(f))),
                "shared": {"gate": dense._dense(lead, d, (fs,), dt),
                           "up": dense._dense(lead, d, (fs,), dt),
                           "down": dense._dense(lead, fs, (d,), dt)},
            },
        },
        "final_norm": {"scale": ((d,), "float32", ones)},
        "unembed": dense._dense((), d, (m["vocab"],), dt),
    }


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn(m: dict, device):
    """(inverse frequencies (rope / 2,), cos / sin factor, softmax
    factor) of the model's rotary embedding: YaRN's where
    ``yarn_factor`` is set, else the plain ones and 1, 1."""
    dim, base = m["qk_rope_head_dim"], m["rope_theta"]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    plain = 1.0 / base ** (2.0 * i / dim)
    factor = m.get("yarn_factor") or 0.0
    if not factor:
        return plain, 1.0, 1.0
    original = m["yarn_original_len"]

    def at(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(at(m["yarn_beta_fast"])), 0)
    high = min(math.ceil(at(m["yarn_beta_slow"])), dim - 1)
    ramp = ((i - low) / max(high - low, 1e-3)).clamp(0.0, 1.0)
    inv = plain * (1.0 - ramp) + plain / factor * ramp
    m_all = _mscale(factor, m["yarn_mscale_all_dim"])
    amp = _mscale(factor, m["yarn_mscale"]) / m_all
    return inv, amp, (m_all * m_all if m["yarn_mscale_all_dim"] else 1.0)


def rope(x: torch.Tensor, inv: torch.Tensor, amp: float) -> torch.Tensor:
    """x (B, S, H, D): rotate (x[:D/2], x[D/2:]) by position * inv."""
    s, d = x.shape[1], x.shape[-1]
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cos(ang)[None, :, None] * amp
    sin = torch.sin(ang)[None, :, None] * amp
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(m: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    nope, kvr = m["qk_nope_head_dim"], m["kv_lora_rank"]
    inv, amp, soft = yarn(m, x.device)
    rms = {"norm": "rmsnorm"}
    q = dense.linear(m, p["wq"], x)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], inv, amp)
    kv = dense.linear(m, p["wkv_a"], x)
    c_kv = dense.norm(rms, p["kv_norm"], kv[..., :kvr])
    k_pe = rope(kv[..., None, kvr:], inv, amp)[:, :, 0]
    kvu = dense.linear(m, p["wkv_b"], c_kv)
    k_nope, v = kvu[..., :nope], kvu[..., nope:]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhr,bkr->bhqk", q_pe, k_pe)
              ) * (soft / math.sqrt(nope + m["qk_rope_head_dim"]))
    ok = dense.causal_mask(s, None, x.device)
    scores = scores.masked_fill(~ok, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    return dense.linear(m, p["wo"], o.reshape(b, s, -1))


def swiglu(m: dict, gate: dict, up: dict, down: dict,
           x: torch.Tensor) -> torch.Tensor:
    return dense.linear(m, down, F.silu(dense.linear(m, gate, x))
                        * dense.linear(m, up, x))


def moe(m: dict, p: dict, x: torch.Tensor):
    """(the share's routed part plus the shared experts, balance loss)."""
    b, s, d = x.shape
    t, k, e = b * s, m["top_k"], m["n_experts"]
    held = m.get("experts_held") or e
    first = m.get("first_expert", 0)
    xt = x.reshape(t, d)
    probs = torch.softmax(dense.linear(m, p["router"], xt), dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    if m.get("normalize_topk", True):
        gates = gates / gates.sum(-1, keepdim=True)
    flat = ids.reshape(-1)                          # (token, k) order
    onehot = F.one_hot(flat, e)
    rank = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
    cap = max(1, int(t * k * m["capacity_factor"] / e))
    kept = rank < cap
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(held):
        slots = torch.nonzero(kept & (flat == first + j))[:, 0]
        tok = slots // k
        o = swiglu(m, {"kernel": p["gate"][j]}, {"kernel": p["up"][j]},
                   {"kernel": p["down"][j]}, xt[tok])
        y = y.index_add(0, tok, o * gates.reshape(-1)[slots][:, None])
    y = y.reshape(b, s, d) + swiglu(m, p["shared"]["gate"],
                                    p["shared"]["up"], p["shared"]["down"], x)
    counts = F.one_hot(ids.reshape(b, s * k), e).sum(1).float()
    ce = counts / (s * k / e)
    aux = (ce * probs.reshape(b, s, e).mean(1)).sum(1).mean()
    return y, m["aux_loss_weight"] * aux


def loss(slab: torch.Tensor, leaves, tokens: torch.Tensor,
         m: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (B, S) plus the MoE
    layers' balance losses, under the parameters held in ``slab``."""
    p = dense.nest({lf.path: slab[lf.offset:lf.offset + lf.size]
                    .view(lf.shape) for lf in leaves})
    x = p["embed"]["table"][tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(m["n_dense_layers"]):
        lp = dense.layer(p["dense_blocks"], i)
        x = x + attention(m, lp["attn"], dense.norm(m, lp["ln1"], x))
        x = x + dense.mlp(m, lp["mlp"], dense.norm(m, lp["ln2"], x))
    for i in range(m["n_layers"] - m["n_dense_layers"]):
        lp = dense.layer(p["blocks"], i)
        x = x + attention(m, lp["attn"], dense.norm(m, lp["ln1"], x))
        y, a = moe(m, lp["moe"], dense.norm(m, lp["ln2"], x))
        x, aux = x + y, aux + a
    x = dense.norm(m, p["final_norm"], x)
    return dense.xent(dense.linear(m, p["unembed"], x), tokens) + aux
