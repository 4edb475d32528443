"""A plain float32 reference of the port's mla_moe family
(DeepSeek-V2-Lite's layers, one expert-parallel share), for the CPU
tests: the loss of the port's parameter tree, written out from the layer
equations of DeepSeek-V2 (arXiv:2405.04434) in plain ``torch``, with TF32
off, and nothing of the port or of JAX imported.

No dispatch buffer, no ``index_put`` and no ``vmap``: each (token, k)
slot's arrival rank within its expert is a one-hot cumulative count, and
each held expert gathers its kept slots and adds its SwiGLU of them,
gated, into the tokens' rows. YaRN's inverse frequencies and softmax
factor are its closed form (``yarn``). The benchmark's reference,
``bench/ref/mla_moe.py``, is a second copy on the slab, and a test holds
the two to the same loss.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn(m: dict):
    """(low, high, inverse frequencies, softmax factor) of YaRN: the
    ramp runs from pair ``low`` (beta_fast's correction dimension,
    floored) to pair ``high`` (beta_slow's, ceiled); below it each pair
    keeps theta^(-2i/D), above it is divided by the factor."""
    dim, base, factor = (m["qk_rope_head_dim"], m["rope_theta"],
                         m["yarn_factor"])
    original = m["yarn_original_len"]

    def corr(rotations):
        return dim * math.log(original / (rotations * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(corr(m["yarn_beta_fast"])), 0)
    high = min(math.ceil(corr(m["yarn_beta_slow"])), dim - 1)
    inv = []
    for i in range(dim // 2):
        f = base ** (-2.0 * i / dim)
        r = min(max((i - low) / max(high - low, 1e-3), 0.0), 1.0)
        inv.append(f * (1.0 - r) + f / factor * r)
    ms = _mscale(factor, m["yarn_mscale_all_dim"])
    return low, high, torch.tensor(inv, dtype=torch.float32), ms * ms


def _lin(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    w = w.float()
    return (x.reshape(-1, w.shape[0]) @ w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])


def _rms(scale, x):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) * scale


def _rope(x, inv):
    s, d = x.shape[1], x.shape[-1]
    ang = torch.arange(s, dtype=torch.float32)[:, None] * inv[None, :]
    c, sn = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * c - b * sn, a * sn + b * c], -1)


def _swiglu(gate, up, down, x):
    return _lin(down, F.silu(_lin(gate, x)) * _lin(up, x))


def attention(m, p, x):
    b, s, _ = x.shape
    nope, kvr = m["qk_nope_head_dim"], m["kv_lora_rank"]
    _, _, inv, soft = yarn(m)
    q = _lin(p["wq"]["kernel"], x)
    kv = _lin(p["wkv_a"]["kernel"], x)
    c = _rms(p["kv_norm"]["scale"].float(), kv[..., :kvr])
    k_pe = _rope(kv[..., None, kvr:], inv)[:, :, 0]
    q_pe = _rope(q[..., nope:], inv)
    kvu = _lin(p["wkv_b"]["kernel"], c)
    sc = (torch.einsum("bqhd,bkhd->bhqk", q[..., :nope], kvu[..., :nope])
          + torch.einsum("bqhr,bkr->bhqk", q_pe, k_pe)) * soft / math.sqrt(
              nope + m["qk_rope_head_dim"])
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    sc = sc.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), kvu[..., nope:])
    return _lin(p["wo"]["kernel"], o.reshape(b, s, -1))


def moe(m, p, x, record=None):
    """(routed part of the held experts + shared experts, balance loss);
    ``record`` (a list) gets the layer's top-k ids (T, k)."""
    b, s, d = x.shape
    t, k, e = b * s, m["top_k"], m["n_experts"]
    held, first = m["experts_held"] or e, m["first_expert"]
    xt = x.reshape(t, d)
    probs = (xt @ p["router"]["kernel"].float()).softmax(-1)
    gates, ids = probs.topk(k, -1)
    if m["normalize_topk"]:
        gates = gates / gates.sum(-1, keepdim=True)
    if record is not None:
        record.append(ids)
    flat = ids.reshape(-1)
    hot = F.one_hot(flat, e)
    before = (hot.cumsum(0) - hot)[torch.arange(t * k), flat]
    kept = before < max(1, int(t * k * m["capacity_factor"] / e))
    y = torch.zeros(t, d)
    for j in range(held):
        slot = torch.nonzero(kept & (flat == first + j))[:, 0]
        tok = slot // k
        out = _swiglu(p["gate"][j], p["up"][j], p["down"][j], xt[tok])
        y = y.index_add(0, tok, out * gates.reshape(-1)[slot, None])
    sh = p["shared"]
    y = y.reshape(b, s, d) + _swiglu(sh["gate"]["kernel"], sh["up"]["kernel"],
                                     sh["down"]["kernel"], x)
    count = F.one_hot(ids.reshape(b, s * k), e).sum(1).float()
    aux = (count / (s * k / e) * probs.reshape(b, s, e).mean(1)).sum(1)
    return y, m["aux_loss_weight"] * aux.mean()


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def loss(params: dict, tokens: torch.Tensor, m: dict, record=None):
    """Next-token cross-entropy of ``tokens`` (B, S) plus the balance
    losses, under the port's parameter tree ``params``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = params["embed"]["table"].float()[tokens]
        aux = torch.zeros(())
        for i in range(m["n_dense_layers"]):
            lp = _layer(params["dense_blocks"], i)
            x = x + attention(m, lp["attn"],
                              _rms(lp["ln1"]["scale"].float(), x))
            h = _rms(lp["ln2"]["scale"].float(), x)
            x = x + _swiglu(lp["mlp"]["gate"]["kernel"],
                            lp["mlp"]["up"]["kernel"],
                            lp["mlp"]["down"]["kernel"], h)
        for i in range(m["n_layers"] - m["n_dense_layers"]):
            lp = _layer(params["blocks"], i)
            x = x + attention(m, lp["attn"],
                              _rms(lp["ln1"]["scale"].float(), x))
            y, a = moe(m, lp["moe"], _rms(lp["ln2"]["scale"].float(), x),
                       record)
            x, aux = x + y, aux + a
        x = _rms(params["final_norm"]["scale"].float(), x)
        logits = _lin(params["unembed"]["kernel"], x)
        xent = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1))
        return xent + aux
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
