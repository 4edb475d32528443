"""Plain reference of the dense family (StarCoder2-15B's block): its
parameter layout and its next-token loss, in float32.

The model as the port defines it (``models/model.py``, the dense block
of ``models/transformer.py``): token embedding; per layer a pre-norm
GQA self-attention (q, k, v projections with biases when ``qkv_bias``;
rotary embedding on the two halves of each head, base ``rope_theta``;
causal, within ``window`` positions; the output projection without a
bias) and a pre-norm MLP (GeLU, tanh form, with biases; or SwiGLU);
a final norm and the output projection. LayerNorm takes eps 1e-5,
RMSNorm 1e-6. Departures from the published StarCoder2-15B, which the
port's model makes too: its attention output projection carries no
bias. The loss is the mean cross-entropy of tokens 1..S-1 given the
ones before.

Every product runs in float32 (the caller turns TF32 off); the port
runs its matrix products on bf16 operands. With ``"precision": "fp8"``
in the model dict the projections take fp8 operands: the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dims(m: dict):
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    return (m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"], hd,
            m["d_ff"], m["vocab"])


def _norm_layout(m: dict, lead: tuple, dim: int) -> dict:
    out = {"scale": (lead + (dim,), "float32", ("ones",))}
    if m["norm"] == "layernorm":
        out["bias"] = (lead + (dim,), "float32", ("zeros",))
    return out


def _dense(lead, din, dout, dt, bias=False) -> dict:
    out = {"kernel": (lead + (din,) + tuple(dout), dt,
                      ("normal", 1.0 / math.sqrt(din)))}
    if bias:
        out["bias"] = (lead + tuple(dout), dt, ("zeros",))
    return out


def mlp_layout(m: dict, lead: tuple, dt: str) -> dict:
    d, ff = m["d_model"], m["d_ff"]
    if m["mlp"] == "swiglu":
        return {"gate": _dense(lead, d, (ff,), dt),
                "up": _dense(lead, d, (ff,), dt),
                "down": _dense(lead, ff, (d,), dt)}
    return {"up": _dense(lead, d, (ff,), dt, bias=True),
            "down": _dense(lead, ff, (d,), dt, bias=True)}


def layout(m: dict) -> dict:
    """Nested ``(shape, dtype, init)`` of every parameter, the per-layer
    ones stacked on a leading layer axis."""
    if m.get("qk_norm"):
        raise ValueError("the dense reference has no qk_norm")
    n_l, d, h, k, hd, _, v = _dims(m)
    dt = m["param_dtype"]
    lead = (n_l,)
    bias = bool(m["qkv_bias"])
    return {
        "embed": {"table": ((v, d), dt, ("normal", 1.0 / math.sqrt(d)))},
        "blocks": {
            "ln1": _norm_layout(m, lead, d),
            "attn": {"wq": _dense(lead, d, (h, hd), dt, bias),
                     "wk": _dense(lead, d, (k, hd), dt, bias),
                     "wv": _dense(lead, d, (k, hd), dt, bias),
                     "wo": _dense(lead, h * hd, (d,), dt)},
            "ln2": _norm_layout(m, lead, d),
            "mlp": mlp_layout(m, lead, dt),
        },
        "final_norm": _norm_layout(m, (), d),
        "unembed": _dense((), d, (v,), dt),
    }


def norm(m: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    if m["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * p["scale"] + p["bias"]
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) * p["scale"]


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale for the tensor; the gradient
    passes straight through."""
    amax = x.detach().abs().max()
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


def linear(m: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel (+ bias); under ``m["precision"] == "fp8"`` (the
    control) on operands held in fp8."""
    k = p["kernel"]
    if m.get("precision") == "fp8":
        x, k = fp8(x), fp8(k)
    y = torch.tensordot(x, k, dims=1)
    return y + p["bias"] if "bias" in p else y


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D): rotate (x[:D/2], x[D/2:]) by position * freq."""
    s, d = x.shape[1], x.shape[-1]
    freq = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mlp(m: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    if m["mlp"] == "swiglu":
        return linear(m, p["down"], F.silu(linear(m, p["gate"], x))
                      * linear(m, p["up"], x))
    return linear(m, p["down"],
                  F.gelu(linear(m, p["up"], x), approximate="tanh"))


def causal_mask(s: int, window, device) -> torch.Tensor:
    i = torch.arange(s, device=device)
    dist = i[:, None] - i[None, :]
    ok = dist >= 0
    if window:
        ok = ok & (dist < window)
    return ok


def attention(m: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    _, _, h, k, hd, _, _ = _dims(m)
    b, s, _ = x.shape
    theta = m["rope_theta"]
    q = rope(linear(m, p["wq"], x), theta)              # (B, S, H, hd)
    kk = rope(linear(m, p["wk"], x), theta)             # (B, S, K, hd)
    v = linear(m, p["wv"], x)
    q = q.reshape(b, s, k, h // k, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, kk) / math.sqrt(hd)
    ok = causal_mask(s, m.get("window"), x.device)
    scores = scores.masked_fill(~ok, float("-inf"))
    o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(scores, -1), v)
    return linear(m, p["wo"], o.reshape(b, s, h * hd))


def xent(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def nest(views: dict) -> dict:
    out: dict = {}
    for path, t in views.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return out


def layer(p: dict, i: int) -> dict:
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in p.items()}


def loss(slab: torch.Tensor, leaves, tokens: torch.Tensor,
         m: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (B, S) under the
    parameters held in ``slab`` (f32)."""
    p = nest({lf.path: slab[lf.offset:lf.offset + lf.size].view(lf.shape)
              for lf in leaves})
    x = p["embed"]["table"][tokens]
    for i in range(m["n_layers"]):
        lp = layer(p["blocks"], i)
        x = x + attention(m, lp["attn"], norm(m, lp["ln1"], x))
        x = x + mlp(m, lp["mlp"], norm(m, lp["ln2"], x))
    x = norm(m, p["final_norm"], x)
    return xent(linear(m, p["unembed"], x), tokens)
