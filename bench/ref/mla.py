"""Plain reference of the mla family (MiniCPM3-4B's block): its
parameter layout and its next-token loss, in float32.

The model as the port defines it (``models/mla.py``, the mla block of
``models/transformer.py``): per layer a pre-RMSNorm Multi-head Latent
Attention and a pre-RMSNorm SwiGLU MLP. Queries come through the
``q_lora_rank`` latent (down-projection, RMSNorm, up-projection to
``qk_nope_head_dim + qk_rope_head_dim`` a head); keys and values
through the ``kv_lora_rank`` latent (RMSNorm) decompressed per head into
``qk_nope_head_dim`` key and ``v_head_dim`` value columns, plus one
rotary key of ``qk_rope_head_dim`` shared by the heads; scores over
``1 / sqrt(nope + rope)``, causal. RMSNorm takes eps 1e-6. Departures
from the published MiniCPM3-4B, which the port's model makes too: no
embedding, residual-depth or logit scale factors and plain rotary
frequencies.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location(
    "portbench_ref_dense", Path(__file__).with_name("dense.py"))
dense = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dense)


def layout(m: dict) -> dict:
    n_l, d, h = m["n_layers"], m["d_model"], m["n_heads"]
    qr, kvr = m["q_lora_rank"], m["kv_lora_rank"]
    nope, rope_d, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                        m["v_head_dim"])
    dt = m["param_dtype"]
    lead = (n_l,)
    ones = ("ones",)
    return {
        "embed": {"table": ((m["vocab"], d), dt,
                            ("normal", 1.0 / math.sqrt(d)))},
        "blocks": {
            "ln1": {"scale": (lead + (d,), "float32", ones)},
            "attn": {
                "wq_a": dense._dense(lead, d, (qr,), dt),
                "q_norm": {"scale": (lead + (qr,), "float32", ones)},
                "wq_b": dense._dense(lead, qr, (h, nope + rope_d), dt),
                "wkv_a": dense._dense(lead, d, (kvr + rope_d,), dt),
                "kv_norm": {"scale": (lead + (kvr,), "float32", ones)},
                "wkv_b": dense._dense(lead, kvr, (h, nope + vd), dt),
                "wo": dense._dense(lead, h * vd, (d,), dt),
            },
            "ln2": {"scale": (lead + (d,), "float32", ones)},
            "mlp": dense.mlp_layout(m, lead, dt),
        },
        "final_norm": {"scale": ((d,), "float32", ones)},
        "unembed": dense._dense((), d, (m["vocab"],), dt),
    }


def attention(m: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    nope, kvr = m["qk_nope_head_dim"], m["kv_lora_rank"]
    theta = m["rope_theta"]
    rms = {"norm": "rmsnorm"}
    q = dense.linear(m, p["wq_b"], dense.norm(rms, p["q_norm"],
                                           dense.linear(m, p["wq_a"], x)))
    q_nope, q_pe = q[..., :nope], dense.rope(q[..., nope:], theta)
    kv = dense.linear(m, p["wkv_a"], x)
    c_kv = dense.norm(rms, p["kv_norm"], kv[..., :kvr])
    k_pe = dense.rope(kv[..., None, kvr:], theta)[:, :, 0]
    kvu = dense.linear(m, p["wkv_b"], c_kv)
    k_nope, v = kvu[..., :nope], kvu[..., nope:]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhr,bkr->bhqk", q_pe, k_pe)
              ) / math.sqrt(nope + m["qk_rope_head_dim"])
    ok = dense.causal_mask(s, None, x.device)
    scores = scores.masked_fill(~ok, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    return dense.linear(m, p["wo"], o.reshape(b, s, -1))


def loss(slab: torch.Tensor, leaves, tokens: torch.Tensor,
         m: dict) -> torch.Tensor:
    p = dense.nest({lf.path: slab[lf.offset:lf.offset + lf.size]
                    .view(lf.shape) for lf in leaves})
    x = p["embed"]["table"][tokens]
    for i in range(m["n_layers"]):
        lp = dense.layer(p["blocks"], i)
        x = x + attention(m, lp["attn"], dense.norm(m, lp["ln1"], x))
        x = x + dense.mlp(m, lp["mlp"], dense.norm(m, lp["ln2"], x))
    x = dense.norm(m, p["final_norm"], x)
    return dense.xent(dense.linear(m, p["unembed"], x), tokens)
