"""Model FLOPs of a round of the dense family, counted from the shapes.

The forward is 2 FLOPs a matmul parameter a token (the attention and MLP
projections and the output projection; not the embedding lookup, the
norms or the biases) plus attention's score and value products over the
visible (causal, windowed) pairs: 2 head_dim each, a head. Forward plus
backward is 3 forwards; remat's recompute is not counted. A round is
every client's batch once.
"""

from __future__ import annotations


def pairs(seq: int, window) -> int:
    """Visible (query, key) pairs of one causal sequence."""
    w = window or seq
    return sum(min(i + 1, w) for i in range(seq))


def matmul_params(m: dict) -> int:
    d, h, k, ff, v = (m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"],
                      m["vocab"])
    hd = m.get("head_dim") or d // h
    attn = d * h * hd * 2 + d * k * hd * 2
    mlp = (3 if m["mlp"] == "swiglu" else 2) * d * ff
    return m["n_layers"] * (attn + mlp) + d * v


def flops_per_round(m: dict, tr: dict) -> float:
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    seqs = tr["clients"] * tr["batch"]
    tokens = seqs * tr["seq"]
    attn = (seqs * pairs(tr["seq"], m.get("window")) * m["n_heads"]
            * 4 * hd * m["n_layers"])
    return 3.0 * (2.0 * matmul_params(m) * tokens + attn)
