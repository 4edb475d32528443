"""Model FLOPs of a round of the mla family, counted as
``bench/counts/dense.py`` counts them: the projections (the query and
key-value latents' down and up projections, the output projection, the
SwiGLU MLP, the output head) at 2 FLOPs a parameter a token, plus the
scores over ``qk_nope_head_dim + qk_rope_head_dim`` and the values over
``v_head_dim`` for each visible causal pair and head; 3 forwards a
round.
"""

from __future__ import annotations


def matmul_params(m: dict) -> int:
    d, h = m["d_model"], m["n_heads"]
    qr, kvr = m["q_lora_rank"], m["kv_lora_rank"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    attn = (d * qr + qr * h * (nope + rope) + d * (kvr + rope)
            + kvr * h * (nope + vd) + h * vd * d)
    mlp = 3 * d * m["d_ff"]
    return m["n_layers"] * (attn + mlp) + d * m["vocab"]


def flops_per_round(m: dict, tr: dict) -> float:
    seq = tr["seq"]
    seqs = tr["clients"] * tr["batch"]
    pairs = seq * (seq + 1) // 2
    per_pair = 2 * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
                    + m["v_head_dim"])
    attn = seqs * pairs * m["n_heads"] * per_pair * m["n_layers"]
    return 3.0 * (2.0 * matmul_params(m) * seqs * seq + attn)
