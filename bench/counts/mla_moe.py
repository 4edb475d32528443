"""Model FLOPs of a round of the mla_moe family, counted as
``bench/counts/dense.py`` counts them: 2 FLOPs a matmul parameter a
token, where the parameters are MLA's projections (no query latent:
``wq``, the key-value latent's down and up projections, the output
projection), the leading dense layers' SwiGLU MLP, each MoE layer's
router, its shared experts and its held experts at their expected share
of a token's routing (``top_k * experts_held / n_experts`` experts, 0.75
at DeepSeek-V2-Lite's 6 of 64 with 8 held), and the output head; plus
the scores over ``qk_nope_head_dim + qk_rope_head_dim`` and the values
over ``v_head_dim`` for each visible causal pair and head; 3 forwards a
round. Dropped slots and remat's recompute are not subtracted or added.
"""

from __future__ import annotations


def matmul_params(m: dict) -> float:
    d, h = m["d_model"], m["n_heads"]
    kvr = m["kv_lora_rank"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    attn = (d * h * (nope + rope) + d * (kvr + rope)
            + kvr * h * (nope + vd) + h * vd * d)
    n_dense = m["n_dense_layers"]
    e = m["n_experts"]
    held = m.get("experts_held") or e
    expert = 3 * d * m["expert_d_ff"]
    moe = (d * e + m["n_shared_experts"] * expert
           + expert * m["top_k"] * held / e)
    return (m["n_layers"] * attn + n_dense * 3 * d * m["d_ff"]
            + (m["n_layers"] - n_dense) * moe + d * m["vocab"])


def flops_per_round(m: dict, tr: dict) -> float:
    seq = tr["seq"]
    seqs = tr["clients"] * tr["batch"]
    pairs = seq * (seq + 1) // 2
    per_pair = 2 * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
                    + m["v_head_dim"])
    attn = seqs * pairs * m["n_heads"] * per_pair * m["n_layers"]
    return 3.0 * (2.0 * matmul_params(m) * seqs * seq + attn)
