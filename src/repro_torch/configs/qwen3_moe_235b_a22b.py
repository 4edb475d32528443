"""Qwen3-235B-A22B [hf:Qwen/Qwen3-30B-A3B card family]: 94L, d_model
4096, 64 heads (GQA kv=4, head_dim 128), qk-norm; MoE 128 experts top-8,
expert d_ff 1536, vocab 151936."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, n_experts=128, top_k=8, qk_norm=True,
    rope_theta=1000000.0,
    notes="128 experts top-8 [hf:Qwen/Qwen3-30B-A3B card family]",
)
