"""Qwen3-14B [hf:Qwen/Qwen3-14B family]: 40L, d_model 5120, 40 heads
(GQA kv=8, head_dim 128), d_ff 17408, vocab 151936; per-head qk-norm,
no biases, RMSNorm + SwiGLU."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1000000.0,
    notes="qk_norm, GQA [hf:Qwen/Qwen3-8B card family]",
)
