"""Qwen2.5-14B [hf:Qwen/Qwen2.5-14B family, dims per assignment]: 48L,
d_model 5120, 40 heads (GQA kv=8), d_ff 13824, vocab 152064; QKV bias,
RMSNorm + SwiGLU, rope_theta 1e6. Full attention (long_500k served via
the beyond-paper sliding-window variant applied at launch)."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab=152064, qkv_bias=True, rope_theta=1000000.0,
    notes="GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B card family]",
)
