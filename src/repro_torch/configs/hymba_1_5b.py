"""Hymba-1.5B [arXiv:2411.13676]: 32L, d_model 1600, parallel hybrid
heads — 25 attention heads (GQA kv=5, sliding window 1024) alongside a
Mamba SSM branch (state 16) in every layer — plus 128 learnable meta
tokens; d_ff 5504, vocab 32001. SSM state makes long_500k native."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, window=1024, ssm_state=16, ssm_expand=2,
    n_meta_tokens=128,
    notes="parallel attn+mamba heads [arXiv:2411.13676]",
)
