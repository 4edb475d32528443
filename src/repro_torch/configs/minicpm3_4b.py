"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: 62L, d_model 2560, 40 heads,
Multi-head Latent Attention (q_lora 768, kv_lora 256, nope 64 + rope 32),
d_ff 6400, vocab 73448. Decode caches only the 288-dim latent per token."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="minicpm3-4b", family="mla",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448, q_lora_rank=768, kv_lora_rank=256,
    qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
    notes="MLA [hf:openbmb/MiniCPM3-4B]",
)
