"""Llama-3.2-Vision-11B [hf:meta-llama/Llama-3.2-11B-Vision]: 40L decoder
d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 128256; gated
cross-attention to vision tokens every 5th layer. Vision tower + projector
are a STUB — input spec supplies (B, 1601, 4096) patch embeddings."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, rope_theta=500000.0, cross_attn_period=5,
    n_img_tokens=1601,
    notes="cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision]",
)
