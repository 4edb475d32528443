"""StarCoder2-15B [arXiv:2402.19173]: 40L, d_model 6144, 48 heads (GQA
kv=4), d_ff 24576, vocab 49152; LayerNorm + GeLU FFN with biases, RoPE,
native sliding-window attention (w=4096) -> runs long_500k with its own
windowed ring cache."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab=49152, norm="layernorm", mlp="gelu", qkv_bias=True,
    rope_theta=100000.0, window=4096,
    notes="GQA kv=4, RoPE, sliding window 4096 [arXiv:2402.19173]",
)
