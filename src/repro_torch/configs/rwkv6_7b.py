"""RWKV-6 Finch 7B [arXiv:2404.05892]: 32L, d_model 4096, attention-free
(64 heads of size 64 in the WKV state), d_ff 14336, vocab 65536;
data-dependent decay. O(1)-state decode -> long_500k native."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65536, norm="layernorm", rwkv_lora_rank=64, rwkv_chunk=64,
    notes="Finch data-dependent decay [arXiv:2404.05892]",
)
