"""Whisper-medium [arXiv:2212.04356]: enc-dec, 24+24L, d_model 1024,
16 heads (MHA kv=16), d_ff 4096, vocab 51865; LayerNorm + GeLU, learned
decoder positions. The mel-spectrogram + conv frontend is a STUB — the
input spec supplies precomputed frame embeddings (B, 1500, 1024)."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, norm="layernorm", mlp="gelu", qkv_bias=True,
    enc_seq=1500,
    notes="enc-dec, conv frontend stubbed [arXiv:2212.04356]",
)
