"""Kimi-K2 1T-A32B [arXiv:2501.kimi2, paper table]: 61L, d_model 7168,
64 heads (GQA kv=8, head_dim 112), MoE 384 experts top-8 with expert
d_ff 2048 + 1 shared expert, vocab 163840. ~1.04T params, ~32B active.
NOTE: full training state does not fit one 256-chip v5e pod; reported
honestly in EXPERIMENTS.md (the multi-pod run is the realistic one)."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840, n_experts=384, top_k=8, n_shared_experts=1,
    notes="Kimi K2 trillion-param MoE [arXiv:2501.kimi2]",
)
