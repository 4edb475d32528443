"""DeepSeek-V2-Lite [hf:deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434]:
27L, d_model 2048, 16 heads of Multi-head Latent Attention with no query
latent (q_lora_rank null; kv_lora 512, nope 128 + rope 64, v 128), YaRN
rotary scaling (factor 40 over 4096 positions, mscale 0.707); layer 0 a
SwiGLU MLP of 10944, layers 1-26 an MoE of 64 experts of width 1408,
top-6 by softmax with the gates not renormalised, 2 shared experts, the
sequence-wise balance loss at 0.001; vocab 102400, untied head. A port
arch: the JAX package has no such family (``mla_moe``)."""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    arch="deepseek-v2-lite", family="mla_moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102400, q_lora_rank=None, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, expert_d_ff=1408,
    n_dense_layers=1, normalize_topk=False, aux_loss_weight=0.001,
    seq_aux=True, yarn_factor=40.0, yarn_original_len=4096,
    yarn_beta_fast=32.0, yarn_beta_slow=1.0, yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    notes="MLA + 64-expert MoE [hf:deepseek-ai/DeepSeek-V2-Lite]",
)
