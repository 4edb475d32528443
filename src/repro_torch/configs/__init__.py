"""Architecture registry: one module per assigned architecture.

PyTorch counterpart of ``repro.configs``, with the same modules as data.
``get_config(arch)`` returns the full-size ModelConfig; ``smoke_config``
the reduced same-family variant (2 layers, d_model 128, <= 4 experts)
that the CPU tests run; ``preset_config`` the serve / train CLI presets
(the JAX package keeps it in ``repro.launch.train``). The port builds
every arch's family (``models.model.build_model``). ``ARCHS`` mirrors
the JAX package's list; ``PORT_ARCHS`` are the port's own (a family the
JAX package lacks), which the lookups and the training CLI take too.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.model import ModelConfig

ARCHS: List[str] = [
    "starcoder2-15b",
    "minicpm3-4b",
    "rwkv6-7b",
    "qwen2.5-14b",
    "kimi-k2-1t-a32b",
    "qwen3-14b",
    "whisper-medium",
    "llama-3.2-vision-11b",
    "hymba-1.5b",
    "qwen3-moe-235b-a22b",
]
PORT_ARCHS: List[str] = ["deepseek-v2-lite"]

_MODULES: Dict[str, str] = {
    "starcoder2-15b": "starcoder2_15b",
    "minicpm3-4b": "minicpm3_4b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen2.5-14b": "qwen2_5_14b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-14b": "qwen3_14b",
    "whisper-medium": "whisper_medium",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v2-lite": "deepseek_v2_lite",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; options: "
                       f"{ARCHS + PORT_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model <= 512, <= 4 experts."""
    cfg = get_config(arch)
    updates = dict(
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab=512,
        remat=False,
        enc_seq=24,
        n_enc_layers=2 if cfg.family == "encdec" else 0,
        n_img_tokens=16,
        window=min(cfg.window, 64) if cfg.window else None,
        kv_chunk=None,
    )
    if cfg.family == "rwkv":
        updates["n_heads"] = 4          # head_dim = 32
        updates["rwkv_lora_rank"] = 16
        updates["rwkv_chunk"] = 16
    if cfg.family in ("mla", "mla_moe"):
        updates.update(q_lora_rank=cfg.q_lora_rank and 48, kv_lora_rank=32,
                       qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.n_experts:
        updates.update(n_experts=4, top_k=2)
    if cfg.expert_d_ff:
        updates["expert_d_ff"] = 64
    if cfg.family == "vlm":
        updates["n_layers"] = cfg.cross_attn_period * 2   # 2 groups
    if cfg.n_meta_tokens:
        updates["n_meta_tokens"] = 8
    return dataclasses.replace(cfg, **updates)


def preset_config(arch: str, preset: str) -> ModelConfig:
    """The CLI presets: ``full`` is the published config, ``tiny`` the
    smoke config with a 257-token vocabulary, ``100m`` a ~100M-parameter
    qwen-style dense decoder."""
    if preset == "full":
        return get_config(arch)
    if preset == "tiny":
        return dataclasses.replace(smoke_config(arch), vocab=257)
    if preset == "100m":
        return ModelConfig(
            arch=f"{arch}-100m", family="dense", n_layers=8, d_model=768,
            n_heads=12, n_kv_heads=4, d_ff=2048, vocab=8192, qk_norm=True,
            remat=False)
    raise ValueError(preset)
