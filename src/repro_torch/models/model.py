"""Model configuration and end-to-end assembly.

PyTorch counterpart of ``repro.models.model``. ``ModelConfig`` mirrors
the JAX package's field for field. ``build_model(cfg)`` returns a
``Model`` for the dense family (Qwen3, Qwen2.5, StarCoder2):

    init(seed=0, device=None)          -- random parameters on the device
    forward(params, batch)             -- full-sequence logits
    prefill(params, batch, length)     -- last-position logits + caches
    decode_step(params, cache, token, pos) -- one-token serve step
    init_cache(batch, length, device)  -- empty caches

Params are nested dicts with the per-layer parameters stacked on a
leading layer axis, the JAX package's layout. ``decode_step`` updates
the cache in place (``models.attention``). Any other family, and the
training loss ``loss_fn``, raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.slab import tree_map
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import dense, dense_init, embed, embed_init


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                     # dense | mla | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    norm: str = "rmsnorm"
    mlp: str = "swiglu"
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None    # sliding-window attention (ring cache)
    # The JAX package's perf levers, kept as data so the configs match
    # field for field; none changes a result and the port reads none.
    kv_chunk: Optional[int] = None  # online-softmax KV chunking
    window_block: bool = False      # block-local window attention
    remat: bool = True
    scan_unroll: bool = False       # unroll layer scans (cost calibration)
    param_dtype: str = "bfloat16"
    # MLA
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_sharded: bool = False       # shard_map expert-parallel path (perf)
    # SSM / hybrid
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_chunk: int = 0
    # RWKV
    rwkv_lora_rank: int = 64
    rwkv_chunk: int = 64
    # enc-dec (audio) / vlm stubs
    n_enc_layers: int = 0
    enc_seq: int = 1500             # whisper frame embeddings (stub input)
    cross_attn_period: int = 0      # vlm: 1 cross layer every k layers
    n_img_tokens: int = 1601        # vlm patch embeddings (stub input)
    n_meta_tokens: int = 0          # hymba learnable meta tokens
    notes: str = ""

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_config(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta, window=self.window)


class Model(NamedTuple):
    config: ModelConfig
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP A13c); "
            "the port builds the dense family")
    b_init, b_fwd, b_decode, b_cache, b_pfl = tfm.dense_block(cfg)

    def init(seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype),
            "blocks": tfm.stack_init(b_init, gen, cfg.n_layers),
            "final_norm": tfm._norm_init(cfg.norm, cfg.d_model, dev),
            "unembed": dense_init(gen, cfg.d_model, (cfg.vocab,), cfg.dtype),
        }

    def forward(params, batch):
        x = embed(params["embed"], batch["tokens"], cfg.dtype)
        x, aux = tfm.stack_apply(b_fwd, params["blocks"], x,
                                 torch.zeros((), dtype=torch.float32,
                                             device=x.device))
        x = tfm._norm(cfg.norm, params["final_norm"], x)
        return dense(params["unembed"], x), aux

    def loss_fn(params, batch, weights=None):
        raise NotImplementedError(
            "the LM training loss (softmax_xent and an attention backward) "
            "is ROADMAP A13b")

    def init_cache(batch_size: int, length: int, device: DeviceLike = None):
        one = b_cache(batch_size, length, resolve_device(device))
        return {"layers": tree_map(
            lambda a: torch.stack([a] * cfg.n_layers), one)}

    def prefill(params, batch, length=None):
        """Forward over the prompt, collecting the per-layer decode caches.
        Returns (logits of the last position, cache)."""
        tokens = batch["tokens"]
        length = length or tokens.shape[1]
        x = embed(params["embed"], tokens, cfg.dtype)
        x, layers = tfm.stack_prefill(lambda lp, xx: b_pfl(lp, xx, length),
                                      params["blocks"], x)
        x = tfm._norm(cfg.norm, params["final_norm"], x)
        return dense(params["unembed"], x[:, -1:]), {"layers": layers}

    def decode_step(params, cache, token, pos: int):
        """token: (B, 1) integer ids; pos: the absolute position (int).
        Writes the token into ``cache`` and returns (logits, cache)."""
        x = embed(params["embed"], token, cfg.dtype)
        x, layers = tfm.stack_decode(
            lambda lp, ch, xx: b_decode(lp, ch, xx, pos), params["blocks"],
            cache["layers"], x)
        x = tfm._norm(cfg.norm, params["final_norm"], x)
        return dense(params["unembed"], x), {**cache, "layers": layers}

    return Model(cfg, init, forward, loss_fn, prefill, decode_step,
                 init_cache)
