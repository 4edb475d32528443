"""Model configuration and end-to-end assembly.

PyTorch counterpart of ``repro.models.model``. ``ModelConfig`` mirrors
the JAX package's field for field, with ``n_params`` and
``n_active_params``. ``build_model(cfg)`` returns a ``Model`` for the
dense (Qwen3, Qwen2.5, StarCoder2), moe (Qwen3-MoE, Kimi-K2), mla
(MiniCPM3), rwkv (RWKV-6) and hybrid (Hymba) families:

    init(seed=0, device=None)          -- random parameters on the device
    forward(params, batch)             -- full-sequence logits
    loss_fn(params, batch, weights=None) -- next-token cross-entropy
    prefill(params, batch, length)     -- last-position logits + caches
    decode_step(params, cache, token, pos) -- one-token serve step
    init_cache(batch, length, device)  -- empty caches

Params are nested dicts with the per-layer parameters stacked on a
leading layer axis, the JAX package's layout. In the dense, moe and
hybrid families ``forward`` and ``prefill`` run attention through the
flash-attention kernel (B5), which has no backward; ``loss_fn`` runs the
same backbone with its positions given, so attention takes the masked
plain path that ``torch.func`` differentiates (``models.attention``).
MLA attention is plain torch on every path (``models.mla``); RWKV has no
attention. With ``n_meta_tokens`` (Hymba) the learned meta tokens are
prepended to every sequence and sliced off before the unembedding, and
``decode_step`` shifts its position past them. ``decode_step`` updates
the cache in place. ``loss_fn`` adds the blocks' aux loss (the MoE
load-balance loss); ``forward`` returns it beside the logits. The vlm
and encdec families raise ``NotImplementedError`` naming their ROADMAP
item (A13c.5).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.slab import tree_flatten, tree_map
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import (dense, dense_init, embed, embed_init,
                                       normal, softmax_xent)
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.rwkv import RWKVConfig
from repro_torch.models.ssm import SSMConfig


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
    moe_sharded: bool = False       # JAX's shard_map path; unread here
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

    def mla_config(self) -> MLAConfig:
        return MLAConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            q_lora_rank=self.q_lora_rank, kv_lora_rank=self.kv_lora_rank,
            qk_nope_head_dim=self.qk_nope_head_dim,
            qk_rope_head_dim=self.qk_rope_head_dim,
            v_head_dim=self.v_head_dim, rope_theta=self.rope_theta)

    def moe_config(self) -> MoEConfig:
        return MoEConfig(
            d_model=self.d_model, n_experts=self.n_experts, top_k=self.top_k,
            d_ff=self.d_ff, n_shared_experts=self.n_shared_experts,
            capacity_factor=self.capacity_factor)

    def ssm_config(self) -> SSMConfig:
        return SSMConfig(d_model=self.d_model,
                         d_inner=self.ssm_expand * self.d_model,
                         d_state=self.ssm_state, chunk=self.ssm_chunk)

    def rwkv_config(self) -> RWKVConfig:
        return RWKVConfig(d_model=self.d_model, n_heads=self.n_heads,
                          d_ff=self.d_ff, lora_rank=self.rwkv_lora_rank,
                          chunk=self.rwkv_chunk)

    def n_params(self) -> int:
        """Exact parameter count, from shapes alone: ``init`` runs under
        ``FakeTensorMode`` and allocates nothing (the JAX package's
        ``eval_shape``)."""
        # repro-lint: lazy-import (private module, only for counting)
        from torch._subclasses.fake_tensor import FakeTensorMode
        model = build_model(self)
        with FakeTensorMode():
            params = model.init(seed=0, device="cpu")
            return sum(t.numel() for t in tree_flatten(params)[0])

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared of n_experts)."""
        if not self.n_experts:
            return self.n_params()
        total = self.n_params()
        expert_block = 3 * self.d_model * self.d_ff   # gate/up/down per expert
        moe_total = self.n_layers * self.n_experts * expert_block
        moe_active = self.n_layers * self.top_k * expert_block
        return total - moe_total + moe_active


class Model(NamedTuple):
    config: ModelConfig
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


_BLOCKS = {"dense": tfm.dense_block, "mla": tfm.mla_block,
           "moe": tfm.moe_block, "rwkv": tfm.rwkv_block,
           "hybrid": tfm.hybrid_block}
_UNPORTED = ("vlm", "encdec")


def _block_fns(cfg: ModelConfig) -> tuple:
    if cfg.family in _BLOCKS:
        return _BLOCKS[cfg.family](cfg)
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP A13c.5); "
            f"the port builds the {', '.join(_BLOCKS)} families")
    raise ValueError(f"unknown family {cfg.family}")


def build_model(cfg: ModelConfig) -> Model:
    b_init, b_fwd, b_decode, b_cache, b_pfl = _block_fns(cfg)

    def init(seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype),
            "blocks": tfm.stack_init(b_init, gen, cfg.n_layers),
            "final_norm": tfm._norm_init(cfg.norm, cfg.d_model, dev),
            "unembed": dense_init(gen, cfg.d_model, (cfg.vocab,), cfg.dtype),
        }
        if cfg.n_meta_tokens:
            p["meta_tokens"] = normal(gen, (cfg.n_meta_tokens, cfg.d_model),
                                      0.02, cfg.dtype)
        return p

    def _embed(params, tokens):
        """The token embeddings, after the meta tokens if any."""
        x = embed(params["embed"], tokens, cfg.dtype)
        if cfg.n_meta_tokens:
            meta = params["meta_tokens"][None].expand(
                x.shape[0], *params["meta_tokens"].shape).to(x.dtype)
            x = torch.cat([meta, x], dim=1)
        return x

    def _logits(params, tokens, positions):
        x = _embed(params, tokens)
        x, aux = tfm.stack_apply(lambda lp, h: b_fwd(lp, h, positions),
                                 params["blocks"], x,
                                 torch.zeros((), dtype=torch.float32,
                                             device=x.device))
        x = tfm._norm(cfg.norm, params["final_norm"], x)
        return dense(params["unembed"], x[:, cfg.n_meta_tokens:]), aux

    def forward(params, batch):
        """Logits over the whole sequence through the flash kernel (no
        backward: inference)."""
        return _logits(params, batch["tokens"], None)

    def loss_fn(params, batch, weights=None):
        """Next-token cross-entropy plus the blocks' aux loss, as the JAX
        package's ``loss_fn``. Attention gets the positions 0..S-1 and
        takes the plain path, so gradients exist (the flash kernel has
        none)."""
        tokens = batch["tokens"]
        positions = torch.arange(cfg.n_meta_tokens + tokens.shape[-1],
                                 dtype=torch.int32, device=tokens.device)
        logits, aux = _logits(params, tokens, positions)
        loss = softmax_xent(logits[:, :-1], tokens[:, 1:], weights,
                            batch.get("mask"))
        return loss + aux

    def init_cache(batch_size: int, length: int, device: DeviceLike = None):
        one = b_cache(batch_size, length, resolve_device(device))
        return {"layers": tree_map(
            lambda a: torch.stack([a] * cfg.n_layers), one)}

    def prefill(params, batch, length=None):
        """Forward over the prompt, collecting the per-layer decode caches.
        Returns (logits of the last position, cache)."""
        tokens = batch["tokens"]
        length = length or tokens.shape[1]
        x = _embed(params, tokens)
        x, layers = tfm.stack_prefill(lambda lp, xx: b_pfl(lp, xx, length),
                                      params["blocks"], x)
        x = tfm._norm(cfg.norm, params["final_norm"],
                      x[:, cfg.n_meta_tokens:])
        return dense(params["unembed"], x[:, -1:]), {"layers": layers}

    def decode_step(params, cache, token, pos: int):
        """token: (B, 1) integer ids; pos: the absolute text position
        (int; the meta tokens' offset, if any, is added here). Writes the
        token into ``cache`` and returns (logits, cache)."""
        pos = pos + cfg.n_meta_tokens
        x = embed(params["embed"], token, cfg.dtype)
        x, layers = tfm.stack_decode(
            lambda lp, ch, xx: b_decode(lp, ch, xx, pos), params["blocks"],
            cache["layers"], x)
        x = tfm._norm(cfg.norm, params["final_norm"], x)
        return dense(params["unembed"], x), {**cache, "layers": layers}

    return Model(cfg, init, forward, loss_fn, prefill, decode_step,
                 init_cache)
