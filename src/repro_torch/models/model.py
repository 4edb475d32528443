"""Model configuration and end-to-end assembly.

PyTorch counterpart of ``repro.models.model``. ``ModelConfig`` mirrors
the JAX package's field for field, with ``n_params`` and
``n_active_params``, and adds the fields ``PORT_ONLY_FIELDS`` names,
whose defaults leave every JAX family as it is. ``build_model(cfg)``
returns a ``Model`` for the JAX package's seven families: dense (Qwen3,
Qwen2.5, StarCoder2), moe (Qwen3-MoE, Kimi-K2), mla (MiniCPM3), rwkv
(RWKV-6), hybrid (Hymba), vlm (Llama-3.2-Vision) and encdec (Whisper);
and for the port's mla_moe (DeepSeek-V2-Lite: ``n_dense_layers`` leading
mla layers stacked as ``dense_blocks``, then the MLA + MoE layers as
``blocks``, each layer holding the expert share ``experts_held`` from
``first_expert``):

    init(seed=0, device=None)          -- random parameters on the device
    forward(params, batch)             -- full-sequence logits
    loss_fn(params, batch, weights=None) -- next-token cross-entropy
    prefill(params, batch, length)     -- last-position logits + caches
    decode_step(params, cache, token, pos) -- one-token serve step
    init_cache(batch, length, device)  -- empty caches

Params are nested dicts with the per-layer parameters stacked on a
leading layer axis, the JAX package's layout. ``forward`` and
``prefill`` run attention through the flash-attention kernel (B5),
which has no backward: causal self-attention in the dense, moe, hybrid
and vlm families and in Whisper's decoder, the encoder's bidirectional
self-attention and cross-attention (over the image tokens or the
encoder's output; in ``decode_step`` too, one query row a step).
``loss_fn`` runs the same backbone with its positions given, so
attention takes the masked plain path that ``torch.func``
differentiates (``models.attention``), with the config's ``kv_chunk``
and ``window_block``; with ``remat`` (the published configs' default,
as in the JAX package) every layer of its stacks is recomputed in the
backward, a vlm group as one (``transformer.stack_apply``). MLA
attention is plain torch on every path (``models.mla``); RWKV has no
attention. With ``n_meta_tokens`` (Hymba) the learned meta tokens are
prepended to every sequence and sliced off before the unembedding, and
``decode_step`` shifts its position past them. ``decode_step`` updates
the cache in place. ``loss_fn`` adds the blocks' aux loss (the MoE
load-balance loss); ``forward`` returns it beside the logits.

The vlm family's batches carry ``image_embed`` (B, n_img_tokens, d), the
stubbed vision tower's output, which every group attends over; the
prefill's cache carries it for ``decode_step``. The encdec family's
carry ``audio_embed`` (B, enc_seq, d), the stubbed frontend's frames,
which the encoder turns into ``enc_out`` (cached by the prefill);
Whisper's learned decoder positions are the sinusoidal ones, added at
the embedding, as in the JAX package. A batch without its family's key
raises ``ValueError``. Decode recomputes the cross-attention keys and
values from the cached embeddings every step, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.slab import tree_flatten, tree_map
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import (dense, dense_init, embed, embed_init,
                                       normal, sinusoidal_embed, softmax_xent)
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.rwkv import RWKVConfig
from repro_torch.models.ssm import SSMConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                     # dense | mla | moe | rwkv | hybrid | encdec | vlm | mla_moe
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
    # The training forward's memory levers, as in the JAX package: none
    # changes a result. The two attention levers act on attention with
    # positions (``loss_fn``, decode; ``models.attention``), and
    # ``remat`` recomputes each layer of ``loss_fn``'s stacks in the
    # backward (``transformer.stack_apply``). ``scan_unroll`` is the JAX
    # package's dry-run calibration, kept as data only.
    kv_chunk: Optional[int] = None  # online-softmax KV chunking
    window_block: bool = False      # block-local window attention
    remat: bool = True
    scan_unroll: bool = False       # unroll layer scans (cost calibration)
    param_dtype: str = "bfloat16"
    # MLA
    q_lora_rank: Optional[int] = 768   # None: the direct query projection
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
    # The port's own (PORT_ONLY_FIELDS): DeepSeek-V2's MoE and YaRN.
    expert_d_ff: int = 0            # expert width; 0 -> d_ff
    n_dense_layers: int = 0         # leading dense layers (first_k_dense_replace)
    experts_held: int = 0           # the expert-parallel share; 0 -> all
    first_expert: int = 0           # the share's first expert id
    normalize_topk: bool = True     # renormalise the top-k gates
    aux_loss_weight: float = 0.01   # the load-balance loss's weight
    seq_aux: bool = False           # DeepSeek-V2's sequence-wise balance loss
    yarn_factor: float = 0.0        # YaRN rope scaling; 0 -> plain rotary
    yarn_original_len: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

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
            rope_theta=self.rope_theta, window=self.window,
            kv_chunk=self.kv_chunk, window_block=self.window_block)

    def mla_config(self) -> MLAConfig:
        return MLAConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            q_lora_rank=self.q_lora_rank, kv_lora_rank=self.kv_lora_rank,
            qk_nope_head_dim=self.qk_nope_head_dim,
            qk_rope_head_dim=self.qk_rope_head_dim,
            v_head_dim=self.v_head_dim, rope_theta=self.rope_theta,
            yarn=(None if not self.yarn_factor else
                  (self.yarn_factor, self.yarn_original_len,
                   self.yarn_beta_fast, self.yarn_beta_slow,
                   self.yarn_mscale, self.yarn_mscale_all_dim)))

    def moe_config(self) -> MoEConfig:
        # mla_moe stores its router in the parameters' dtype, as
        # DeepSeek-V2's checkpoint does (the logits are f32 either way)
        return MoEConfig(
            d_model=self.d_model, n_experts=self.n_experts, top_k=self.top_k,
            d_ff=self.expert_d_ff or self.d_ff,
            n_shared_experts=self.n_shared_experts,
            capacity_factor=self.capacity_factor,
            normalize_topk=self.normalize_topk,
            aux_loss_weight=self.aux_loss_weight, seq_aux=self.seq_aux,
            n_held=self.experts_held, first_expert=self.first_expert,
            router_dtype=(self.dtype if self.family == "mla_moe"
                          else torch.float32))

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
        """Active params per token (MoE: top_k + shared of n_experts; of
        an expert share, the held experts' expected part of the top_k,
        top_k * held / n_experts)."""
        if not self.n_experts:
            return self.n_params()
        total = self.n_params()
        # gate/up/down per expert
        expert_block = 3 * self.d_model * (self.expert_d_ff or self.d_ff)
        held = self.experts_held or self.n_experts
        n_moe = self.n_layers - self.n_dense_layers
        moe_total = n_moe * held * expert_block
        moe_active = n_moe * self.top_k * held * expert_block \
            // self.n_experts
        return total - moe_total + moe_active


# The fields the port's ModelConfig adds to the JAX package's, each at a
# default that leaves the JAX families as they are.
PORT_ONLY_FIELDS = ("expert_d_ff", "n_dense_layers", "experts_held",
                    "first_expert", "normalize_topk", "aux_loss_weight",
                    "seq_aux", "yarn_factor", "yarn_original_len",
                    "yarn_beta_fast", "yarn_beta_slow", "yarn_mscale",
                    "yarn_mscale_all_dim")


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
           "hybrid": tfm.hybrid_block, "vlm": tfm.vlm_group,
           "mla_moe": functools.partial(tfm.mla_block, moe=True)}
# the blocks of a family's leading dense layers (``n_dense_layers``)
_DENSE_BLOCKS = {"mla_moe": tfm.mla_block}


def _stacks(cfg: ModelConfig) -> list:
    """The layer stacks in the order they run: (parameters' key, cache's
    key, the block's functions, depth). One stack ``blocks`` unless the
    family leads with ``n_dense_layers`` dense layers (``dense_blocks``)."""
    if cfg.family not in _BLOCKS:
        raise ValueError(f"unknown family {cfg.family}")
    n = (cfg.n_layers // cfg.cross_attn_period if cfg.family == "vlm"
         else cfg.n_layers - cfg.n_dense_layers)
    main = ("blocks", "layers", _BLOCKS[cfg.family](cfg), n)
    if not cfg.n_dense_layers:
        return [main]
    if cfg.family not in _DENSE_BLOCKS:
        raise ValueError(f"the {cfg.family} family has no leading dense "
                         f"layers (n_dense_layers={cfg.n_dense_layers})")
    return [("dense_blocks", "dense_layers",
             _DENSE_BLOCKS[cfg.family](cfg), cfg.n_dense_layers), main]


def _needs(batch: dict, key: str, cfg: ModelConfig) -> torch.Tensor:
    """``batch[key]``, which the family's model cannot run without."""
    if batch.get(key) is None:
        raise ValueError(f"the {cfg.family} family ({cfg.arch}) needs "
                         f"batch[{key!r}]; the batch holds {sorted(batch)}")
    return batch[key]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    stacks = _stacks(cfg)
    vlm = cfg.family == "vlm"

    def init(seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype)}
        for key, _, fns, n in stacks:
            p[key] = tfm.stack_init(fns[0], gen, n)
        p["final_norm"] = tfm._norm_init(cfg.norm, cfg.d_model, dev)
        p["unembed"] = dense_init(gen, cfg.d_model, (cfg.vocab,), cfg.dtype)
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

    def _image(batch):
        return _needs(batch, "image_embed", cfg) if vlm else None

    def _logits(params, batch, positions):
        """Logits and aux loss; ``positions`` given is the training
        forward (attention on the plain path, ``cfg.remat`` honoured)."""
        x = _embed(params, batch["tokens"])
        extras = (_image(batch), positions) if vlm else (positions,)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for key, _, fns, _ in stacks:
            x, aux = tfm.stack_apply(fns[1], params[key], x, aux, extras,
                                     remat=cfg.remat and positions is not None)
        x = tfm._norm(cfg.norm, params["final_norm"], x)
        return dense(params["unembed"], x[:, cfg.n_meta_tokens:]), aux

    def forward(params, batch):
        """Logits over the whole sequence through the flash kernel (no
        backward: inference)."""
        return _logits(params, batch, None)

    def loss_fn(params, batch, weights=None):
        """Next-token cross-entropy plus the blocks' aux loss, as the JAX
        package's ``loss_fn``. Attention gets the positions 0..S-1 and
        takes the plain path, so gradients exist (the flash kernel has
        none)."""
        tokens = batch["tokens"]
        positions = torch.arange(cfg.n_meta_tokens + tokens.shape[-1],
                                 dtype=torch.int32, device=tokens.device)
        logits, aux = _logits(params, batch, positions)
        loss = softmax_xent(logits[:, :-1], tokens[:, 1:], weights,
                            batch.get("mask"))
        return loss + aux

    def init_cache(batch_size: int, length: int, device: DeviceLike = None):
        dev = resolve_device(device)
        cache = {}
        for _, ckey, fns, n in stacks:
            one = fns[3](batch_size, length, dev)
            cache[ckey] = tree_map(lambda a: torch.stack([a] * n), one)
        if vlm:
            cache["image_embed"] = torch.zeros(
                (batch_size, cfg.n_img_tokens, cfg.d_model), dtype=cfg.dtype,
                device=dev)
        return cache

    def prefill(params, batch, length=None):
        """Forward over the prompt, collecting the per-layer decode caches.
        Returns (logits of the last position, cache); a vlm cache carries
        the batch's ``image_embed``."""
        tokens = batch["tokens"]
        length = length or tokens.shape[1]
        x = _embed(params, tokens)
        img = _image(batch)
        cache = {}
        for key, ckey, fns, _ in stacks:
            b_pfl = fns[4]
            pfl = ((lambda lp, xx: b_pfl(lp, xx, length, img)) if vlm else
                   (lambda lp, xx: b_pfl(lp, xx, length)))
            x, cache[ckey] = tfm.stack_prefill(pfl, params[key], x)
        x = tfm._norm(cfg.norm, params["final_norm"],
                      x[:, cfg.n_meta_tokens:])
        if vlm:
            cache["image_embed"] = img
        return dense(params["unembed"], x[:, -1:]), cache

    def decode_step(params, cache, token, pos: int):
        """token: (B, 1) integer ids; pos: the absolute text position
        (int; the meta tokens' offset, if any, is added here). Writes the
        token into ``cache`` and returns (logits, cache)."""
        pos = pos + cfg.n_meta_tokens
        x = embed(params["embed"], token, cfg.dtype)
        img = cache.get("image_embed")
        out = dict(cache)
        for key, ckey, fns, _ in stacks:
            b_decode = fns[2]
            dec = ((lambda lp, ch, xx: b_decode(lp, ch, xx, pos, img)) if vlm
                   else (lambda lp, ch, xx: b_decode(lp, ch, xx, pos)))
            x, out[ckey] = tfm.stack_decode(dec, params[key], cache[ckey], x)
        x = tfm._norm(cfg.norm, params["final_norm"], x)
        return dense(params["unembed"], x), out

    return Model(cfg, init, forward, loss_fn, prefill, decode_step,
                 init_cache)


def _build_encdec(cfg: ModelConfig) -> Model:
    """Whisper (``repro.models.model._build_encdec``): the encoder over
    ``batch["audio_embed"]``, the decoder over the tokens with sinusoidal
    positions and cross-attention over the encoder's output."""
    ((e_init, e_fwd),
     (d_init, d_fwd, d_decode, d_cache, d_pfl)) = tfm.encdec_blocks(cfg)
    n_enc = cfg.n_enc_layers or cfg.n_layers

    def init(seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype),
            "enc_blocks": tfm.stack_init(e_init, gen, n_enc),
            "enc_norm": tfm._norm_init(cfg.norm, cfg.d_model, dev),
            "dec_blocks": tfm.stack_init(d_init, gen, cfg.n_layers),
            "final_norm": tfm._norm_init(cfg.norm, cfg.d_model, dev),
            "unembed": dense_init(gen, cfg.d_model, (cfg.vocab,), cfg.dtype),
        }

    def encode(params, batch, train: bool = False):
        """The encoder stack and ``enc_norm`` over the frames cast to the
        parameters' dtype; ``train`` gives attention its positions (the
        plain path, with a backward) and honours ``cfg.remat``."""
        x = _needs(batch, "audio_embed", cfg).to(cfg.dtype)
        pos = (torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
               if train else None)
        x, _ = tfm.stack_apply(e_fwd, params["enc_blocks"], x, extras=(pos,),
                               remat=cfg.remat and train)
        return tfm._norm(cfg.norm, params["enc_norm"], x)

    def _text(params, tokens, start: int = 0):
        """Token embeddings plus the sinusoidal positions start.., cast."""
        pos = torch.arange(start, start + tokens.shape[1], device=tokens.device)
        pe = sinusoidal_embed(pos, cfg.d_model)
        return embed(params["embed"], tokens, cfg.dtype) + pe[None].to(
            cfg.dtype)

    def _logits(params, batch, train: bool):
        enc = encode(params, batch, train)
        tokens = batch["tokens"]
        pos = (torch.arange(tokens.shape[1], dtype=torch.int32,
                            device=tokens.device) if train else None)
        # the encoder's output is an input of every decoder layer, so
        # under remat its gradient reaches the encoder
        x, aux = tfm.stack_apply(d_fwd, params["dec_blocks"],
                                 _text(params, tokens),
                                 torch.zeros((), dtype=torch.float32,
                                             device=tokens.device),
                                 (enc, pos), remat=cfg.remat and train)
        x = tfm._norm(cfg.norm, params["final_norm"], x)
        return dense(params["unembed"], x), aux

    def forward(params, batch):
        """Logits over the whole sequence, attention through the flash
        kernel (no backward: inference)."""
        return _logits(params, batch, False)

    def loss_fn(params, batch, weights=None):
        """Next-token cross-entropy, attention on the plain path."""
        logits, aux = _logits(params, batch, True)
        loss = softmax_xent(logits[:, :-1], batch["tokens"][:, 1:], weights,
                            batch.get("mask"))
        return loss + aux

    def init_cache(batch_size: int, length: int, device: DeviceLike = None):
        dev = resolve_device(device)
        one = d_cache(batch_size, length, dev)
        return {"layers": tree_map(lambda a: torch.stack([a] * cfg.n_layers),
                                   one),
                "enc_out": torch.zeros((batch_size, cfg.enc_seq, cfg.d_model),
                                       dtype=cfg.dtype, device=dev)}

    def prefill(params, batch, length=None):
        """The encoder, then the decoder over the prompt, collecting its
        caches. Returns (logits of the last position, cache with
        ``enc_out``)."""
        enc = encode(params, batch)
        tokens = batch["tokens"]
        length = length or tokens.shape[1]
        x, layers = tfm.stack_prefill(
            lambda lp, xx: d_pfl(lp, xx, length, enc), params["dec_blocks"],
            _text(params, tokens))
        x = tfm._norm(cfg.norm, params["final_norm"], x)
        return (dense(params["unembed"], x[:, -1:]),
                {"layers": layers, "enc_out": enc})

    def decode_step(params, cache, token, pos: int):
        """token: (B, 1) ids; pos: its position (int). Writes the token
        into ``cache`` and returns (logits, cache)."""
        enc = cache["enc_out"]
        x, layers = tfm.stack_decode(
            lambda lp, ch, xx: d_decode(lp, ch, xx, pos, enc),
            params["dec_blocks"], cache["layers"], _text(params, token, pos))
        x = tfm._norm(cfg.norm, params["final_norm"], x)
        return dense(params["unembed"], x), {**cache, "layers": layers}

    return Model(cfg, init, forward, loss_fn, prefill, decode_step,
                 init_cache)
