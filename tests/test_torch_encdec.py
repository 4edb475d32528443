"""The encdec family (Whisper-medium) and cross-attention in the port
against the JAX package, on the CPU.

Inputs come from numpy seeds; the JAX package's parameters are carried
across with ``repro_torch.convert`` (the values move bitwise). Tiers
(``tests/_torch_family.py``): f32 1e-4 of scale, bf16 3e-2; the loss
1e-5 relative (f32) and 2e-3 absolute (bf16).

* ``sinusoidal_embed``: f32 within 1e-6 of scale;
* ``cross_attention`` (Sq != Sk, decode's Sq = 1, qk-norm on and off)
  through the plain path (positions given, the training forward's call)
  and through B5's plain version (positions None, the inference call),
  f32 and bf16; ``attend`` without positions takes Sq != Sk only when
  neither causal nor windowed;
* the encoder stack (bidirectional self-attention, LayerNorm, GeLU MLP,
  qkv biases) on both paths;
* the smoke config's model: ``forward``, ``prefill`` (logits and the
  caches, ``enc_out`` among them), 8 greedy decode steps (the cache
  written in place), ``loss_fn`` and its gradients, the tiny preset's
  3-round slab trajectory with ``audio_embed`` in the batch, ``n_params``,
  ``stack_init`` drawing in place;
* B5's calls: none under ``vmap(grad)``; a prefill makes one a layer of
  the encoder, of the decoder's self-attention and of its
  cross-attention, a decode step one a decoder layer (cross-attention
  at Sq = 1);
* serving: ``generate`` with the serve CLI's stub ``audio_embed`` against
  JAX's serve loop (ids equal, f32), the serve CLI on the CPU, and the
  training CLI's refusal by name.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import _torch_family as fam
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.launch import serve, train
from repro_torch.launch.serve import generate, stub_inputs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import build_model

ARCH = "whisper-medium"
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dim", [128, 1024, 6])
def test_sinusoidal_embed_matches_jax(dim):
    """Within 1e-6 plus two f32 steps of the element's angle pos x freq:
    XLA's f32 ``exp`` on the CPU is one step off the correctly rounded
    frequency on about a tenth of them (torch's is not), and the product
    with the position rounds once more; sin and cos of one angle agree
    to 1e-6."""
    pos = np.concatenate([np.arange(448), [1499, 4095, 32767, 500_000]])
    got = tlayers.sinusoidal_embed(torch.from_numpy(pos), dim)
    want = jlayers.sinusoidal_embed(jnp.asarray(pos, jnp.int32), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(pos), dim)
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    angle = np.tile(pos[:, None] * freqs, 2)
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
    assert (err <= 1e-6 + 2.0 ** -22 * angle).all(), float(err.max())
    assert float(err[:16].max()) <= 1e-6


def _cross_inputs(dtype, sq, sk, qk_norm, seed=0):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              qk_norm=qk_norm, rope=False, causal=False)
    jcfg, tcfg = jattn.AttentionConfig(**kw), tattn.AttentionConfig(**kw)
    jdt = jnp.dtype(dtype)
    jp = jattn.attn_init(jax.random.key(seed), jcfg, jdt)
    if qk_norm:
        rng0 = np.random.default_rng(seed + 7)
        for k in ("q_norm", "k_norm"):
            jp[k] = {"scale": jnp.asarray(
                1 + 0.3 * rng0.standard_normal(16), jnp.float32)}
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, sq, 64))
    kv = rng.standard_normal((2, sk, 64))
    return (jcfg, tcfg, jp, fam.tensors(jp),
            [jnp.asarray(a, jdt) for a in (x, kv)],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, kv)])


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("sq,sk", [(5, 13), (1, 13), (9, 4)])
@pytest.mark.parametrize("path", ["plain", "flash"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax(dtype, path, sq, sk, qk_norm,
                                     monkeypatch):
    jcfg, tcfg, jp, tp, (jx, jkv), (tx, tkv) = _cross_inputs(
        dtype, sq, sk, qk_norm)
    calls = fam.counting_flash(monkeypatch)
    pos = (None if path == "flash" else
           torch.arange(sq, dtype=torch.int32))
    got = tattn.cross_attention(tp, tcfg, tx, tkv, pos)
    want = jattn.cross_attention(jp, jcfg, jx, jkv)
    assert got.dtype == tx.dtype and tuple(got.shape) == (2, sq, 64)
    assert calls == ([(sq, sk, False)] if path == "flash" else [])
    fam.scaled_close(got, want, fam.TIER[dtype], f"cross {path}")


def test_attend_without_positions_takes_other_key_counts_unmasked_only():
    """Sq != Sk without positions: refused for a causal or a windowed
    call (the mask would depend on where the queries sit), served
    unmasked (B5's plain version here), equal to the positioned call."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 2, 8), (1, 6, 1, 8), (1, 6, 1, 8)))
    for causal, window in ((True, None), (False, 3), (True, 3)):
        with pytest.raises(ValueError, match="neither causal nor windowed"):
            tattn.attend(q, k, v, None, None, causal, window)
    got = tattn.attend(q, k, v, None, None, False, None)
    want = tattn.attend(q, k, v, torch.arange(4), torch.arange(6), False,
                        None)
    fam.scaled_close(got, want, 1e-6, "unmasked Sq != Sk")


@pytest.mark.parametrize("path", ["plain", "flash"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_stack_matches_jax(dtype, path, monkeypatch):
    jm, tm, jp, tp = fam.models(ARCH, dtype, seed=2)
    cfg = tm.config
    rng = np.random.default_rng(4)
    # random biases and norm scales: the init's are zeros and ones
    jp = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                  a.dtype)
                      if jax.tree_util.keystr(p).endswith("['bias']") else a),
        jp)
    tp = fam.tensors(jp)
    audio = fam.family_inputs(cfg, (2,))["audio_embed"]
    (_, je_fwd), _ = jtfm.encdec_blocks(jm.config)
    (_, te_fwd), _ = ttfm.encdec_blocks(cfg)
    x, _ = jtfm.stack_apply(je_fwd, jp["enc_blocks"],
                            jnp.asarray(audio).astype(jm.config.dtype),
                            jnp.zeros((), jnp.float32))
    want = jtfm._norm(cfg.norm, jp["enc_norm"], x)
    calls = fam.counting_flash(monkeypatch)
    pos = (None if path == "flash" else
           torch.arange(cfg.enc_seq, dtype=torch.int32))
    y, _ = ttfm.stack_apply(lambda lp, h: te_fwd(lp, h, pos),
                            tp["enc_blocks"],
                            torch.from_numpy(audio).to(cfg.dtype))
    got = ttfm._norm(cfg.norm, tp["enc_norm"], y)
    assert calls == ([(cfg.enc_seq, cfg.enc_seq, False)] * cfg.n_enc_layers
                     if path == "flash" else [])
    fam.scaled_close(got, want, fam.TIER[dtype], "encoder")


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_prefill_and_greedy_decode_match_jax(dtype):
    fam.check_forward_prefill_decode(ARCH, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_gradients_match_jax(dtype, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("loss_fn called flash_attention")
    monkeypatch.setattr(tattn, "flash_attention", refuse)
    fam.check_loss_and_gradients(ARCH, dtype)


def test_flash_calls_a_prefill_and_a_decode_step(monkeypatch):
    """Training (vmap(grad_and_value(loss_fn))) never calls B5; a prefill
    of S tokens calls it once an encoder layer (enc_seq both ways), once
    a decoder layer causal (S x S) and once a decoder layer for
    cross-attention (S x enc_seq); a decode step once a decoder layer
    (1 x enc_seq)."""
    cfg = tconfigs.preset_config(ARCH, "tiny")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 2, 16)).astype(np.int32))
    extra = fam.tensors(fam.family_inputs(cfg, (3, 2)))
    calls = fam.counting_flash(monkeypatch)
    _, losses = vmap(grad_and_value(model.loss_fn), in_dims=(None, 0))(
        params, {"tokens": toks, **extra})
    assert calls == [] and bool(torch.isfinite(losses).all())
    batch = {"tokens": toks[0], "audio_embed": extra["audio_embed"][0]}
    _, cache = model.prefill(params, batch, length=20)
    e, n = cfg.enc_seq, cfg.n_layers
    assert calls == ([(e, e, False)] * cfg.n_enc_layers
                     + [(16, 16, True), (16, e, False)] * n)
    calls.clear()
    model.decode_step(params, cache, toks[0, :, :1], 16)
    assert calls == [(1, e, False)] * n


def test_tiny_slab_round_matches_jax_pallas_round():
    fam.check_tiny_slab_round(ARCH)


@pytest.mark.parametrize("preset,n_layers,want", [
    ("tiny", None, None), ("full", None, 811_579_392)])
def test_n_params_is_the_jax_packages(preset, n_layers, want):
    n = fam.check_n_params(ARCH, preset, n_layers)
    assert want is None or n == want


@pytest.mark.parametrize("n_layers", [1, 3])
def test_stack_init_is_per_layer_init_drawn_in_place(n_layers, monkeypatch):
    shapes = fam.check_stack_init_in_place(ARCH, n_layers, monkeypatch)
    assert (128, 4, 32) in shapes and (128, 256) in shapes


def test_init_and_cache_layouts_match_jax():
    jm, tm, jp, _ = fam.models(ARCH, "bfloat16")
    tp = tm.init(seed=0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [jax.tree_util.keystr(p) for p, _ in tflat] == \
        [jax.tree_util.keystr(p) for p, _ in jflat]
    for (_, a), (_, b) in zip(tflat, jflat):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    jc, tc = jm.init_cache(3, 40), tm.init_cache(3, 40, device="cpu")
    fam.trees_close(tc, jc, 0.0, "init_cache")


def test_a_batch_without_audio_embed_is_refused():
    cfg = tconfigs.smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    for call in (lambda: model.forward(params, {"tokens": toks}),
                 lambda: model.prefill(params, {"tokens": toks}),
                 lambda: model.loss_fn(params, {"tokens": toks})):
        with pytest.raises(ValueError, match="audio_embed"):
            call()


def test_generate_with_the_stub_frames_matches_jax_serve_loop():
    """The serve CLI's path in f32: ``generate`` with ``stub_inputs``'
    audio_embed against JAX's prefill + jitted decode loop on the same
    weights, prompt and frames: the ids equal, the cache and the next
    logits within 1e-4 of scale."""
    s, gen = 12, 8
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH),
                               param_dtype="float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, s))
    inputs = stub_inputs(tcfg, 2, "cpu")
    assert inputs["audio_embed"].dtype == torch.float32
    assert tuple(inputs["audio_embed"].shape) == (2, tcfg.enc_seq,
                                                  tcfg.d_model)
    r = generate(tm, fam.tensors(jp), torch.from_numpy(toks), gen,
                 inputs=inputs)
    batch = fam.jbatch(toks, {"audio_embed": inputs["audio_embed"].numpy()})
    logits, cache = jm.prefill(jp, batch, length=s + gen)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        logits, cache = decode(jp, cache, tok, jnp.asarray(s + i))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(tok)
    np.testing.assert_array_equal(r["ids"].numpy(),
                                  np.asarray(jnp.concatenate(out, axis=1)))
    fam.trees_close(r["cache"], cache, 1e-4, "cache")


def test_the_serve_cli_serves_and_the_train_cli_refuses_by_name(capsys):
    r = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "16", "--gen", "4"])
    assert tuple(r["ids"].shape) == (2, 4)
    assert f"arch={ARCH}" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", ARCH, "--device", "cpu", "--rounds", "1"])
    assert e.value.code == 2
    assert "audio_embed" in capsys.readouterr().err
