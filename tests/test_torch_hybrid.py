"""The port's selective SSM and the hybrid family (Hymba-1.5B) against the
JAX package, on the CPU.

Inputs come from numpy seeds; the JAX package's parameters are carried
across with ``repro_torch.convert`` (the values move bitwise), with the
zero ``conv_bias`` and the dt projection's zero bias redrawn. Tiers:

* ``_causal_depthwise_conv``: f32 within 1e-6 of scale; bf16 within 3e-2
  (the port sums the K products left to right in bf16, as written);
* ``ssm_forward`` with its returned state, at ``ssm_chunk`` 0 (one scan
  over S; the port's sequential scan against JAX's associative one) and
  8 (the blocked form), f32 within 1e-4 of scale, bf16 within 3e-2; three
  ``ssm_decode_step`` from that state (output and the cache written in
  place); the prefill state continued by decode against a forward over
  the whole sequence (f32, 2e-5 of scale);
* the model (``tests/_torch_family.py``): ``forward`` (the meta tokens
  prepended and sliced off), ``prefill`` and 8 greedy decode steps of
  the smoke config (8 meta tokens, window 64), ``loss_fn`` and its
  gradients, the tiny preset's 3-round slab trajectory, ``n_params``,
  ``stack_init`` drawing in place, the two CLIs on the CPU;
* the serve cache length: ``generate`` at a prompt and a length where
  ``s + gen <= window < s + gen + n_meta`` against JAX's serve path
  (``launch/serve.py``: ``length = min(s + gen + n_meta, window)``): the
  cache length, the ids and the last logits (f32, 1e-4 of scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family as fam
from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.launch.serve import generate
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models.model import build_model

ARCH = "hymba-1.5b"


def _module(dtype, chunk=0, s=13):
    kw = dict(d_model=32, d_inner=64, d_state=8, chunk=chunk)
    jcfg, tcfg = jssm.SSMConfig(**kw), tssm.SSMConfig(**kw)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rng = np.random.default_rng(3)
    jp = jssm.ssm_init(jax.random.key(0), jcfg, jdt)
    jp["conv_bias"] = jnp.asarray(0.1 * rng.standard_normal(64), jdt)
    jp["dt_proj"]["bias"] = jnp.asarray(0.1 * rng.standard_normal(64), jdt)
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    return (jcfg, tcfg, jp, fam.tensors(jp), jnp.asarray(x).astype(jdt),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_depthwise_conv_matches_jax(dtype):
    _, _, jp, tp, jx, tx = _module(dtype)
    xi = np.random.default_rng(4).standard_normal((2, 13, 64))
    jxi = jnp.asarray(xi).astype(jx.dtype)
    txi = torch.from_numpy(xi).to(tx.dtype)
    got = tssm._causal_depthwise_conv(txi, tp["conv"], tp["conv_bias"])
    assert got.dtype == tx.dtype
    fam.scaled_close(got, jssm._causal_depthwise_conv(jxi, jp["conv"],
                                                      jp["conv_bias"]),
                     1e-6 if dtype == "float32" else 3e-2, "conv")


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_and_decode_match_jax(dtype, chunk):
    jcfg, tcfg, jp, tp, jx, tx = _module(dtype, chunk)
    tier = fam.TIER[dtype]
    jy, jc = jssm.ssm_forward(jp, jcfg, jx, return_state=True)
    ty, tc = tssm.ssm_forward(tp, tcfg, tx, return_state=True)
    assert ty.dtype == tx.dtype
    fam.scaled_close(ty, jy, tier, "ssm_forward")
    fam.trees_close(tc, jc, tier, "returned state")
    held = dict(tc)
    x1 = np.random.default_rng(5).standard_normal((3, 2, 1, 32))
    for step in range(3):
        jy, jc = jssm.ssm_decode_step(
            jp, jcfg, jnp.asarray(x1[step]).astype(jx.dtype), jc)
        ty, tc = tssm.ssm_decode_step(
            tp, tcfg, torch.from_numpy(x1[step]).to(tx.dtype), tc)
        assert all(tc[k] is held[k] for k in held)
        fam.scaled_close(ty, jy, tier, f"decode step {step}")
        fam.trees_close(tc, jc, tier, f"decode step {step} cache")


@pytest.mark.parametrize("chunk", [0, 8])
def test_prefill_state_continues_decode(chunk):
    _, tcfg, _, tp, _, tx = _module("float32", chunk, s=20)
    want = tssm.ssm_forward(tp, tcfg, tx)
    y, cache = tssm.ssm_forward(tp, tcfg, tx[:, :17], return_state=True)
    got = [y] + [tssm.ssm_decode_step(tp, tcfg, tx[:, t:t + 1], cache)[0]
                 for t in range(17, 20)]
    fam.scaled_close(torch.cat(got, 1), want, 2e-5, "prefill + decode")


def test_a_prompt_shorter_than_the_conv_pads_its_window():
    jcfg, tcfg, jp, tp, jx, tx = _module("float32", s=2)
    _, jc = jssm.ssm_forward(jp, jcfg, jx, return_state=True)
    _, tc = tssm.ssm_forward(tp, tcfg, tx, return_state=True)
    assert tuple(tc["conv"].shape) == (2, 3, 64)
    fam.trees_close(tc, jc, 1e-4, "state")


# --------------------------------------------------------------------------
# the hybrid family
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_greedy_decode_match_jax(dtype):
    fam.check_forward_prefill_decode(ARCH, dtype)


def test_a_prompt_past_the_window_fills_the_ring_with_meta_tokens():
    """8 meta tokens + 70 prompt tokens > the window of 64: the prefill
    keeps the last 64 rows ring-aligned, and decode goes on from there."""
    fam.check_forward_prefill_decode(ARCH, "float32", s=70)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(dtype, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("loss_fn called flash_attention")
    monkeypatch.setattr(tattn, "flash_attention", refuse)
    fam.check_loss_and_gradients(ARCH, dtype)


def test_tiny_slab_round_matches_jax_pallas_round():
    fam.check_tiny_slab_round(ARCH)


@pytest.mark.parametrize("preset,n_layers,want", [
    ("tiny", None, None), ("full", None, 1_662_571_200),
    ("full", 8, 492_600_000)])      # run (e) of chip_smoke.py
def test_n_params_is_the_jax_packages(preset, n_layers, want):
    n = fam.check_n_params(ARCH, preset, n_layers)
    assert want is None or n == want


@pytest.mark.parametrize("n_layers", [1, 3])
def test_stack_init_is_per_layer_init_drawn_in_place(n_layers, monkeypatch):
    shapes = fam.check_stack_init_in_place(ARCH, n_layers, monkeypatch)
    assert (4, 256) in shapes and (256,) in shapes    # conv, dt_bias


def test_the_clis_serve_and_train_the_family_on_the_cpu(capsys):
    fam.check_clis(ARCH, capsys)


def test_the_serve_cache_holds_the_meta_tokens():
    """s + gen = 60 <= window 64 < s + gen + 8 meta tokens: JAX's serve
    path takes the 64-slot cache (a full cache for the 48-row prefill);
    a cache of s + gen = 60 would be a ring whose decode overwrites keys
    the window still shows. Ids, the cache and the last logits against
    JAX's loop as ``repro.launch.serve.main`` runs it."""
    s, gen = 40, 20
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH),
                               param_dtype="float32")
    assert s + gen <= tcfg.window < s + gen + tcfg.n_meta_tokens
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, s))
    r = generate(tm, fam.tensors(jp), torch.from_numpy(toks), gen)
    length = min(s + gen + jcfg.n_meta_tokens, jcfg.window)
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                               length=length)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        logits, cache = decode(jp, cache, tok, jnp.asarray(s + i))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(tok)
    assert r["cache"]["layers"]["kv"]["k"].shape[2] == length == 64
    np.testing.assert_array_equal(r["ids"].numpy(),
                                  np.asarray(jnp.concatenate(out, axis=1)))
    fam.trees_close(r["cache"], cache, 1e-4, "cache")
    tl, _ = tm.decode_step(fam.tensors(jp), r["cache"], r["ids"][:, -1:],
                           s + gen - 1)
    jl, _ = decode(jp, cache, out[-1], jnp.asarray(s + gen - 1))
    fam.scaled_close(tl, jl, 1e-4, "the next logits")
