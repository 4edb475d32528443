"""The vlm family (Llama-3.2-Vision-11B) in the port against the JAX
package, on the CPU.

Inputs come from numpy seeds; the JAX package's parameters are carried
across with ``repro_torch.convert``, with the cross-attention gates
``x_gate`` / ``x_mlp_gate`` set to 0.7 / -0.4 first (the init's zeros
would keep the cross branch out of every result). Tiers
(``tests/_torch_family.py``): f32 1e-4 of scale, bf16 3e-2; the loss
1e-5 relative (f32) and 2e-3 absolute (bf16).

* the smoke config (2 groups of 1 gated cross-attention layer + 4 dense
  layers, 16 image tokens): ``forward``, ``prefill`` (logits and the
  caches: the nested ``selfs`` KV caches and ``image_embed``), 8 greedy
  decode steps (the cache written in place), ``loss_fn`` and its
  gradients, every leaf of the cross branch nonzero (the gates' bf16
  gradients held to the f32 one), the tiny preset's 3-round slab
  trajectory with ``image_embed`` in the batch, ``n_params`` (the full
  config, depth 5 and run (f)'s cut), ``stack_init`` of nested stacks
  drawn in place;
* B5's calls: none under ``vmap(grad)``; a prefill makes one a layer,
  causal self-attention and cross-attention over the image tokens, a
  decode step one a group (cross-attention at Sq = 1);
* serving: ``generate`` with the serve CLI's stub ``image_embed``
  against JAX's serve loop (ids equal, f32), the serve CLI on the CPU,
  and the training CLI's refusal by name.
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
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.launch import serve, train
from repro_torch.launch.serve import generate, stub_inputs
from repro_torch.models import attention as tattn
from repro_torch.models.model import build_model

ARCH = "llama-3.2-vision-11b"
DTYPES = ["float32", "bfloat16"]
CROSS = ("x_attn", "x_ln", "x_ln2", "x_mlp", "x_gate", "x_mlp_gate")


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_prefill_and_greedy_decode_match_jax(dtype):
    fam.check_forward_prefill_decode(ARCH, dtype)


def test_the_gates_carry_the_cross_branch():
    """With the gates open the image moves the logits; at the init's
    zero gates it does not (why every model test opens them)."""
    jm, tm, jp, tp = fam.models(ARCH, "float32")
    toks = np.random.default_rng(1).integers(0, tm.config.vocab, (2, 12))
    a, b = (fam.tbatch(toks, fam.family_inputs(tm.config, (2,), seed=s))
            for s in (1, 2))
    assert float((tm.forward(tp, a)[0] - tm.forward(tp, b)[0]).abs().max()) \
        > 1e-3
    shut = fam.tensors(jm.init(jax.random.key(0)))
    torch.testing.assert_close(tm.forward(shut, a)[0], tm.forward(shut, b)[0],
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_gradients_match_jax(dtype, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("loss_fn called flash_attention")
    monkeypatch.setattr(tattn, "flash_attention", refuse)
    tg = fam.check_loss_and_gradients(ARCH, dtype,
                                      held_to_f32=("['x_gate']",
                                                   "['x_mlp_gate']"))
    for key in CROSS:
        for leaf in jax.tree.leaves(tg["blocks"][key]):
            assert bool((leaf.float().abs().sum(
                dim=tuple(range(1, leaf.dim()))) > 0).all()), key


def test_flash_calls_a_prefill_and_a_decode_step(monkeypatch):
    """Training (vmap(grad_and_value(loss_fn))) never calls B5; a prefill
    of S tokens calls it once a layer: a group's cross-attention over the
    image tokens (S x n_img, not causal), then its dense layers' causal
    S x S; a decode step once a group (1 x n_img)."""
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
    batch = {"tokens": toks[0], "image_embed": extra["image_embed"][0]}
    _, cache = model.prefill(params, batch, length=20)
    p, m = cfg.cross_attn_period, cfg.n_img_tokens
    groups = cfg.n_layers // p
    assert calls == ([(16, m, False)] + [(16, 16, True)] * (p - 1)) * groups
    calls.clear()
    model.decode_step(params, cache, toks[0, :, :1], 16)
    assert calls == [(1, m, False)] * groups


def test_tiny_slab_round_matches_jax_pallas_round():
    fam.check_tiny_slab_round(ARCH)


@pytest.mark.parametrize("preset,n_layers,want", [
    ("tiny", None, None), ("full", None, 9_775_157_264),
    ("full", 5, 2_141_237_250)])       # one group
def test_n_params_is_the_jax_packages(preset, n_layers, want):
    n = fam.check_n_params(ARCH, preset, n_layers)
    assert want is None or n == want


def test_n_params_of_the_training_run_cut():
    """chip_smoke.py's run (f): one group of 1 cross + 1 dense layer
    (cross_attn_period 2, 2 layers) at full width."""
    cut = dict(n_layers=2, cross_attn_period=2)
    n = dataclasses.replace(tconfigs.get_config(ARCH), **cut).n_params()
    assert n == dataclasses.replace(jconfigs.get_config(ARCH),
                                    **cut).n_params() == 1_486_901_250


@pytest.mark.parametrize("n_groups", [1, 3])
def test_stack_init_is_per_layer_init_drawn_in_place(n_groups, monkeypatch):
    """Groups of nested stacks: each group's dense layers (``selfs``) are
    drawn into their slice of the (n_groups, n_self, ...) stack, not
    into a stack of their own that is then copied."""
    shapes = fam.check_stack_init_in_place(ARCH, n_groups, monkeypatch)
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
    assert float(tp["blocks"]["x_gate"].abs().max()) == 0.0
    jc, tc = jm.init_cache(3, 40), tm.init_cache(3, 40, device="cpu")
    fam.trees_close(tc, jc, 0.0, "init_cache")


def test_a_batch_without_image_embed_is_refused():
    cfg = tconfigs.smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    for call in (lambda: model.forward(params, {"tokens": toks}),
                 lambda: model.prefill(params, {"tokens": toks}),
                 lambda: model.loss_fn(params, {"tokens": toks})):
        with pytest.raises(ValueError, match="image_embed"):
            call()


def test_generate_with_the_stub_image_matches_jax_serve_loop():
    """The serve CLI's path in f32: ``generate`` with ``stub_inputs``'
    bf16 image_embed against JAX's prefill + jitted decode loop on the
    same weights (gates open), prompt and image: the ids equal, the cache
    within 1e-4 of scale."""
    s, gen = 12, 8
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH),
                               param_dtype="float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = fam.open_gates(jm.init(jax.random.key(0)))
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, s))
    inputs = stub_inputs(tcfg, 2, "cpu")
    img = inputs["image_embed"]
    assert img.dtype == torch.bfloat16
    assert tuple(img.shape) == (2, tcfg.n_img_tokens, tcfg.d_model)
    r = generate(tm, fam.tensors(jp), torch.from_numpy(toks), gen,
                 inputs=inputs)
    batch = fam.jbatch(toks, {"image_embed": np.asarray(jnp.asarray(
        img.float().numpy(), jnp.bfloat16))})
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
    assert "image_embed" in capsys.readouterr().err
