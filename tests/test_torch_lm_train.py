"""The port's language-model training path against the JAX package, on
the CPU.

Inputs come from numpy seeds; the JAX package's parameters are carried
across with ``repro_torch.convert`` (the same layout, the values move
bitwise). Tiers:

* ``softmax_xent``: 1e-6 relative (f32 logsumexp and sums in another
  library's order);
* ``loss_fn`` and its gradients (``torch.func.grad_and_value`` against
  ``jax.value_and_grad``) on the qwen3-14b, qwen2.5-14b and
  starcoder2-15b smoke configs, 2 x 80 tokens (past starcoder2's smoke
  window of 64): in f32 the loss at 1e-5 relative and every gradient
  leaf at 1e-5 of its largest entry (measured worst 1.9e-6); in bf16 (the
  configs' own dtype) the loss at 2e-3 and every leaf at 2^-4 of its
  largest entry, the measured worst 2.9e-2 (a few bf16 steps: the two
  libraries round the bf16 matmuls and their transposes at other
  places), and the mean error at 2^-8 of it;
* the slab round of the ``tiny`` preset in f32 through
  ``make_slab_round_runner(model.loss_fn)``, adam_ota, 3 rounds on the
  JAX round's own draws, against ``make_slab_round_step(backend="pallas")``
  (Pallas interpret mode). The losses at 1e-5 (the trajectory tier of
  ``tests/test_backend_parity.py``; measured 9.5e-7). The gradients
  differ in their last bits (1.9e-6 of scale, above), and Adam-OTA's
  update divides Delta by (v + eps)^(1/alpha), so a coordinate whose
  gradient is small against its leaf moves by lr times its relative
  error. So every state slab is held to 1e-5 on all but a share of its
  entries, to a bound on all, and to a mean error under 1e-6: on the
  f32 wire all but 1e-4 (measured 2 of 361,472 entries of w, the worst
  1.22e-5) and 1e-4 everywhere; on int8 + error feedback all but 1e-3
  (measured 116 of ef's entries: where a sum sits within an ulp of a
  rounding boundary the two sides round one step apart,
  ``kernels/ref.py``'s contract) and 2 lr R everywhere, the most a
  normalised update moves an entry in R rounds (measured 9.9e-5 on w,
  3.7e-4 on ef).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from _torch_ref import jax_configs, ref_draws, to_np
from repro import configs as jconfigs
from repro.core.fl import make_slab_round_step as j_make_step
from repro.core.slab_state import init_train_state as j_init_state
from repro.launch.train import preset_config as j_preset_config
from repro.models.layers import softmax_xent as j_softmax_xent
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                 make_slab_round_step, run_rounds_slab)
from repro_torch.core.slab import tree_flatten
from repro_torch.core.slab_state import init_train_state
from repro_torch.models import attention as tattn
from repro_torch.models.layers import softmax_xent
from repro_torch.models.model import build_model

DENSE = ["qwen3-14b", "qwen2.5-14b", "starcoder2-15b"]


# --------------------------------------------------------------------------
# softmax_xent
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("mask", [False, True])
def test_softmax_xent_matches_jax(weights, mask):
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.standard_normal((3, 7, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    w = rng.uniform(0.2, 2.0, (3,)).astype(np.float32) if weights else None
    m = (rng.random((3, 7)) < 0.6).astype(np.float32) if mask else None

    def t(x):
        return None if x is None else torch.from_numpy(x)

    def j(x):
        return None if x is None else jnp.asarray(x)

    want = j_softmax_xent(j(logits), j(labels), j(w), j(m))
    got = softmax_xent(t(logits), t(labels), t(w), t(m))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_softmax_xent_bf16_logits_and_an_empty_mask():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 9)).astype(np.float32)
    labels = rng.integers(0, 9, (2, 5)).astype(np.int32)
    bf = torch.from_numpy(logits).bfloat16()
    want = j_softmax_xent(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(labels))
    got = softmax_xent(bf, torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # no valid token: the count clamps at 1, the loss is 0
    zero = softmax_xent(bf, torch.from_numpy(labels),
                        mask=torch.zeros(2, 5))
    assert float(zero) == 0.0


# --------------------------------------------------------------------------
# loss_fn and its gradients
# --------------------------------------------------------------------------

def _models(arch, dtype, seed=3):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), param_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), param_dtype=dtype)
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.key(seed))
    return jcfg, jmodel, tmodel, jp, params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _grad_errors(tg, jg):
    """Per leaf: (max |diff|, mean |diff|) over the leaf's largest |entry|."""
    out = []
    for a, b in zip(tree_flatten(tg)[0], jax.tree.leaves(jg)):
        a, b = to_np(a), to_np(b)
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        diff = np.abs(a - b)
        out.append((float(diff.max()) / scale, float(diff.mean()) / scale))
    return out


TIERS = {"float32": (1e-5, 1e-5, 1e-5), "bfloat16": (2e-3, 2 ** -4, 2 ** -8)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradients_match_jax(arch, dtype):
    jcfg, jmodel, tmodel, jp, tp = _models(arch, dtype)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 80)
                                             ).astype(np.int32)
    jl, jg = jax.value_and_grad(jmodel.loss_fn)(jp, {"tokens":
                                                     jnp.asarray(toks)})
    tg, tl = grad_and_value(tmodel.loss_fn)(tp, {"tokens":
                                                 torch.from_numpy(toks)})
    loss_tol, max_tol, mean_tol = TIERS[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(float(tl), float(jl), rtol=loss_tol)
    else:
        assert abs(float(tl) - float(jl)) <= loss_tol
    assert [tuple(a.shape) for a in tree_flatten(tg)[0]] == \
        [tuple(b.shape) for b in jax.tree.leaves(jg)]
    for i, (worst, mean) in enumerate(_grad_errors(tg, jg)):
        assert worst <= max_tol and mean <= mean_tol, (i, worst, mean)


def test_weighted_masked_loss_matches_jax():
    jcfg, jmodel, tmodel, jp, tp = _models("qwen3-14b", "float32")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (3, 24)).astype(np.int32)
    w = rng.uniform(0.3, 1.7, (3,)).astype(np.float32)
    mask = (rng.random((3, 23)) < 0.7).astype(np.float32)
    jl, jg = jax.value_and_grad(jmodel.loss_fn)(
        jp, {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)},
        jnp.asarray(w))
    tg, tl = grad_and_value(tmodel.loss_fn)(
        tp, {"tokens": torch.from_numpy(toks), "mask": torch.from_numpy(mask)},
        torch.from_numpy(w))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for i, (worst, _) in enumerate(_grad_errors(tg, jg)):
        assert worst <= 1e-5, (i, worst)


def test_loss_fn_is_the_forward_logits_cross_entropy():
    """loss_fn's backbone (plain attention, positions given) computes the
    logits forward computes (the flash kernel's plain version here)."""
    cfg = dataclasses.replace(tconfigs.smoke_config("starcoder2-15b"),
                              param_dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 70)).astype(np.int32))
    logits, aux = model.forward(params, {"tokens": toks})
    want = softmax_xent(logits[:, :-1], toks[:, 1:]) + aux
    got = model.loss_fn(params, {"tokens": toks})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_training_never_calls_the_flash_kernel(monkeypatch):
    """vmap(grad_and_value(loss_fn)), the round's client step, runs the
    plain attention path: the flash kernel, which has no backward, is
    never called (a call would raise here)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the training path called flash_attention")

    cfg = j_preset_config("qwen3-14b", "tiny")
    model = build_model(tconfigs.preset_config("qwen3-14b", "tiny"))
    params = model.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 2, 16)).astype(np.int32))
    monkeypatch.setattr(tattn, "flash_attention", refuse)
    grads, losses = vmap(grad_and_value(model.loss_fn), in_dims=(None, 0))(
        params, {"tokens": toks})
    assert tuple(losses.shape) == (3,)
    assert bool(torch.isfinite(losses).all())
    with pytest.raises(AssertionError, match="called flash_attention"):
        model.forward(params, {"tokens": toks[0]})


def test_flash_kernel_refuses_transformed_inputs():
    """Under vmap or grad the wrapper refuses before it picks a device
    path, so a CPU call fails where the card would."""
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros(2, 1, 8, 4, 16)
    kv = torch.zeros(2, 1, 8, 2, 16)
    with pytest.raises(ValueError, match="torch.func transform"):
        vmap(lambda a, b, c: flash_attention(a, b, c))(q, kv, kv)
    with pytest.raises(ValueError, match="torch.func transform|requires grad"):
        torch.func.grad(lambda a: flash_attention(a, kv[0], kv[0]).sum())(q[0])
    # plain tensors are served as before (the plain version on the CPU)
    assert tuple(flash_attention(q[0], kv[0], kv[0]).shape) == (1, 8, 4, 16)


# --------------------------------------------------------------------------
# The slab round of the tiny preset against JAX's pallas round
# --------------------------------------------------------------------------

N_CLIENTS, BATCH, SEQ, ROUNDS = 4, 2, 32, 3


def _tiny_trajectories(ch):
    jcfg = dataclasses.replace(j_preset_config("qwen3-14b", "tiny"),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.preset_config("qwen3-14b", "tiny"),
                               param_dtype="float32")
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    params_np = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    rng = np.random.default_rng(4)
    batches = [{"tokens": rng.integers(0, jcfg.vocab, (N_CLIENTS, BATCH, SEQ)
                                       ).astype(np.int32)}
               for _ in range(ROUNDS)]
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.02, beta2=0.3)
    fl = FLConfig(n_clients=N_CLIENTS)
    ef = ch.uplink.error_feedback
    jch, jad, jfl = jax_configs(ch, ad, fl)
    jstate = j_init_state(jad, jax.tree.map(jnp.asarray, params_np),
                          error_feedback=ef)
    jstep = j_make_step(jmodel.loss_fn, jch, jad, jfl, backend="pallas")
    keys = [jax.random.fold_in(jax.random.key(7), t) for t in range(ROUNDS)]
    draws = [ref_draws(k, ch, jstate.spec, N_CLIENTS) for k in keys]
    jlosses = []
    for t in range(ROUNDS):
        jstate, jm = jstep(jstate, keys[t],
                           jax.tree.map(jnp.asarray, batches[t]))
        jlosses.append(float(jm.loss))
    run = make_slab_round_runner(tmodel.loss_fn, ch, ad, fl, device="cpu")
    tstate = init_train_state(ad, params_from_numpy(params_np, "cpu"),
                              error_feedback=ef, device="cpu")
    tstate, hist = run_rounds_slab(run, tstate, draws.__getitem__,
                                   batches.__getitem__, ROUNDS, chunk=2)
    return jstate, jlosses, tstate, [h["loss"] for h in hist]


def _assert_slabs(tstate, jstate, share, everywhere):
    """Each state slab (w, the optimizer slabs, ef) within the f32 tier
    (1e-5 + 1e-5 |x|) on all but ``share`` of its entries, within
    ``everywhere`` (absolute) on all, and its mean error under 1e-6."""
    slabs = [("w", tstate.w, jstate.w)]
    slabs += [(f"opt[{i}]", a, b) for i, (a, b) in
              enumerate(zip(tstate.opt, jstate.opt))]
    assert (tstate.ef is None) == (jstate.ef is None)
    if tstate.ef is not None:
        slabs.append(("ef", tstate.ef, jstate.ef))
    for what, a, b in slabs:
        a, b = to_np(a), to_np(b)
        diff = np.abs(a - b)
        off = int((diff > 1e-5 + 1e-5 * np.abs(b)).sum())
        assert off <= share * diff.size, (what, off, diff.size)
        assert float(diff.max()) <= everywhere, (what, float(diff.max()))
        assert float(diff.mean()) <= 1e-6, (what, float(diff.mean()))
    assert int(tstate.step) == int(jstate.step) == ROUNDS


def test_tiny_slab_round_f32_wire_matches_jax_pallas_round():
    jstate, jlosses, tstate, tlosses = _tiny_trajectories(OTAChannelConfig())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-5)
    _assert_slabs(tstate, jstate, share=1e-4, everywhere=1e-4)


def test_tiny_slab_round_int8_ef_matches_jax_pallas_round():
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                              error_feedback=True))
    jstate, jlosses, tstate, tlosses = _tiny_trajectories(ch)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-5)
    _assert_slabs(tstate, jstate, share=1e-3, everywhere=2 * 0.02 * ROUNDS)


@pytest.mark.parametrize("lr", [0.02, 0.002])
def test_100m_width_round_matches_jax(lr):
    """The training CLI's 100m preset at its width (d_model 768, 12 heads
    / 4 kv, d_ff 2048, vocab 8192, qk-norm) cut to one layer, in f32, 2
    clients x batch 2 x seq 32 of the CLI's corpus, adam_ota, 5 rounds on
    the JAX round's draws against ``make_slab_round_step(backend="jnp")``:
    the losses within 1e-4 relative (the trajectory tier of the tiny
    preset above, with the round's gradient differences amplified five
    times over). At the CLI's default lr 0.02 the loss rises in both
    packages (Adam-OTA moves every coordinate by about lr a round); at
    0.002 it falls in both."""
    from repro.models.model import ModelConfig as JModelConfig
    from repro_torch.launch import train
    from repro_torch.models.model import ModelConfig
    fields = dict(arch="100m-1-layer", family="dense", n_layers=1,
                  d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                  vocab=8192, qk_norm=True, remat=False,
                  param_dtype="float32")
    jmodel = j_build_model(JModelConfig(**fields))
    tmodel = build_model(ModelConfig(**fields))
    params_np = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    corpus = train.client_corpus(8192, 32, 2, 2, 0.5, 0)
    batch_fn = train.make_batch_fn(*corpus, batch=2, seq=32, seed=0)
    ch = OTAChannelConfig(xi_scale=0.05)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=lr, beta2=0.3)
    fl = FLConfig(n_clients=2)
    jch, jad, jfl = jax_configs(ch, ad, fl, "jnp")
    jstate = j_init_state(jad, jax.tree.map(jnp.asarray, params_np))
    jstep = j_make_step(jmodel.loss_fn, jch, jad, jfl, backend="jnp")
    tstate = init_train_state(ad, params_from_numpy(params_np, "cpu"),
                              device="cpu")
    tstep = make_slab_round_step(tmodel.loss_fn, ch, ad, fl, device="cpu")
    jlosses, tlosses = [], []
    for t in range(5):
        key = jax.random.fold_in(jax.random.key(1), t)
        tokens = batch_fn(t)["tokens"]
        jstate, jm = jstep(jstate, key, {"tokens": jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, ref_draws(key, ch, jstate.spec, 2),
                           {"tokens": tokens})
        jlosses.append(float(jm.loss))
        tlosses.append(float(tm.loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    rises = lr == 0.02
    for losses in (jlosses, tlosses):
        assert (losses[-1] > losses[0]) == rises, losses
