"""The port's Multi-head Latent Attention and the mla family (MiniCPM3)
against the JAX package, on the CPU.

Inputs come from numpy seeds; the JAX package's parameters are carried
across with ``repro_torch.convert`` (the values move bitwise). Tiers:

* ``mla_self_attention``, ``mla_prefill`` (output and latent cache) and
  ``mla_decode_step`` (output and the cache it writes in place) against
  JAX's: f32 within 1e-5 of scale, bf16 within 3e-2;
* the absorbed decode against the decompressed attention: prefill S
  tokens, then decode token S, against a prefill of S + 1 tokens, f32
  within 2e-5 of scale (the tier of ``tests/test_decode_consistency.py``
  is 2e-4);
* the model: ``forward``, ``prefill`` and 8 greedy ``decode_step`` of
  the minicpm3 smoke config in f32 at 1e-4 with the ids equal, in bf16
  at 3e-2 with JAX's ids fed to both; ``loss_fn`` and its gradients in
  f32 (loss 1e-5 relative, each leaf 1e-4 of its scale) and bf16 (loss
  2e-3, each leaf 3e-2 of its scale); no flash-attention call anywhere;
* the tiny preset's slab round (adam_ota, 3 rounds, f32) through
  ``make_slab_round_runner`` against JAX's pallas round on its draws:
  the losses at 1e-5; ``n_params`` as JAX counts it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from _torch_ref import jax_configs, ref_draws, to_np
from repro import configs as jconfigs
from repro.core.fl import make_slab_round_step as j_make_step
from repro.core.slab_state import init_train_state as j_init_state
from repro.launch.train import preset_config as j_preset_config
from repro.models import mla as jmla
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                 run_rounds_slab)
from repro_torch.core.slab import tree_flatten
from repro_torch.core.slab_state import init_train_state
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla
from repro_torch.models.model import build_model

ARCH = "minicpm3-4b"


def _scaled_close(got, want, tier, what=""):
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tier * scale, f"{what}: max err {err} > {tier} x {scale}"


def _tensors(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# --------------------------------------------------------------------------
# the attention module
# --------------------------------------------------------------------------

CFG = dict(d_model=64, n_heads=4, q_lora_rank=48, kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)


def _module(dtype, s=12, seed=0):
    jcfg, tcfg = jmla.MLAConfig(**CFG), tmla.MLAConfig(**CFG)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jmla.mla_init(jax.random.key(seed), jcfg, jdt)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, s, CFG["d_model"])).astype(np.float32)
    return (jcfg, tcfg, jp, _tensors(jp), jnp.asarray(x).astype(jdt),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_self_attention_and_prefill_match_jax(dtype):
    jcfg, tcfg, jp, tp, jx, tx = _module(dtype)
    tier = 1e-5 if dtype == "float32" else 3e-2
    s = jx.shape[1]
    pos = np.arange(s, dtype=np.int32)
    _scaled_close(tmla.mla_self_attention(tp, tcfg, tx,
                                          torch.from_numpy(pos)),
                  jmla.mla_self_attention(jp, jcfg, jx, jnp.asarray(pos)),
                  tier, "mla_self_attention")
    jy, jc = jmla.mla_prefill(jp, jcfg, jx, jnp.asarray(pos), s + 4)
    ty, tc = tmla.mla_prefill(tp, tcfg, tx, torch.from_numpy(pos), s + 4)
    _scaled_close(ty, jy, tier, "mla_prefill output")
    for key in ("c_kv", "k_pe", "pos"):
        assert str(tc[key].dtype).removeprefix("torch.") == \
            str(np.asarray(jc[key]).dtype)
        _scaled_close(tc[key], jc[key], tier, f"prefill cache {key}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax_and_writes_in_place(dtype):
    jcfg, tcfg, jp, tp, jx, tx = _module(dtype)
    tier = 1e-5 if dtype == "float32" else 3e-2
    s = jx.shape[1]
    pos = np.arange(s, dtype=np.int32)
    _, jc = jmla.mla_prefill(jp, jcfg, jx, jnp.asarray(pos), s + 4)
    _, tc = tmla.mla_prefill(tp, tcfg, tx, torch.from_numpy(pos), s + 4)
    x1 = np.random.default_rng(7).standard_normal(
        (2, 1, CFG["d_model"])).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    for step in range(3):
        jy, jc = jmla.mla_decode_step(jp, jcfg, jnp.asarray(x1).astype(jdt),
                                      jc, jnp.asarray(s + step))
        ty, tc2 = tmla.mla_decode_step(tp, tcfg, torch.from_numpy(x1).to(
            tx.dtype), tc, s + step)
        assert all(tc2[k] is tc[k] for k in tc)     # the same tensors
        _scaled_close(ty, jy, tier, f"decode step {step}")
        for key in ("c_kv", "k_pe", "pos"):
            _scaled_close(tc[key], jc[key], tier, f"decoded cache {key}")


def test_a_position_past_the_cache_writes_the_last_slot():
    """JAX's dynamic_update_slice clamps the start to the last slot; so
    does the port."""
    jcfg, tcfg, jp, tp, jx, tx = _module("float32", s=4)
    pos = np.arange(4, dtype=np.int32)
    _, jc = jmla.mla_prefill(jp, jcfg, jx, jnp.asarray(pos), 6)
    _, tc = tmla.mla_prefill(tp, tcfg, tx, torch.from_numpy(pos), 6)
    x1 = np.ones((2, 1, CFG["d_model"]), np.float32)
    jy, jc = jmla.mla_decode_step(jp, jcfg, jnp.asarray(x1), jc,
                                  jnp.asarray(9))
    ty, tc = tmla.mla_decode_step(tp, tcfg, torch.from_numpy(x1), tc, 9)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == \
        [0, 1, 2, 3, -1, 9]
    _scaled_close(ty, jy, 1e-5, "decode past the cache")


def test_a_prompt_longer_than_the_cache_is_refused():
    _, tcfg, _, tp, _, tx = _module("float32", s=8)
    with pytest.raises(ValueError, match="does not fit"):
        tmla.mla_prefill(tp, tcfg, tx, torch.arange(8), 4)


def test_absorbed_decode_agrees_with_the_decompressed_prefill():
    _, tcfg, _, tp, _, tx = _module("float32", s=10)
    s = 9
    pos = torch.arange(s + 1, dtype=torch.int32)
    want, _ = tmla.mla_prefill(tp, tcfg, tx, pos, s + 1)
    _, cache = tmla.mla_prefill(tp, tcfg, tx[:, :s], pos[:s], s + 1)
    got, _ = tmla.mla_decode_step(tp, tcfg, tx[:, s:], cache, s)
    _scaled_close(got[:, 0], want[:, s], 2e-5, "absorbed vs decompressed")


# --------------------------------------------------------------------------
# the mla family
# --------------------------------------------------------------------------

def _models(dtype, seed=0):
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), param_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH), param_dtype=dtype)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, _tensors(jp)


STEPS = 8


def _no_flash(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the mla family called flash_attention")
    monkeypatch.setattr(tattn, "flash_attention", refuse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_greedy_decode_match_jax(dtype, monkeypatch):
    _no_flash(monkeypatch)
    jm, tm, jp, tp = _models(dtype)
    cfg = tm.config
    s = 24
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, s))
    tier = 1e-4 if dtype == "float32" else 3e-2
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _scaled_close(tl, jl, tier, "forward logits")
    assert float(taux) == float(jaux) == 0.0

    length = s + STEPS
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        length=length)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        length=length)
    _scaled_close(tl, jl, tier, "prefill logits")
    for key in ("c_kv", "k_pe", "pos"):
        _scaled_close(tc["layers"]["kv"][key], jc["layers"]["kv"][key], tier,
                      f"prefill cache {key}")
    decode = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], -1)
    for i in range(STEPS):
        if dtype == "float32":
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        else:   # feed the JAX ids to both: near-ties may round apart
            ttok = torch.from_numpy(np.array(jtok)).long()
        jl, jc = decode(jp, jc, jtok, jnp.asarray(s + i))
        tl, tc = tm.decode_step(tp, tc, ttok, s + i)
        _scaled_close(tl, jl, tier, f"decode step {i} logits")
        jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], -1)
    for key in ("c_kv", "k_pe", "pos"):
        _scaled_close(tc["layers"]["kv"][key], jc["layers"]["kv"][key], tier,
                      f"decoded cache {key}")


TIERS = {"float32": (1e-5, 1e-4), "bfloat16": (2e-3, 3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(dtype, monkeypatch):
    _no_flash(monkeypatch)
    jm, tm, jp, tp = _models(dtype, seed=3)
    toks = np.random.default_rng(0).integers(0, tm.config.vocab, (2, 40)
                                             ).astype(np.int32)
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, {"tokens":
                                                 jnp.asarray(toks)})
    tg, tl = grad_and_value(tm.loss_fn)(tp, {"tokens":
                                             torch.from_numpy(toks)})
    loss_tol, leaf_tol = TIERS[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(float(tl), float(jl), rtol=loss_tol)
    else:
        assert abs(float(tl) - float(jl)) <= loss_tol
    assert [tuple(a.shape) for a in tree_flatten(tg)[0]] == \
        [tuple(b.shape) for b in jax.tree.leaves(jg)]
    for i, (a, b) in enumerate(zip(tree_flatten(tg)[0],
                                   jax.tree.leaves(jg))):
        _scaled_close(a, b, leaf_tol, f"gradient leaf {i}")


def test_tiny_slab_round_matches_jax_pallas_round():
    n_clients, batch, seq, rounds = 4, 2, 32, 3
    jcfg = dataclasses.replace(j_preset_config(ARCH, "tiny"),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.preset_config(ARCH, "tiny"),
                               param_dtype="float32")
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    params_np = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    rng = np.random.default_rng(4)
    batches = [{"tokens": rng.integers(0, jcfg.vocab, (n_clients, batch, seq)
                                       ).astype(np.int32)}
               for _ in range(rounds)]
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.02, beta2=0.3)
    fl = FLConfig(n_clients=n_clients)
    jch, jad, jfl = jax_configs(ch, ad, fl)
    jstate = j_init_state(jad, jax.tree.map(jnp.asarray, params_np))
    jstep = j_make_step(jmodel.loss_fn, jch, jad, jfl, backend="pallas")
    keys = [jax.random.fold_in(jax.random.key(7), t) for t in range(rounds)]
    draws = [ref_draws(k, ch, jstate.spec, n_clients) for k in keys]
    jlosses = []
    for t in range(rounds):
        jstate, jm = jstep(jstate, keys[t],
                           jax.tree.map(jnp.asarray, batches[t]))
        jlosses.append(float(jm.loss))
    run = make_slab_round_runner(tmodel.loss_fn, ch, ad, fl, device="cpu")
    tstate = init_train_state(ad, params_from_numpy(params_np, "cpu"),
                              device="cpu")
    tstate, hist = run_rounds_slab(run, tstate, draws.__getitem__,
                                   batches.__getitem__, rounds, chunk=2)
    np.testing.assert_allclose([h["loss"] for h in hist], jlosses,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(tstate.w), np.asarray(jstate.w),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("preset,n_layers", [("tiny", None), ("full", None),
                                             ("full", 8)])
def test_n_params_is_the_jax_packages(preset, n_layers):
    cfg = tconfigs.preset_config(ARCH, preset)
    jcfg = j_preset_config(ARCH, preset)
    if n_layers:            # run (c) of chip_smoke.py: 877 M parameters
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    assert cfg.n_params() == jcfg.n_params()


def test_the_clis_serve_and_train_the_family_on_the_cpu(capsys,
                                                         monkeypatch):
    from repro_torch.launch import serve, train
    _no_flash(monkeypatch)
    r = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "16", "--gen", "4"])
    assert tuple(r["ids"].shape) == (2, 4)
    out = train.main(["--arch", ARCH, "--device", "cpu", "--rounds", "2",
                      "--clients", "2", "--seq", "32", "--log-every", "1"])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    text = capsys.readouterr().out
    assert f"arch={ARCH}" in text and "round     2" in text
