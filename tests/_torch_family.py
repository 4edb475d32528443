"""Checks shared by the port's model-family tests (``test_torch_rwkv.py``,
``test_torch_hybrid.py``, ``test_torch_vlm.py``, ``test_torch_encdec.py``):
a smoke config's model in the JAX package and in the port on the same
parameters (carried across bitwise by ``repro_torch.convert``) and the
same numpy-seeded tokens, with the family's extra batch entries
(``family_inputs``: the vlm's ``image_embed``, the encdec's
``audio_embed``) beside them. The vlm's cross-attention gates start at
0, which would keep the cross branch out of every result: ``models``
sets them to ``VLM_GATES`` in the JAX parameters before they are
carried across.

Tiers, those of ``tests/test_torch_moe.py`` and ``tests/test_torch_mla.py``:
f32 1e-4 of scale, bf16 3e-2; the loss 1e-5 relative in f32 and 2e-3
absolute in bf16, each gradient leaf 1e-4 (f32) or 3e-2 (bf16) of its
scale; the tiny slab round's losses at 1e-5 and its state slabs at the
f32-wire tiers of ``tests/test_torch_lm_train.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import grad_and_value

from _torch_ref import jax_configs, ref_draws, to_np
from repro import configs as jconfigs
from repro.core.fl import make_slab_round_step as j_make_step
from repro.core.slab_state import init_train_state as j_init_state
from repro.launch.train import preset_config as j_preset_config
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
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import build_model

TIER = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TIERS = {"float32": (1e-5, 1e-4), "bfloat16": (2e-3, 3e-2)}
SLAB_SHARE, SLAB_WORST = 1e-4, 1e-4
# bf16 gradients against the f32 one: RWKV's smoke model, measured at
# 4.4e-2 of scale for JAX's and 3.3e-2 for the port's (seed 3)
BF16_VS_F32 = 5e-2
STEPS = 8
VLM_GATES = {"x_gate": 0.7, "x_mlp_gate": -0.4}
# a gradient that is zero in exact arithmetic, against the largest entry
ZERO_TIER = {"float32": 1e-6, "bfloat16": 2 ** -8}


def family_inputs(cfg, lead, seed=9):
    """The batch entries the family needs beside the tokens, numpy, with
    leading dims ``lead``: the encdec's ``audio_embed`` (f32, as the
    serve CLI draws it), the vlm's ``image_embed`` (the parameters'
    dtype, which the model takes as it is); none for the rest."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"audio_embed": rng.standard_normal(
            (*lead, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        x = rng.standard_normal((*lead, cfg.n_img_tokens, cfg.d_model))
        return {"image_embed": np.asarray(jnp.asarray(
            x, jnp.dtype(cfg.param_dtype)))}
    return {}


def jbatch(tokens, extra):
    return {"tokens": jnp.asarray(tokens, jnp.int32),
            **{k: jnp.asarray(v) for k, v in extra.items()}}


def tbatch(tokens, extra):
    return {"tokens": torch.from_numpy(np.asarray(tokens)),
            **tensors(extra)}


def counting_flash(monkeypatch):
    """B5's wrapper in ``models.attention`` wrapped to record each call's
    (Sq, Sk, causal); returns the record."""
    calls = []
    real = tattn.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal", True)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", counted)
    return calls


def open_gates(params):
    """The vlm's cross-attention gates set nonzero (every group alike);
    other families' parameters as they are."""
    blocks = params.get("blocks", {})
    if "x_gate" not in blocks:
        return params
    blocks = {**blocks, **{k: jnp.full_like(blocks[k], v)
                           for k, v in VLM_GATES.items()}}
    return {**params, "blocks": blocks}


def scaled_close(got, want, tier, what=""):
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tier * scale, f"{what}: max err {err} > {tier} x {scale}"


def tensors(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def trees_close(got, want, tier, what):
    """A port tree (dicts of tensors) against a JAX one, leaf by key."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
        for k in want:
            trees_close(got[k], want[k], tier, f"{what}.{k}")
        return
    assert str(got.dtype).removeprefix("torch.") == \
        str(np.asarray(want).dtype), (what, got.dtype, want.dtype)
    scaled_close(got, want, tier, what)


def models(arch, dtype, seed=0, port_init=False, **changes):
    """Both packages' smoke models of ``arch`` in ``dtype`` (and any
    other config ``changes``, e.g. ``remat=True``) and one set of
    parameters, JAX's and the port's copy: JAX's init, or with
    ``port_init`` the port's carried to JAX (the same values; it skips
    JAX's eager init, seconds a model)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), param_dtype=dtype,
                               **changes)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), param_dtype=dtype,
                               **changes)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = (to_jax(tm.init(seed=seed, device="cpu")) if port_init
          else jm.init(jax.random.key(seed)))
    jp = open_gates(jp)
    return jm, tm, jp, tensors(jp)


def to_jax(tree):
    """A port tree (dicts of tensors) as JAX arrays of the same dtypes,
    bitwise (bf16 through its exact f32 values)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    dtype = jnp.dtype(str(tree.dtype).removeprefix("torch."))
    return jnp.asarray(tree.detach().float().numpy()).astype(dtype)


def check_forward_prefill_decode(arch, dtype, s=24):
    """``forward``, ``prefill`` (logits and caches) and STEPS greedy
    ``decode_step`` (logits, the cache written in place) against JAX's;
    in bf16 JAX's ids are fed to both (near-ties may round apart)."""
    jm, tm, jp, tp = models(arch, dtype)
    cfg = tm.config
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, s))
    extra = family_inputs(cfg, (2,))
    tier = TIER[dtype]
    jl, jaux = jm.forward(jp, jbatch(toks, extra))
    tl, taux = tm.forward(tp, tbatch(toks, extra))
    scaled_close(tl, jl, tier, "forward logits")
    assert float(taux) == float(jaux) == 0.0
    length = s + STEPS + cfg.n_meta_tokens
    length = min(length, cfg.window) if cfg.window else length
    jl, jc = jm.prefill(jp, jbatch(toks, extra), length=length)
    tl, tc = tm.prefill(tp, tbatch(toks, extra), length=length)
    scaled_close(tl, jl, tier, "prefill logits")
    trees_close(tc, jc, tier, "prefill cache")
    decode = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], -1)
    held = tree_flatten(tc)[0]
    for i in range(STEPS):
        if dtype == "float32":
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        else:
            ttok = torch.from_numpy(np.array(jtok)).long()
        jl, jc = decode(jp, jc, jtok, jnp.asarray(s + i))
        tl, tc2 = tm.decode_step(tp, tc, ttok, s + i)
        assert all(a is b for a, b in zip(tree_flatten(tc2)[0], held))
        scaled_close(tl, jl, tier, f"decode step {i} logits")
        jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], -1)
    trees_close(tc, jc, tier, "decoded cache")


def _f32_gradient(jm, jp, toks, extra):
    """JAX's f32 gradient of the same (bf16-valued) parameters on the
    same inputs, leaves in order."""
    j32 = j_build_model(dataclasses.replace(jm.config, param_dtype="float32"))
    return jax.tree.leaves(jax.grad(j32.loss_fn)(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp),
        jbatch(toks, {k: np.asarray(v, np.float32)
                      for k, v in extra.items()})))


def check_loss_and_gradients(arch, dtype, s=40, bf16_vs_jax=True,
                             held_to_f32=(), port_init=False, **changes):
    """``loss_fn`` and its gradients against ``jax.value_and_grad``. In
    bf16 with ``bf16_vs_jax=False`` each package's gradient leaves are
    held instead to the f32 gradient of the same (bf16-valued)
    parameters, at BF16_VS_F32 of scale: where the reference's own bf16
    gradient is that far from the f32 one, two bf16 backwards cannot
    meet 3e-2 of each other. In bf16 the leaves whose path ends with one
    of ``held_to_f32`` are held to the f32 gradient too, each at 3e-2 of
    scale or JAX's own bf16 error there, whichever is larger (the vlm's
    gate scalars: each a sum over the whole branch's output, where two
    bf16 backwards part by more). A key bias's gradient (``['wk']
    ['bias']``) is zero in exact arithmetic (a row's softmax does not
    move when every score shifts by q . b): both packages' are held to
    ZERO_TIER of the largest gradient entry instead of to each other's
    rounding noise. ``port_init`` and ``changes`` go to ``models``.
    Returns the port's gradient."""
    jm, tm, jp, tp = models(arch, dtype, seed=3, port_init=port_init,
                            **changes)
    toks = np.random.default_rng(0).integers(0, tm.config.vocab, (2, s)
                                             ).astype(np.int32)
    extra = family_inputs(tm.config, (2,))
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, jbatch(toks, extra))
    tg, tl = grad_and_value(tm.loss_fn)(tp, tbatch(toks, extra))
    loss_tol, leaf_tol = LOSS_TIERS[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(float(tl), float(jl), rtol=loss_tol)
    else:
        assert abs(float(tl) - float(jl)) <= loss_tol
    assert [tuple(a.shape) for a in tree_flatten(tg)[0]] == \
        [tuple(b.shape) for b in jax.tree.leaves(jg)]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    jleaves = jax.tree.leaves(jg)
    want = jleaves
    f32 = (_f32_gradient(jm, jp, toks, extra)
           if dtype == "bfloat16" and (held_to_f32 or not bf16_vs_jax)
           else None)
    if dtype == "bfloat16" and not bf16_vs_jax:
        want = f32
        leaf_tol = BF16_VS_F32
        for i, (a, b) in enumerate(zip(jleaves, want)):
            scaled_close(a, b, leaf_tol, f"JAX's bf16 gradient leaf {i}")
    top = max(float(np.abs(np.asarray(b, np.float32)).max())
              for b in jleaves)
    for i, (path, a, b) in enumerate(zip(paths, tree_flatten(tg)[0], want)):
        what = f"gradient leaf {i} {path}"
        if path.endswith("['wk']['bias']"):
            for side in (a, jleaves[i]):
                assert float(np.abs(to_np(side)).max()) <= \
                    ZERO_TIER[dtype] * top, what
        elif f32 is not None and path.endswith(tuple(held_to_f32)):
            ref = f32[i]
            scale = float(np.abs(np.asarray(ref)).max())
            jax_err = float(np.abs(np.asarray(jleaves[i], np.float32)
                                   - np.asarray(ref)).max()) / scale
            scaled_close(a, ref, max(TIER[dtype], jax_err), what)
        else:
            scaled_close(a, b, leaf_tol, what)
    return tg


def check_tiny_slab_round(arch, rounds=3):
    """``rounds`` slab rounds of the tiny preset in f32 (adam_ota, f32
    wire) from one state on JAX's pallas round and on the port's runner
    on JAX's draws: the losses at 1e-5, every state slab within
    1e-5 + 1e-5 |x| on all but SLAB_SHARE of its entries, within
    SLAB_WORST on all and its mean error under 1e-6."""
    n_clients, batch, seq = 4, 2, 32
    jcfg = dataclasses.replace(j_preset_config(arch, "tiny"),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.preset_config(arch, "tiny"),
                               param_dtype="float32")
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    params_np = jax.tree.map(np.asarray,
                             open_gates(jmodel.init(jax.random.key(0))))
    rng = np.random.default_rng(4)
    batches = [{"tokens": rng.integers(0, jcfg.vocab, (n_clients, batch, seq)
                                       ).astype(np.int32),
                **family_inputs(jcfg, (n_clients, batch), seed=10 + t)}
               for t in range(rounds)]
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
    tbatches = [params_from_numpy(b, "cpu") for b in batches]
    tstate, hist = run_rounds_slab(run, tstate, draws.__getitem__,
                                   tbatches.__getitem__, rounds, chunk=2)
    np.testing.assert_allclose([h["loss"] for h in hist], jlosses,
                               rtol=1e-5, atol=1e-5)
    assert int(tstate.step) == int(jstate.step) == rounds
    slabs = [("w", tstate.w, jstate.w)]
    slabs += [(f"opt[{i}]", a, b) for i, (a, b) in
              enumerate(zip(tstate.opt, jstate.opt))]
    for what, a, b in slabs:
        diff = np.abs(to_np(a) - to_np(b))
        off = float((diff > 1e-5 + 1e-5 * np.abs(to_np(b))).mean())
        assert off <= SLAB_SHARE, (what, off)
        assert float(diff.max()) <= SLAB_WORST, (what, float(diff.max()))
        assert float(diff.mean()) <= 1e-6, (what, float(diff.mean()))


def check_n_params(arch, preset, n_layers):
    cfg = tconfigs.preset_config(arch, preset)
    jcfg = j_preset_config(arch, preset)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    assert cfg.n_params() == jcfg.n_params()
    return cfg.n_params()


def check_stack_init_in_place(arch, n_layers, monkeypatch):
    """The values of n per-layer inits in a row, bitwise, and each random
    leaf (the truncated normals, the plain normals and uniforms) drawn
    into its slice of the stack: no leaf of a layer is drawn anywhere
    else."""
    cfg = tconfigs.smoke_config(arch)
    init = {"rwkv": ttfm.rwkv_block, "hybrid": ttfm.hybrid_block,
            "vlm": ttfm.vlm_group,
            "encdec": lambda c: ttfm.encdec_blocks(c)[1]}[cfg.family](cfg)[0]
    drawn = []
    real = tlayers._drawn

    def spy(shape, dtype, gen, draw):
        out = real(shape, dtype, gen, draw)
        drawn.append(out)
        return out

    monkeypatch.setattr(tlayers, "_drawn", spy)
    stacked = ttfm.stack_init(init, torch.Generator().manual_seed(5),
                              n_layers)
    in_stack, drawn[:] = list(drawn), []
    gen = torch.Generator().manual_seed(5)
    leaves = tree_flatten(stacked)[0]
    for i in range(n_layers):
        one = tree_flatten(init(gen))[0]
        assert len(one) == len(leaves)
        for a, b in zip(leaves, one):
            assert a.dtype == b.dtype and tuple(a.shape[1:]) == \
                tuple(b.shape)
            assert torch.equal(a[i], b)
    assert len(in_stack) == len(drawn) > 0
    bases = {s.untyped_storage().data_ptr() for s in leaves}
    assert all(t.untyped_storage().data_ptr() in bases for t in in_stack)
    return {tuple(t.shape) for t in drawn}


def check_clis(arch, capsys):
    from repro_torch.launch import serve, train
    r = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "16", "--gen", "4"])
    assert tuple(r["ids"].shape) == (2, 4)
    out = train.main(["--arch", arch, "--device", "cpu", "--rounds", "2",
                      "--clients", "2", "--seq", "32", "--log-every", "1"])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    text = capsys.readouterr().out
    assert f"arch={arch}" in text and "round     2" in text
