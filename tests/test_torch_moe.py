"""The port's MoE layer, the moe family (Qwen3-MoE, Kimi-K2) and the
layer stack's init, against the JAX package on the CPU.

Inputs come from numpy seeds; the JAX package's parameters are carried
across with ``repro_torch.convert`` (the values move bitwise). Tiers:

* ``_positions_in_expert``: equal, on fixed and hypothesis-drawn ids;
* ``moe_apply`` (output and aux loss) against JAX's on the same weights
  and inputs: f32 within 1e-5 of the output's scale, bf16 within 3e-2;
  with a capacity factor of 0.3 tokens are dropped, and the kept-slot
  mask must equal the one JAX's routing gives; the shared expert (Kimi)
  too; ``moe_apply`` against ``moe_reference_dense`` with nothing
  dropped at 1e-5; the gradients of a loss through ``moe_apply`` under
  ``vmap(grad)`` against ``jax.grad`` at 1e-5 of each leaf's scale;
* the model: ``forward`` (logits and aux), ``prefill`` and 8 greedy
  ``decode_step`` of the qwen3-moe and kimi-k2 smoke configs in f32 at
  1e-4 of scale with the ids equal, in bf16 at 3e-2 with JAX's ids fed
  to both; ``loss_fn`` and its gradients in f32 (loss 1e-5 relative,
  each leaf 1e-4 of its scale) and bf16 (loss 2e-3, each leaf 3e-2 of
  its scale);
* the tiny preset's slab round (adam_ota, 3 rounds, f32) through
  ``make_slab_round_runner`` against JAX's pallas round on its draws:
  the losses at 1e-5, and every state slab (w, Delta, v) within
  1e-5 + 1e-5 |x| on all but 1e-4 of its entries, within 1e-4 on all
  and its mean error under 1e-6, the f32-wire tiers of
  ``tests/test_torch_lm_train.py`` (measured: 1 of
  952,320 entries of Qwen3-MoE's w off the tier, the worst 1.13e-5; the
  worst of v 9.2e-5 at a relative error under 1e-5);
* ``stack_init``: the same values as ``n`` per-layer inits in a row,
  bitwise, for 1 and 3 layers, with every random leaf drawn into its
  slice of the stack (no second copy of a layer).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.func import grad_and_value, vmap

from _torch_ref import jax_configs, ref_draws, to_np
from repro import configs as jconfigs
from repro.core.fl import make_slab_round_step as j_make_step
from repro.core.slab_state import init_train_state as j_init_state
from repro.launch.train import preset_config as j_preset_config
from repro.models import moe as jmoe
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                 run_rounds_slab)
from repro_torch.core.slab import tree_flatten
from repro_torch.core.slab_state import init_train_state
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import build_model

MOE = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"]


def _scaled_close(got, want, tier, what=""):
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tier * scale, f"{what}: max err {err} > {tier} x {scale}"


def _tensors(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# --------------------------------------------------------------------------
# _positions_in_expert
# --------------------------------------------------------------------------

def test_positions_in_expert_fixed_case():
    e = np.array([1, 0, 1, 1, 0, 2], np.int32)
    got = tmoe._positions_in_expert(torch.from_numpy(e).long(), 4)
    assert got.tolist() == [0, 0, 1, 2, 1, 0]
    assert got.tolist() == np.asarray(
        jmoe._positions_in_expert(jnp.asarray(e), 4)).tolist()


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(1, 300),
       e=st.integers(1, 16))
def test_positions_in_expert_equal_jax(seed, n, e):
    ids = np.random.default_rng(seed).integers(0, e, n).astype(np.int32)
    want = np.asarray(jmoe._positions_in_expert(jnp.asarray(ids), e))
    got = tmoe._positions_in_expert(torch.from_numpy(ids).long(), e)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------

def _layer(dtype, seed=0, **kw):
    base = dict(d_model=32, n_experts=4, top_k=2, d_ff=48)
    base.update(kw)
    jcfg, tcfg = jmoe.MoEConfig(**base), tmoe.MoEConfig(**base)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jmoe.moe_init(jax.random.key(seed), jcfg, jdt)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 24, base["d_model"])).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jcfg, tcfg, jp, _tensors(jp), jx, tx


def _jax_keep(jp, jcfg, jx):
    """The kept-slot mask of JAX's moe_apply, from its own primitives."""
    xt = jx.reshape(-1, jcfg.d_model)
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32),
                        jp["router"]["kernel"].astype(jnp.float32))
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)
    e_flat = idx.reshape(-1).astype(jnp.int32)
    pos = jmoe._positions_in_expert(e_flat, jcfg.n_experts)
    t = xt.shape[0]
    cap = max(1, int(t * jcfg.top_k * jcfg.capacity_factor
                     / jcfg.n_experts))
    return np.asarray(e_flat), np.asarray(pos < cap)


MOE_CASES = {
    "capacity-1.25": {},
    "drops-cf0.3": {"capacity_factor": 0.3},
    "shared-expert": {"n_shared_experts": 1},
    "top1-no-renorm": {"top_k": 1, "normalize_topk": False},
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case, dtype):
    jcfg, tcfg, jp, tp, jx, tx = _layer(dtype, aux_loss_weight=0.5,
                                        **MOE_CASES[case])
    jy, jaux = jmoe.moe_apply(jp, jcfg, jx)
    ty, taux = tmoe.moe_apply(tp, tcfg, tx)
    assert ty.dtype == tx.dtype and taux.dtype == torch.float32
    tier = 1e-5 if dtype == "float32" else 3e-2
    _scaled_close(ty, jy, tier, "moe_apply output")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # the routing and the drops are JAX's
    e_flat, keep = _jax_keep(jp, jcfg, jx)
    _, _, idx = tmoe._route(tp, tcfg, tx.reshape(-1, tcfg.d_model))
    t_e, _, t_keep, _, _ = tmoe._slots(tcfg, idx)
    np.testing.assert_array_equal(t_e.numpy(), e_flat)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    if case == "drops-cf0.3":
        assert 0 < int((~keep).sum()) < keep.size   # some, not all, dropped


def test_moe_apply_matches_the_dense_reference_when_nothing_drops():
    _, tcfg, _, tp, _, tx = _layer("float32", capacity_factor=8.0,
                                   n_shared_experts=1)
    y, _ = tmoe.moe_apply(tp, tcfg, tx)
    _scaled_close(y, tmoe.moe_reference_dense(tp, tcfg, tx), 1e-5,
                  "moe_apply vs moe_reference_dense")


# bf16 is not compared: XLA's CPU dot refuses JAX's bf16 oracle
# ("BF16 x BF16 = F32" in its batch-free einsum)
@pytest.mark.parametrize("dtype", ["float32"])
def test_moe_reference_dense_matches_jax(dtype):
    jcfg, tcfg, jp, tp, jx, tx = _layer(dtype, n_shared_experts=1)
    tier = 1e-5 if dtype == "float32" else 3e-2
    _scaled_close(tmoe.moe_reference_dense(tp, tcfg, tx),
                  jmoe.moe_reference_dense(jp, jcfg, jx), tier,
                  "moe_reference_dense")


def test_a_dropped_token_gets_only_the_shared_expert():
    """Capacity 1: every slot past its expert's first arrival is dropped
    and adds nothing (JAX's semantics); a token with all k slots
    dropped gets the shared expert alone."""
    _, tcfg, _, tp, _, tx = _layer("float32", capacity_factor=0.01,
                                   n_shared_experts=1)
    y, _ = tmoe.moe_apply(tp, tcfg, tx)
    _, _, idx = tmoe._route(tp, tcfg, tx.reshape(-1, tcfg.d_model))
    _, _, keep, _, cap = tmoe._slots(tcfg, idx)
    assert cap == 1 and int(keep.sum()) <= tcfg.n_experts
    gone = ~keep.reshape(-1, tcfg.top_k).any(dim=1)
    shared = tlayers.swiglu(tp["shared"], tx).reshape(-1, tcfg.d_model)
    assert int(gone.sum()) > 0
    torch.testing.assert_close(y.reshape(-1, tcfg.d_model)[gone],
                               shared[gone], rtol=0, atol=0)


def test_moe_gradients_under_vmap_match_jax():
    jcfg, tcfg, jp, tp, jx, tx = _layer("float32", aux_loss_weight=0.5,
                                        capacity_factor=0.6,
                                        n_shared_experts=1)
    xs = np.random.default_rng(9).standard_normal(
        (3, 2, 24, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, jcfg, x)
        return jnp.mean(jnp.square(y)) + aux

    def tloss(p, x):
        y, aux = tmoe.moe_apply(p, tcfg, x)
        return torch.mean(torch.square(y)) + aux

    jg, jl = jax.vmap(jax.grad(jloss, has_aux=False), in_axes=(None, 0))(
        jp, jnp.asarray(xs)), jax.vmap(jloss, in_axes=(None, 0))(
        jp, jnp.asarray(xs))
    tg, tl = vmap(grad_and_value(tloss), in_dims=(None, 0))(
        tp, torch.from_numpy(xs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for a, b in zip(tree_flatten(tg)[0], jax.tree.leaves(jg)):
        _scaled_close(a, b, 1e-5, "gradient leaf")


def test_under_transform_reads_functorch_and_defaults_to_the_cast(
        monkeypatch):
    """The private functorch check picks the inference product only
    outside a transform; where torch has no such check the cast-to-f32
    product (correct everywhere) is taken."""
    seen = []
    vmap(lambda x: (seen.append(tmoe._under_transform(x)), x)[1])(
        torch.ones(2, 3))
    assert seen == [True] and not tmoe._under_transform(torch.ones(3))
    monkeypatch.delattr(torch._C._functorch, "is_functorch_wrapped_tensor")
    assert tmoe._under_transform(torch.ones(3))


@pytest.mark.parametrize("arch", MOE)
def test_moe_sharded_flag_computes_the_plain_path(arch):
    """``moe_sharded=True`` builds the same model: the same layer config,
    the same weights and the same forward, as JAX with no mesh set."""
    cfg = dataclasses.replace(tconfigs.smoke_config(arch),
                              param_dtype="float32")
    sharded = dataclasses.replace(cfg, moe_sharded=True)
    assert sharded.moe_config() == cfg.moe_config()
    m, ms = build_model(cfg), build_model(sharded)
    p, ps = m.init(seed=0, device="cpu"), ms.init(seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_flatten(p)[0], tree_flatten(ps)[0]))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 24)))
    (y, aux), (y2, aux2) = (m.forward(p, {"tokens": toks}),
                            ms.forward(ps, {"tokens": toks}))
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


# --------------------------------------------------------------------------
# the moe family
# --------------------------------------------------------------------------

def _models(arch, dtype, seed=0):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), param_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), param_dtype=dtype)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, _tensors(jp)


STEPS = 8


NEAR_TIE = 2.0 ** -6


def _router_margins(monkeypatch):
    """Spy on the port's router: for each call, each token's margin
    between its k-th and (k+1)-th probability. Returns the list the
    calls append to."""
    seen = []
    real = tmoe._route

    def spy(p, cfg, xt):
        out = real(p, cfg, xt)
        srt = torch.sort(out[0], dim=-1, descending=True).values
        seen.append(srt[:, cfg.top_k - 1] - srt[:, cfg.top_k])
        return out

    monkeypatch.setattr(tmoe, "_route", spy)
    return seen


def _rows_close(got, want, tier, ties, what):
    """Row by row (a token's logits) within ``tier`` x the scale of the
    whole output. ``ties`` marks the rows whose token met a near tie in
    the port's router (a margin under NEAR_TIE in some layer): in bf16
    the two libraries round the residual stream at other places, so such
    a token may take another expert. Only those rows may be off, and at
    most an eighth of the rows."""
    got = to_np(got).astype(np.float64).reshape(-1, got.shape[-1])
    want = to_np(want).astype(np.float64).reshape(got.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    off = np.abs(got - want).max(axis=1) > tier * scale
    assert not (off & ~ties).any(), (
        f"{what}: rows {np.flatnonzero(off & ~ties).tolist()} off by more "
        f"than {tier} x {scale} without a near tie")
    assert off.sum() <= len(off) // 8, (what, off.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_prefill_and_greedy_decode_match_jax(arch, dtype,
                                                     monkeypatch):
    jm, tm, jp, tp = _models(arch, dtype)
    cfg = tm.config
    s, b = 24, 2
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (b, s))
    f32 = dtype == "float32"
    tier = 1e-4 if f32 else 3e-2
    margins = _router_margins(monkeypatch)

    def ties(n_rows):
        """Near ties of the router calls since the last reset, a row per
        token of the last n_rows (f32: none may be off)."""
        m = torch.stack(margins).min(dim=0).values[-n_rows:]
        margins.clear()
        return np.zeros(n_rows, bool) if f32 else (m < NEAR_TIE).numpy()

    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _rows_close(tl, jl, tier, ties(b * s), "forward logits")
    if f32:
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    length = s + STEPS
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        length=length)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        length=length)
    # the last position of each prompt
    _rows_close(tl, jl, tier, ties(b * s).reshape(b, s)[:, -1],
                "prefill logits")
    for key in ("k", "v", "pos"):   # layer 0's precede every router
        _scaled_close(tc["layers"]["kv"][key][:1 if not f32 else None],
                      jc["layers"]["kv"][key][:1 if not f32 else None], tier,
                      f"prefill cache {key}")
    decode = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], -1)
    for i in range(STEPS):
        if f32:
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        else:   # feed the JAX ids to both: near-ties may round apart
            ttok = torch.from_numpy(np.array(jtok)).long()
        jl, jc = decode(jp, jc, jtok, jnp.asarray(s + i))
        tl, tc = tm.decode_step(tp, tc, ttok, s + i)
        _rows_close(tl, jl, tier, ties(b), f"decode step {i} logits")
        jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], -1)
    if f32:
        for key in ("k", "v", "pos"):
            _scaled_close(tc["layers"]["kv"][key], jc["layers"]["kv"][key],
                          tier, f"decoded cache {key}")


TIERS = {"float32": (1e-5, 1e-4), "bfloat16": (2e-3, 3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_gradients_match_jax(arch, dtype):
    jm, tm, jp, tp = _models(arch, dtype, seed=3)
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


def _tiny_trajectories(arch, rounds):
    """``rounds`` slab rounds of the tiny preset in f32 (adam_ota, f32
    wire) from one initial state on JAX's pallas round and on the port's
    runner, the port on JAX's draws: (jstate, jlosses, tstate, tlosses)."""
    n_clients, batch, seq = 4, 2, 32
    jcfg = dataclasses.replace(j_preset_config(arch, "tiny"),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.preset_config(arch, "tiny"),
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
    return jstate, jlosses, tstate, [h["loss"] for h in hist]


# The f32-wire tiers of tests/test_torch_lm_train.py for the state slabs:
# the gradients differ in their last bits and Adam-OTA's update divides
# Delta by (v + eps)^(1/alpha), so an entry whose gradient is small
# against its leaf moves by lr times its relative error.
SLAB_SHARE, SLAB_WORST = 1e-4, 1e-4


def _slab_errors(tstate, jstate):
    """For each state slab (w, the optimizer slabs): its share of entries
    off the f32 tier (1e-5 + 1e-5 |x|), its largest and its mean error."""
    slabs = [("w", tstate.w, jstate.w)]
    slabs += [(f"opt[{i}]", a, b) for i, (a, b) in
              enumerate(zip(tstate.opt, jstate.opt))]
    out = {}
    for what, a, b in slabs:
        a, b = to_np(a), to_np(b)
        diff = np.abs(a - b)
        out[what] = (float((diff > 1e-5 + 1e-5 * np.abs(b)).mean()),
                     float(diff.max()), float(diff.mean()))
    return out


@pytest.mark.parametrize("arch", MOE)
def test_tiny_slab_round_matches_jax_pallas_round(arch):
    rounds = 3
    jstate, jlosses, tstate, tlosses = _tiny_trajectories(arch, rounds)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-5)
    assert int(tstate.step) == int(jstate.step) == rounds
    assert len(tstate.opt) == len(jstate.opt) and tstate.ef is None
    for what, (share, worst, mean) in _slab_errors(tstate, jstate).items():
        assert share <= SLAB_SHARE, (what, share)
        assert worst <= SLAB_WORST, (what, worst)
        assert mean <= 1e-6, (what, mean)


@pytest.mark.parametrize("arch", MOE)
def test_n_params_is_the_jax_packages(arch):
    for preset in ("tiny", "full"):
        cfg = tconfigs.preset_config(arch, preset)
        if preset == "full" and arch == "kimi-k2-1t-a32b":
            cfg = dataclasses.replace(cfg, n_layers=1)   # 16 s at 61
        jcfg = dataclasses.replace(j_preset_config(arch, preset),
                                   n_layers=cfg.n_layers)
        assert cfg.n_params() == jcfg.n_params()
        assert cfg.n_active_params() == jcfg.n_active_params()


# --------------------------------------------------------------------------
# stack_init
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("arch", ["qwen3-14b", "starcoder2-15b",
                                  "kimi-k2-1t-a32b", "minicpm3-4b"])
def test_stack_init_is_per_layer_init_drawn_in_place(arch, n_layers,
                                                     monkeypatch):
    """The values of n per-layer inits in a row, bitwise (those the
    stack held before its random leaves were drawn in place), and each
    random leaf a slice of its stack: no leaf of a layer is drawn
    anywhere else (starcoder2's biases and every norm scale are copied
    in, small)."""
    cfg = tconfigs.smoke_config(arch)
    init = {"dense": ttfm.dense_block, "moe": ttfm.moe_block,
            "mla": ttfm.mla_block}[cfg.family](cfg)[0]
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


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_the_clis_serve_and_train_the_family_on_the_cpu(arch, capsys):
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
