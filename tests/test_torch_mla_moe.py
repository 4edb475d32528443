"""The port's mla_moe family (DeepSeek-V2-Lite: MLA with no query latent
and YaRN, a leading dense layer, MoE layers holding an expert-parallel
share) against the plain float32 reference ``tests/_torch_plain_mla_moe``,
on the CPU at a tiny size. No JAX: the JAX package has no such family.

* the loss and every leaf's gradient under ``vmap(grad_and_value)`` over
  2 clients, f32 parameters, with the same routing on both sides, for
  the whole MoE layer and for a share of 4 of its 8 experts: 1e-5
  of the loss and 2e-5 of each leaf's largest gradient, a sum-order
  margin over the ~1.5e-6 measured; bf16 activations are off by 1e-3 to
  1e-2 and would fail both;
* 4 shares of 2 of 8 experts: their routed parts, with the shared
  experts and the balance loss once, are the uncut layer's;
* the capacity: every token routed to one expert keeps the first C slots
  in arrival order and adds exactly zero for the rest;
* YaRN at DeepSeek-V2-Lite's numbers: the ramp over pairs 10-23, the
  softmax factor 1.589626, the port's frequencies the closed form's;
* ``prefill`` and ``decode_step`` against ``forward``'s logits with a
  capacity that drops nothing;
* the two reference copies (this one, on the tree; the benchmark's, on
  the slab) give the same loss;
* the mla and moe families' trees with the new fields at their
  defaults; the spans ``moe.route``, ``moe.experts``, ``moe.shared``
  under a profiler, in ``vmap(grad)`` too.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import grad_and_value, vmap
from torch.profiler import ProfilerActivity, profile

import _torch_plain_mla_moe as plain
from repro_torch import configs as tconfigs
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import PORT_ONLY_FIELDS, ModelConfig, build_model

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(arch="tiny-mla-moe", family="mla_moe", n_layers=3, d_model=64,
            n_heads=4, n_kv_heads=4, d_ff=96, vocab=97, q_lora_rank=None,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, n_experts=8, top_k=2, n_shared_experts=2,
            expert_d_ff=32, n_dense_layers=1, normalize_topk=False,
            aux_loss_weight=0.001, seq_aux=True, yarn_factor=40.0,
            yarn_original_len=64, yarn_beta_fast=32.0, yarn_beta_slow=1.0,
            yarn_mscale=0.707, yarn_mscale_all_dim=0.707, remat=True,
            param_dtype="float32")


def _tokens(shape, seed=0):
    return torch.randint(0, TINY["vocab"], shape,
                         generator=torch.Generator().manual_seed(seed))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("held,first", [(0, 0), (4, 2)])
def test_loss_and_gradients_match_the_plain_reference(held, first,
                                                      monkeypatch):
    """The whole layer, and the share of experts 2-5 of 8."""
    cfg = ModelConfig(**{**TINY, "experts_held": held,
                         "first_expert": first})
    m = dataclasses.asdict(cfg)
    model = build_model(cfg)
    params = model.init(seed=3, device="cpu")
    toks = _tokens((2, 2, 24))
    grads, losses = vmap(grad_and_value(
        lambda p, t: model.loss_fn(p, {"tokens": t})), in_dims=(None, 0))(
            params, toks)
    routed = []
    route = moe_mod._route

    def recording(p, ecfg, xt):
        out = route(p, ecfg, xt)
        routed.append(out[2])
        return out

    monkeypatch.setattr(moe_mod, "_route", recording)
    for c in range(2):
        routed.clear()
        with torch.no_grad():
            model.loss_fn(params, {"tokens": toks[c]})
        tree = {k: v for k, v in _leaves(params)}
        mine = {k: v.detach().clone().requires_grad_(True)
                for k, v in tree.items()}
        nested: dict = {}
        for path, t in mine.items():
            node = nested
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        ref_ids = []
        ref = plain.loss(nested, toks[c], m, ref_ids)
        ref.backward()
        # the same experts for every token of every MoE layer
        assert len(routed) == len(ref_ids) == 2
        for a, b in zip(routed, ref_ids):
            assert torch.equal(a, b)
        assert float(losses[c]) == pytest.approx(float(ref.detach()), rel=1e-5)
        for path, g in _leaves(grads):
            want = mine[path].grad
            err = float((g[c] - want).abs().max())
            assert err <= 2e-5 * float(want.abs().max()), (path, err)


def _moe_cfg(**kw):
    base = dict(d_model=64, n_experts=8, top_k=2, d_ff=32,
                n_shared_experts=2, normalize_topk=False, seq_aux=True,
                aux_loss_weight=0.001)
    return moe_mod.MoEConfig(**{**base, **kw})


def test_expert_shares_add_up_to_the_whole_layer():
    whole = _moe_cfg()
    gen = torch.Generator().manual_seed(5)
    p = moe_mod.moe_init(gen, whole, torch.float32)
    x = torch.randn((2, 24, 64), generator=gen)
    y_whole, aux_whole = moe_mod.moe_apply(p, whole, x)
    shared = moe_mod.swiglu(p["shared"], x)
    routed = torch.zeros_like(x)
    for first in (0, 2, 4, 6):
        cfg = _moe_cfg(n_held=2, first_expert=first)
        share = {**p, **{k: p[k][first:first + 2]
                         for k in ("gate", "up", "down")}}
        y, aux = moe_mod.moe_apply(share, cfg, x)
        assert torch.equal(aux, aux_whole)      # every share computes it
        routed += y - shared
    err = float((routed + shared - y_whole).abs().max())
    assert err <= 1e-6 * float(y_whole.abs().max())


def test_capacity_keeps_the_first_slots_in_arrival_order():
    """Every token routed to expert 0 (top-1): C = int(T cf / E) slots
    are kept, the first C tokens', and the rest add exactly zero."""
    cfg = _moe_cfg(n_experts=4, top_k=1, n_shared_experts=0)
    p = moe_mod.moe_init(torch.Generator().manual_seed(1), cfg,
                         torch.float32)
    v = torch.rand(64, generator=torch.Generator().manual_seed(2)) + 0.5
    p["router"]["kernel"] = torch.zeros(64, 4)
    p["router"]["kernel"][:, 0] = 10.0 * v
    scale = torch.linspace(1.0, 2.0, 40)
    x = (scale[:, None] * v)[None]                      # (1, 40, 64)
    y, _ = moe_mod.moe_apply(p, cfg, x)
    cap = int(40 * 1 * cfg.capacity_factor / 4)
    assert cap == 12
    gate = torch.softmax(x[0] @ p["router"]["kernel"], -1)[:, 0]
    h = torch.nn.functional.silu(x[0] @ p["gate"][0]) * (x[0] @ p["up"][0])
    want = (h @ p["down"][0]) * gate[:, None]
    torch.testing.assert_close(y[0, :cap], want[:cap], rtol=1e-5, atol=1e-6)
    assert torch.count_nonzero(y[0, cap:]) == 0


def test_yarn_at_the_published_numbers():
    cfg = tconfigs.get_config("deepseek-v2-lite")
    mcfg = cfg.mla_config()
    assert mla_mod.yarn_range(mcfg) == (10, 23)
    m = dataclasses.asdict(cfg)
    low, high, inv, soft = plain.yarn(m)
    assert (low, high) == (10, 23)
    assert soft == pytest.approx(1.589626, abs=1e-6)
    assert mla_mod.softmax_scale(mcfg) * math.sqrt(192) == pytest.approx(
        1.589626, abs=1e-6)
    torch.testing.assert_close(mla_mod.yarn_inv_freq(mcfg, "cpu"), inv,
                               rtol=1e-6, atol=0)
    # below the ramp the plain frequencies, above them divided by 40
    plain_f = 1.0 / 10000.0 ** (torch.arange(0, 64, 2) / 64)
    torch.testing.assert_close(inv[:11], plain_f[:11], rtol=1e-6, atol=0)
    torch.testing.assert_close(inv[23:], plain_f[23:] / 40, rtol=1e-6,
                               atol=0)


def test_prefill_then_decode_match_forward():
    # capacity T k cf / E >= T: no expert can overflow, in the forward
    # (T = 2 x 12) or a decode step (T = 2)
    cfg = ModelConfig(**{**TINY, "capacity_factor": 4.0, "remat": False})
    model = build_model(cfg)
    params = model.init(seed=4, device="cpu")
    toks = _tokens((2, 12), seed=1)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks})
        logits, cache = model.prefill(params, {"tokens": toks[:, :9]}, 12)
        torch.testing.assert_close(logits[:, 0], full[:, 8], rtol=1e-4,
                                   atol=1e-4)
        for pos in range(9, 12):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, pos:pos + 1], pos)
            torch.testing.assert_close(logits[:, 0], full[:, pos],
                                       rtol=1e-4, atol=1e-4)
    assert set(cache) == {"dense_layers", "layers"}


def test_the_two_reference_copies_give_the_same_loss():
    bench = ROOT / "bench" / "ref"
    rr = _load(bench / "round.py", "ref_round_for_test")
    ref = _load(bench / "mla_moe.py", "ref_mla_moe_for_test")
    cfg = ModelConfig(**{**TINY, "experts_held": 4, "first_expert": 2})
    m = dataclasses.asdict(cfg)
    params = build_model(cfg).init(seed=6, device="cpu")
    leaves = rr.flatten_layout(ref.layout(m))
    tree = dict(_leaves(params))
    assert [lf.path for lf in leaves] == list(tree)
    assert [lf.shape for lf in leaves] == [tuple(t.shape)
                                          for t in tree.values()]
    slab = torch.cat([tree[lf.path].reshape(-1).float() for lf in leaves])
    toks = _tokens((2, 24), seed=2)
    a = ref.loss(slab, leaves, toks, m)
    b = plain.loss(params, toks, m)
    assert float(a) == pytest.approx(float(b), rel=1e-6)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_the_jax_families_keep_their_trees(arch):
    """With the port's fields at their defaults, the JAX archs build the
    trees they built before them: one ``blocks`` stack, MLA's query
    latent, an f32 router over experts of width ``d_ff``, no YaRN."""
    cfg = tconfigs.smoke_config(arch)
    for name in PORT_ONLY_FIELDS:
        field = next(f for f in dataclasses.fields(ModelConfig)
                     if f.name == name)
        assert getattr(cfg, name) == field.default, name
    if cfg.family == "encdec":
        return
    with FakeTensorMode():
        params = build_model(cfg).init(seed=0, device="cpu")
    assert set(params) - {"meta_tokens"} == {"embed", "blocks",
                                              "final_norm", "unembed"}
    if cfg.family == "mla":
        assert set(params["blocks"]["attn"]) == {
            "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
        assert cfg.mla_config().yarn is None
    if cfg.family == "moe":
        moe = params["blocks"]["moe"]
        assert moe["router"]["kernel"].dtype == torch.float32
        assert tuple(moe["gate"].shape) == (cfg.n_layers, cfg.n_experts,
                                            cfg.d_model, cfg.d_ff)
        assert cfg.moe_config() == moe_mod.MoEConfig(
            d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
            d_ff=cfg.d_ff, n_shared_experts=cfg.n_shared_experts,
            capacity_factor=cfg.capacity_factor)


def test_the_moe_spans_under_a_profiler():
    cfg = _moe_cfg()
    gen = torch.Generator().manual_seed(7)
    p = moe_mod.moe_init(gen, cfg, torch.float32)
    x = torch.randn((2, 2, 8, 64), generator=gen)

    def loss(pp, xx):
        y, aux = moe_mod.moe_apply(pp, cfg, xx)
        return y.square().mean() + aux

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vmap(grad_and_value(loss), in_dims=(None, 0))(p, x)
    names = {e.name for e in prof.events()}
    assert {"repro.moe.route", "repro.moe.experts",
            "repro.moe.shared"} <= names


def test_the_published_config_and_the_cut():
    cfg = tconfigs.get_config("deepseek-v2-lite")
    assert "deepseek-v2-lite" in tconfigs.PORT_ARCHS
    assert "deepseek-v2-lite" not in tconfigs.ARCHS
    cut = dataclasses.replace(cfg, n_layers=9, experts_held=8, vocab=12800)
    assert cut.n_params() == 936_684_032
    # the 8 held of 64 experts count at 6 / 64 of each token's routing
    expert = 3 * 2048 * 1408
    assert cut.n_params() - cut.n_active_params() == 501_743_616 == \
        8 * 8 * expert - 8 * 6 * 8 * expert // 64
    smoke = tconfigs.smoke_config("deepseek-v2-lite")
    assert (smoke.family, smoke.q_lora_rank, smoke.expert_d_ff,
            smoke.n_dense_layers) == ("mla_moe", None, 64, 1)


def test_the_training_cli_takes_the_port_arch(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "deepseek-v2-lite", "--device", "cpu",
                      "--rounds", "2", "--clients", "2", "--seq", "32",
                      "--log-every", "1"])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert "arch=deepseek-v2-lite" in capsys.readouterr().out
