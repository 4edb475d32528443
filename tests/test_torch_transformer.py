"""The port's dense transformer against the JAX package, on the CPU.

Inputs come from numpy seeds; the JAX package's parameters are carried
across with ``repro_torch.convert`` (the layouts are the same, so the
values move bitwise). Tiers:

* layers and ``attend`` in f32: 1e-5 of the output's scale (another
  library's sums and transcendentals); ``attend`` over 0..S-1 (the
  kernel's call) is also held against the JAX package's chunked
  (``kv_chunk``) and block-local (``window_block``) branches, which
  compute the same function, and ``attend`` with other positions
  against the JAX package's plain branch;
* ``prefill`` + 8 greedy ``decode_step`` of the qwen3-14b, qwen2.5-14b
  and starcoder2-15b smoke configs (a starcoder2 prompt of 80 > its
  smoke window of 64, so the ring cache is compared): in f32 the logits
  and caches at 1e-4 of scale and the greedy ids equal; in bf16 (the
  configs' own dtype) 3e-2 of scale, the measured worst being 1.2e-2 (a
  few bf16 ulps: the two libraries round the bf16 matmuls at other
  places), with the JAX package's ids fed to both so the steps stay
  comparable;
* configs field for field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import to_np
from repro import configs as jconfigs
from repro.launch.train import preset_config as j_preset_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import ModelConfig as JModelConfig
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import PORT_ONLY_FIELDS, ModelConfig, build_model

DENSE = ["qwen3-14b", "qwen2.5-14b", "starcoder2-15b"]


def _scaled_close(got, want, tier, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tier * scale, f"{what}: max err {err} > {tier} x {scale}"


def _tensors(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _layer_cases():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    norm = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
            "bias": rng.standard_normal(16).astype(np.float32)}
    dense_p = {"kernel": rng.standard_normal((16, 3, 4)).astype(np.float32),
               "bias": rng.standard_normal((3, 4)).astype(np.float32)}
    mlp = {k: {"kernel": rng.standard_normal(s).astype(np.float32) * 0.3}
           for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                        ("down", (24, 16)))}
    gelu = {k: {"kernel": rng.standard_normal(s).astype(np.float32) * 0.3,
                "bias": rng.standard_normal(s[1:]).astype(np.float32)}
            for k, s in (("up", (16, 24)), ("down", (24, 16)))}
    table = {"table": rng.standard_normal((11, 16)).astype(np.float32)}
    ids = rng.integers(0, 11, (2, 5)).astype(np.int32)
    xr = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 40
    return {
        "rmsnorm": ("rmsnorm", ({"scale": norm["scale"]}, x)),
        "layernorm": ("layernorm", (norm, x)),
        "dense": ("dense", (dense_p, x)),
        "embed": ("embed", (table, ids, "float32")),
        "rope_frequencies": ("rope_frequencies", (64, 1e6)),
        "apply_rope": ("apply_rope", (xr, pos, 1e6)),
        "apply_rope_2d": ("apply_rope", (xr, np.stack([pos, pos + 3]), 1e4)),
        "swiglu": ("swiglu", (mlp, x)),
        "gelu_mlp": ("gelu_mlp", (gelu, x)),
    }


def _to_jax(a):
    if isinstance(a, dict):
        return {k: _to_jax(v) for k, v in a.items()}
    if isinstance(a, np.ndarray):
        return jnp.asarray(a)
    return jnp.float32 if a == "float32" else a


def _to_torch(a):
    if isinstance(a, dict):
        return {k: _to_torch(v) for k, v in a.items()}
    if isinstance(a, np.ndarray):
        t = torch.from_numpy(a.copy())
        return t.long() if a.dtype == np.int32 else t
    return torch.float32 if a == "float32" else a


@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_layers_match_jax(name):
    fn, args = _layer_cases()[name]
    want = getattr(jlayers, fn)(*(_to_jax(a) for a in args))
    got = getattr(tlayers, fn)(*(_to_torch(a) for a in args))
    _scaled_close(got, want, 1e-5, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inits_draw_on_the_generator_device(dtype):
    gen = torch.Generator().manual_seed(3)
    p = tlayers.dense_init(gen, 512, (4, 64), dtype, use_bias=True)
    k = p["kernel"].float()
    assert p["kernel"].dtype == dtype and tuple(k.shape) == (512, 4, 64)
    assert torch.all(p["bias"] == 0) and p["bias"].dtype == dtype
    std = 1 / np.sqrt(512)
    assert float(k.abs().max()) <= 2 * std * (1 + 2 ** -7)
    # the [-2, 2]-truncated unit normal has std 0.8796
    assert abs(float(k.std()) / std - 0.8796) < 0.01
    assert abs(float(k.mean())) < 0.01 * std * 10
    table = tlayers.embed_init(gen, 1000, 64, dtype)["table"].float()
    assert abs(float(table.std()) * 8 - 1) < 0.02
    again = tlayers.dense_init(torch.Generator().manual_seed(3), 512, (4, 64),
                               dtype, use_bias=True)
    assert torch.equal(again["kernel"], p["kernel"])


def test_draws_come_in_pieces(monkeypatch):
    monkeypatch.setattr(tlayers, "DRAW_CHUNK", 1000)
    gen = torch.Generator().manual_seed(0)
    k = tlayers.truncated_normal_init(gen, (64, 70), 1.0, torch.float32)
    assert float(k.std()) > 0.1 and float(k[-1].abs().sum()) > 0


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _attn_inputs(b, sq, sk, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]


ATTEND_CASES = {
    # name: (S, causal, window, kv_chunk, window_block)
    "plain": (40, True, None, None, False),
    "bidirectional": (40, False, None, None, False),
    "window": (40, True, 8, None, False),
    "kv_chunk": (40, True, None, 16, False),            # JAX: _attend_chunked
    "kv_chunk_window": (40, True, 12, 16, False),
    "window_block": (40, True, 8, None, True),          # JAX: _attend_window_blocked
    "window_block_ragged": (45, True, 8, None, True),
}


@pytest.mark.parametrize("name", sorted(ATTEND_CASES))
def test_attend_self_attention_matches_jax(name):
    s, causal, window, chunk, wb = ATTEND_CASES[name]
    q, k, v = _attn_inputs(2, s, s, 4, 2, 16)
    pos = np.arange(s, dtype=np.int32)
    want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                        causal, window, kv_chunk=chunk, window_block=wb)
    before = flash_attention.launches
    got = tattn.attend(*(torch.from_numpy(a) for a in (q, k, v)), None, None,
                       causal, window)
    assert flash_attention.launches == before     # CPU: the plain version
    _scaled_close(got, want, 1e-5, name)


ATTEND_POSITIONS = {
    # name: (q_pos, k_pos) for S = 24
    "offset": (np.arange(24) + 7, np.arange(24) + 7),
    "per_batch": (np.stack([np.arange(24), np.arange(24) + 100]),) * 2,
    "packed": ((np.arange(24) % 10), (np.arange(24) % 10)),
}


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("name", sorted(ATTEND_POSITIONS))
def test_attend_with_positions_matches_jax(name, window):
    q, k, v = _attn_inputs(2, 24, 24, 4, 2, 16, seed=2)
    qp, kp = (a.astype(np.int32) for a in ATTEND_POSITIONS[name])
    want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v, qp, kp)),
                        True, window)
    got = tattn.attend(*(torch.from_numpy(a) for a in (q, k, v, qp, kp)),
                       True, window)
    _scaled_close(got, want, 1e-5, name)


def test_attend_without_positions_is_self_attention_only():
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(1, 4, 6, 2, 1, 8))
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="0..S-1"):
        tattn.attend(q, k, v, None, None, True, None)      # Sq != Sk
    with pytest.raises(ValueError, match="0..S-1"):
        tattn.attend(q, q, q, pos, None, True, None)       # one position None


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("window", [None, 24])
def test_attend_decode_with_key_mask_matches_jax(window, chunk):
    q, k, v = _attn_inputs(2, 1, 40, 4, 2, 16, seed=1)
    cpos = np.where(np.arange(40) < 30, np.arange(40), -1).astype(np.int32)
    qpos = np.array([29], np.int32)
    valid = (cpos >= 0)[None, :]
    want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v, qpos,
                                                   cpos[None, :])),
                        True, window, k_valid=jnp.asarray(valid),
                        kv_chunk=chunk)
    got = tattn.attend(*(torch.from_numpy(a) for a in (q, k, v, qpos,
                                                       cpos[None, :])),
                       True, window, k_valid=torch.from_numpy(valid))
    _scaled_close(got, want, 1e-5)


def test_mask_bias_matches_jax():
    qp = np.arange(5, dtype=np.int32) + 3
    kp = np.arange(9, dtype=np.int32)
    valid = np.arange(9) % 4 != 1
    want = jattn._mask_bias(jnp.asarray(qp), jnp.asarray(kp), True, 4,
                            jnp.asarray(valid))
    got = tattn._mask_bias(torch.from_numpy(qp), torch.from_numpy(kp), True,
                           4, torch.from_numpy(valid))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


# --------------------------------------------------------------------------
# the dense model: prefill + greedy decode
# --------------------------------------------------------------------------

def _models(arch, dtype):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), param_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), param_dtype=dtype)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    return jm, tm, jp, _tensors(jp)


STEPS = 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_greedy_decode_match_jax(arch, dtype):
    jm, tm, jp, tp = _models(arch, dtype)
    cfg = tm.config
    s = 80 if cfg.window else 24     # 80 > starcoder2's smoke window 64
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, s))
    total = s + STEPS
    length = min(total, cfg.window) if cfg.window else total
    tier = 1e-4 if dtype == "float32" else 3e-2

    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        length=length)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        length=length)
    _scaled_close(tl, jl, tier, "prefill logits")
    for key in ("k", "v", "pos"):
        _scaled_close(tc["layers"]["kv"][key], jc["layers"]["kv"][key], tier,
                      f"prefill cache {key}")
    if cfg.window:
        # the ring: slot = pos % window holds the last `window` positions
        pos = tc["layers"]["kv"]["pos"][0]
        assert sorted(pos.tolist()) == list(range(s - length, s))
        assert torch.equal(pos % length, torch.arange(length,
                                                      dtype=pos.dtype))

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
    for key in ("k", "v", "pos"):
        _scaled_close(tc["layers"]["kv"][key], jc["layers"]["kv"][key], tier,
                      f"decoded cache {key}")


def test_prefill_longer_than_a_windowless_cache_is_refused():
    """A prompt of 8 into a cache of 4 with no window: the JAX package's
    dynamic_update_slice refuses the larger update (TypeError); the port
    raises ValueError and never keeps the first 4 keys silently."""
    jm, tm, jp, tp = _models("qwen3-14b", "float32")
    assert tm.config.window is None
    toks = np.random.default_rng(3).integers(0, tm.config.vocab, (1, 8))
    with pytest.raises(TypeError):
        jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, length=4)
    with pytest.raises(ValueError, match="8 tokens .* 4 positions"):
        tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, length=4)


def test_windowed_prefill_into_a_short_cache_builds_the_ring():
    """With a window the same call keeps the last 4 positions, ring-
    aligned (slot = pos % 4), as the JAX package does."""
    jm, tm, jp, tp = _models("starcoder2-15b", "float32")
    assert tm.config.window is not None
    toks = np.random.default_rng(3).integers(0, tm.config.vocab, (1, 8))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        length=4)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, length=4)
    _scaled_close(tl, jl, 1e-4, "prefill logits")
    for key in ("k", "v"):
        _scaled_close(tc["layers"]["kv"][key], jc["layers"]["kv"][key], 1e-4,
                      f"prefill cache {key}")
    pos = tc["layers"]["kv"]["pos"][0]
    np.testing.assert_array_equal(to_np(tc["layers"]["kv"]["pos"]),
                                  np.asarray(jc["layers"]["kv"]["pos"]))
    assert pos.tolist() == [4, 5, 6, 7]


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch):
    jm, tm, jp, tp = _models(arch, "float32")
    toks = np.random.default_rng(2).integers(0, tm.config.vocab, (2, 30))
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _scaled_close(tl, jl, 1e-4, "logits")
    assert float(taux) == float(jaux) == 0.0


def test_init_cache_matches_jax_layout():
    jm, tm, _, _ = _models("starcoder2-15b", "bfloat16")
    jc = jm.init_cache(3, 64)
    tc = tm.init_cache(3, 64, device="cpu")
    jl, tl = jax.tree.leaves(jc), jax.tree.leaves(tc)
    assert [tuple(a.shape) for a in tl] == [a.shape for a in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(to_np(a), np.asarray(b, np.float32))


def test_init_layout_and_dtypes_match_jax():
    for arch in DENSE:
        jm, tm, jp, _ = _models(arch, "bfloat16")
        tp = tm.init(seed=0, device="cpu")
        jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
        tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
        assert [jax.tree_util.keystr(p) for p, _ in tflat] == \
            [jax.tree_util.keystr(p) for p, _ in jflat]
        for (_, a), (_, b) in zip(tflat, jflat):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)


def test_stack_init_matches_per_layer_init():
    cfg = tconfigs.smoke_config("qwen3-14b")
    init = ttfm.dense_block(cfg)[0]
    stacked = ttfm.stack_init(init, torch.Generator().manual_seed(5), 3)
    gen = torch.Generator().manual_seed(5)
    for i in range(3):
        one = init(gen)
        for a, b in zip(jax.tree.leaves(ttfm._layer(stacked, i)),
                        jax.tree.leaves(one)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_other_families_are_refused(arch):
    """No family is refused any more (the last two, vlm and encdec, were
    ported): ``build_model`` builds every arch from its smoke config,
    with JAX's parameter count."""
    cfg = tconfigs.smoke_config(arch)
    params = build_model(cfg).init(seed=0, device="cpu")
    assert sum(t.numel() for t in jax.tree.leaves(params)) == \
        cfg.n_params() == jconfigs.smoke_config(arch).n_params()


def test_loss_fn_is_refused():
    """Since the training loss was ported (ROADMAP A13b), what is refused
    is a loss built on ``forward``: its attention runs the flash kernel,
    which has no backward, and the wrapper refuses tensors under
    ``torch.func.grad`` on the CPU as the card would. ``loss_fn`` runs the
    plain path and gives the JAX package's loss."""
    jm, tm, jp, tp = _models("qwen3-14b", "float32")
    toks = np.random.default_rng(0).integers(0, 512, (1, 6)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}

    def forward_loss(params):
        logits, aux = tm.forward(params, batch)
        return tlayers.softmax_xent(logits[:, :-1], batch["tokens"][:, 1:]) \
            + aux

    with pytest.raises(ValueError, match="no backward"):
        torch.func.grad(forward_loss)(tp)
    want = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(tm.loss_fn(tp, batch)), float(want),
                               rtol=1e-5)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_model_config_fields_mirror_jax():
    """Every JAX field, with its default; beyond them exactly the port's
    own, ``PORT_ONLY_FIELDS`` (the mla_moe family's, which the JAX
    package lacks)."""
    mine = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    assert {k: mine.get(k, "missing") for k in theirs} == theirs
    assert tuple(k for k in mine if k not in theirs) == PORT_ONLY_FIELDS


def _jax_fields(cfg):
    """The JAX package's fields of a port config, after asserting the
    port's own fields at their defaults."""
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    out = _fields(cfg)
    for k in PORT_ONLY_FIELDS:
        assert out.pop(k) == defaults[k], (cfg.arch, k)
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_jax(arch):
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert _jax_fields(tconfigs.get_config(arch)) == \
        _fields(jconfigs.get_config(arch))
    assert _jax_fields(tconfigs.smoke_config(arch)) == \
        _fields(jconfigs.smoke_config(arch))
    for preset in ("tiny", "100m", "full"):
        assert _jax_fields(tconfigs.preset_config(arch, preset)) == \
            _fields(j_preset_config(arch, preset))
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.dtype == torch.bfloat16
    # field for field, the two attention levers included
    assert dataclasses.asdict(t.attn_config()) == \
        dataclasses.asdict(j.attn_config())


def test_config_lookups_refuse_unknown_names():
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-5")
    with pytest.raises(ValueError):
        tconfigs.preset_config("qwen3-14b", "huge")
