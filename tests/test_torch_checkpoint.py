"""The port's checkpoints and resume against the JAX package's, on the CPU.

``repro_torch.checkpoint`` (generic ``save`` / ``load``, the slab-state
files, the async writer, ``latest_round``), ``core.slab_state``'s
boundary converters and layout fingerprint (``pack_train_state``,
``unpack_train_state``, ``spec_meta``, ``check_spec_meta``), and
``run_rounds_slab``'s ``start_round`` / ``chunk_hook`` / ``align``.

The file format is the JAX package's key for key: a file either package
writes loads in the other. A slab checkpoint carried across continues
the JAX trajectory within the 1e-5 trajectory tier of
``tests/test_torch_round.py`` (the rounds after the load run in the
other package, on the same draws); a resume inside the port is bitwise.
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro_torch.checkpoint as tckpt
from _torch_ref import assert_states, jax_configs, ref_draws, to_np
from repro.core import adaptive as jadaptive
from repro.core import fl as jfl
from repro.core import slab as jslab
from repro.core import slab_state as jslab_state
from repro.models import vision as jvision
from repro_torch.convert import params_from_numpy
from repro_torch.core import slab as tslab
from repro_torch.core import slab_state as tslab_state
from repro_torch.core.adaptive import AdaptiveConfig, ServerOptState
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import (FLConfig, init_server,
                                 make_slab_round_runner, make_slab_round_step,
                                 run_rounds_slab)
from repro_torch.core.slab_state import init_train_state
from repro_torch.models import vision as tvision

TOL = 1e-5
N, D, C, B = 6, 8, 4, 5
OPTIMIZERS = ["adagrad_ota", "adam_ota", "amsgrad_ota", "yogi_ota",
              "fedavgm", "fedavg"]


def _logreg_params(seed=0, classes=C):
    rng = np.random.default_rng(seed)
    return {"w": (0.1 * rng.normal(size=(D, classes))).astype(np.float32),
            "b": (0.1 * rng.normal(size=(classes,))).astype(np.float32)}


def _batches(rounds, seed=1):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(N, B, D)).astype(np.float32),
             "y": rng.integers(0, C, (N, B)).astype(np.int64)}
            for _ in range(rounds)]


def _state_arrays(st):
    arrs = [st.step, st.w, *st.opt, st.alpha_hat]
    return arrs + ([st.ef] if st.ef is not None else [])


def _assert_bitwise(a, b):
    assert (a.ef is None) == (b.ef is None) and len(a.opt) == len(b.opt)
    for x, y in zip(_state_arrays(a), _state_arrays(b)):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# spec_meta: the same fingerprint as the JAX package's
# ---------------------------------------------------------------------------

def _bf16_tree():
    rng = np.random.default_rng(3)
    return {"emb": rng.normal(size=(5, 3)).astype(jnp.bfloat16),
            "head": rng.normal(size=(3,)).astype(np.float32)}


def _nested_tree():
    z = np.zeros
    return {"enc": [{"k": z((2, 3), np.float32), "v": z((3,), np.float32)},
                    (z((4,), np.float32), z((1, 1), np.float32))],
            "dec": ({"a": [z((2,), np.float32)]},),
            "s": z((), np.float32)}


TREES = {
    "logreg": lambda: _logreg_params(),
    "mlp": lambda: {k: v.numpy() for k, v in
                    tvision.mlp(D, C, hidden=16).init(device="cpu").items()},
    "resnet_tiny": lambda: {k: v.numpy() for k, v in tvision.resnet_tiny(
        10).init(seed=0, device="cpu").items()},
    "bf16_leaf": _bf16_tree,
    "nested": _nested_tree,
}


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("name", list(TREES))
def test_spec_meta_is_the_jax_packages(name, shards):
    tree = TREES[name]()
    jspec = jslab.make_slab_spec(tree, shards=shards)
    tspec = tslab.make_slab_spec(params_from_numpy(tree, "cpu"),
                                 shards=shards)
    got, want = tslab_state.spec_meta(tspec), jslab_state.spec_meta(jspec)
    assert got == want
    # and as the checkpoint stores it (JSON)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    tslab_state.check_spec_meta(tspec, json.loads(json.dumps(want)))


def test_layout_drift_is_refused(tmp_path):
    ad = AdaptiveConfig(optimizer="adam_ota")
    state = init_train_state(ad, params_from_numpy(_logreg_params(), "cpu"),
                             device="cpu")
    path = str(tmp_path / "round_1.npz")
    tckpt.save_slab_state(path, state)
    wider = tslab.make_slab_spec(params_from_numpy(
        _logreg_params(classes=C + 1), "cpu"))
    with pytest.raises(ValueError, match="slab layout mismatch"):
        tckpt.load_slab_state(path, wider, device="cpu")
    # same shapes, renamed leaves: only the treedef tells them apart
    p = _logreg_params()
    renamed = tslab.make_slab_spec(params_from_numpy(
        {"a": p["b"], "w": p["w"]}, "cpu"))
    with pytest.raises(ValueError, match="treedef"):
        tckpt.load_slab_state(path, renamed, device="cpu")
    # a file the JAX package wrote is refused the same way
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_slab_state(jpath, jslab_state.init_train_state(
        jadaptive.AdaptiveConfig(), jax.tree.map(jnp.asarray,
                                                 _logreg_params())))
    with pytest.raises(ValueError, match="slab layout mismatch"):
        tckpt.load_slab_state(jpath, wider, device="cpu")


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", OPTIMIZERS)
def test_pack_unpack_round_trip_matches_jax(name):
    ad = AdaptiveConfig(optimizer=name)
    jad = jadaptive.AdaptiveConfig(optimizer=name)
    params = _nested_tree()
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
        np.float32), params)
    tp = params_from_numpy(params, "cpu")
    spec = tslab.make_slab_spec(tp)
    ts = init_server(tp, ad)
    # values in every slot the mode carries (placeholders stay 0)
    def bump(t):
        return (tslab.tree_map(lambda x: x + 1, t) if isinstance(t, dict)
                else t)

    ts = ServerOptState(ts.step + 3, bump(ts.delta), bump(ts.nu))
    packed = tslab_state.pack_train_state(ad, spec, tp, ts,
                                          alpha_hat=torch.tensor(1.4))
    p2, s2 = tslab_state.unpack_train_state(ad, packed)
    assert type(s2) is ServerOptState
    for a, b in zip(tslab.tree_flatten((p2, s2))[0],
                    tslab.tree_flatten((tp, ts))[0]):
        assert torch.equal(a, b)
    assert float(packed.alpha_hat) == np.float32(1.4)
    again = tslab_state.pack_train_state(ad, spec, p2, s2, packed.alpha_hat)
    _assert_bitwise(again, packed)
    # the JAX package packs the same pytrees into the same slabs
    js = jax.tree.map(jnp.asarray, jax.tree.map(to_np, ts))
    js = jadaptive.ServerOptState(*js)
    jpacked = jslab_state.pack_train_state(
        jad, jslab.make_slab_spec(params), jax.tree.map(jnp.asarray, params),
        js)
    for a, b in zip([packed.w, *packed.opt], [jpacked.w, *jpacked.opt]):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    jp2, js2 = jslab_state.unpack_train_state(jad, jpacked)
    assert tslab.treedef_str(tslab.tree_flatten((p2, s2))[1]) == \
        str(jax.tree.structure((jp2, js2)))


# ---------------------------------------------------------------------------
# Generic save / load, both ways
# ---------------------------------------------------------------------------

def _generic_tree(opt_cls, arr, bf16):
    rng = np.random.default_rng(6)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    e = rng.normal(size=(2, 5)).astype(np.float32)
    d = rng.normal(size=(3, 4)).astype(np.float32)
    return {"params": {"w": arr(w), "emb": bf16(e)},
            "opt": opt_cls(arr(np.asarray(7, np.int32)), {"w": arr(d)},
                           [arr(d + 1), arr(np.zeros((), np.float32))]),
            "round": arr(np.asarray(12, np.int32)),
            "key": arr(np.arange(4, dtype=np.uint32))}


def _jax_tree():
    return _generic_tree(jadaptive.ServerOptState, jnp.asarray,
                         lambda x: jnp.asarray(x, jnp.bfloat16))


def _torch_tree():
    def arr(x):
        return torch.from_numpy(np.array(x))

    return _generic_tree(ServerOptState, arr,
                         lambda x: torch.from_numpy(x).to(torch.bfloat16))


def test_generic_keys_are_the_jax_packages():
    got = tckpt._flatten(_torch_tree())
    want = jckpt._flatten(_jax_tree())
    assert sorted(got) == sorted(want)
    assert "opt|.step" in got and "opt|.nu|0" in got
    assert "params|emb~bf16" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_generic_save_load_both_ways(tmp_path, direction):
    path = str(tmp_path / "tree.npz")
    if direction == "jax_to_torch":
        jckpt.save(path, _jax_tree())
        template = tslab.tree_map(torch.zeros_like, _torch_tree())
        got = tckpt.load(path, template)
        assert type(got["opt"]) is ServerOptState
        assert got["params"]["emb"].dtype == torch.bfloat16
        pairs = zip(tslab.tree_flatten(got)[0],
                    jax.tree.leaves(_jax_tree()))
    else:
        tckpt.save(path, _torch_tree())
        template = jax.tree.map(jnp.zeros_like, _jax_tree())
        got = jckpt.load(path, template)
        assert type(got["opt"]) is jadaptive.ServerOptState
        assert got["params"]["emb"].dtype == jnp.bfloat16
        pairs = zip(jax.tree.leaves(got),
                    tslab.tree_flatten(_torch_tree())[0])
    for a, b in pairs:
        np.testing.assert_array_equal(to_np(a), to_np(b))


def test_generic_load_follows_the_template(tmp_path):
    """dtypes, devices and None subtrees come from the template; a
    missing leaf is a KeyError."""
    path = str(tmp_path / "tree.npz")
    tree = _torch_tree()
    tckpt.save(path, {**tree, "none": None})
    template = tslab.tree_map(lambda x: torch.zeros_like(x, device="meta"),
                              tree)
    template["params"]["emb"] = torch.zeros((2, 5), dtype=torch.float32)
    template["none"] = None
    got = tckpt.load(path, template)
    assert got["none"] is None
    assert got["params"]["emb"].dtype == torch.float32
    assert torch.equal(got["params"]["emb"], tree["params"]["emb"].float())
    assert got["params"]["w"].device.type == "meta"
    with pytest.raises(KeyError, match="params|extra"):
        tckpt.load(path, {**template, "params": {
            **template["params"], "extra": torch.zeros(1)}})


# ---------------------------------------------------------------------------
# Slab checkpoints carried between the packages
# ---------------------------------------------------------------------------

CARRY = {
    "f32-adam": (OTAChannelConfig(alpha=1.5, xi_scale=0.1),
                 dict(optimizer="adam_ota", lr=0.05)),
    "int8-ef-dl8-auto-amsgrad": (
        OTAChannelConfig(alpha=1.5, xi_scale=0.1, downlink="int8",
                         uplink=UplinkConfig(mode="int8",
                                             error_feedback=True)),
        dict(optimizer="amsgrad_ota", lr=0.05, alpha="auto",
             alpha_ema=0.3)),
}


def _carry_setup(name):
    ch, ad_kw = CARRY[name]
    ad = AdaptiveConfig(**ad_kw)
    fl = FLConfig(n_clients=N)
    jch, jad, jfl_cfg = jax_configs(ch, ad, fl)
    ef = ch.uplink.error_feedback
    model = (jvision.logistic_regression(D, C),
             tvision.logistic_regression(D, C))
    jstep = jfl.make_slab_round_step(model[0].loss_fn, jch, jad, jfl_cfg,
                                     backend="pallas")
    tstep = make_slab_round_step(model[1].loss_fn, ch, ad, fl, device="cpu")
    jstate = jslab_state.init_train_state(
        jad, jax.tree.map(jnp.asarray, _logreg_params()), error_feedback=ef)
    tstate = init_train_state(ad, params_from_numpy(_logreg_params(), "cpu"),
                              error_feedback=ef, device="cpu")
    keys = [jax.random.fold_in(jax.random.key(7), t) for t in range(5)]
    draws = [ref_draws(k, ch, jstate.spec, N) for k in keys]
    batches = _batches(5)
    return jstep, tstep, jstate, tstate, keys, draws, batches


@pytest.mark.parametrize("name", list(CARRY))
def test_jax_checkpoint_resumes_in_the_port(tmp_path, name):
    """2 rounds in JAX, saved by ``repro.checkpoint``, loaded by the port,
    3 more rounds in the port: within 1e-5 of JAX's uninterrupted 5."""
    jstep, tstep, jstate, tstate, keys, draws, batches = _carry_setup(name)
    for t in range(2):
        jstate, _ = jstep(jstate, keys[t], jax.tree.map(jnp.asarray,
                                                        batches[t]))
    path = str(tmp_path / "round_2.npz")
    jckpt.save_slab_state(path, jstate, extra={"seed": np.uint32(7)})
    for t in range(2, 5):
        jstate, _ = jstep(jstate, keys[t], jax.tree.map(jnp.asarray,
                                                        batches[t]))
    tstate, extra = tckpt.load_slab_state(path, tstate.spec, device="cpu")
    assert int(tstate.step) == 2 and int(extra["seed"]) == 7
    for t in range(2, 5):
        tstate, _ = tstep(tstate, draws[t], batches[t])
    assert_states(jstate, tstate, TOL)


@pytest.mark.parametrize("name", list(CARRY))
def test_port_checkpoint_resumes_in_jax(tmp_path, name):
    """2 rounds in the port, saved by ``repro_torch.checkpoint``, loaded
    by ``repro.checkpoint``, 3 more rounds in JAX: within 1e-5 of the
    port's uninterrupted 5."""
    jstep, tstep, jstate, tstate, keys, draws, batches = _carry_setup(name)
    for t in range(2):
        tstate, _ = tstep(tstate, draws[t], batches[t])
    path = str(tmp_path / "round_2.npz")
    tckpt.save_slab_state(path, tstate, extra={"seed": torch.tensor(7)})
    for t in range(2, 5):
        tstate, _ = tstep(tstate, draws[t], batches[t])
    jstate, extra = jckpt.load_slab_state(path, jstate.spec)
    assert int(jstate.step) == 2 and int(extra["seed"]) == 7
    for t in range(2, 5):
        jstate, _ = jstep(jstate, keys[t], jax.tree.map(jnp.asarray,
                                                        batches[t]))
    assert_states(jstate, tstate, TOL)


# ---------------------------------------------------------------------------
# The async writer and latest_round
# ---------------------------------------------------------------------------

def _ef_state():
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                              error_feedback=True))
    ad = AdaptiveConfig(optimizer="amsgrad_ota", alpha="auto")
    step = make_slab_round_step(tvision.logistic_regression(D, C).loss_fn,
                                ch, ad, FLConfig(n_clients=N), device="cpu")
    state = init_train_state(ad, params_from_numpy(_logreg_params(), "cpu"),
                             error_feedback=True, device="cpu")
    draws = TorchDraws(ch, state.spec, N, seed=2, device="cpu")
    for t, b in enumerate(_batches(2)):
        state, _ = step(state, draws(t), b)
    return state


def test_async_checkpoint_bytes_equal_blocking(tmp_path):
    state = _ef_state()
    extra = {"key": np.arange(4, dtype=np.uint32)}
    p_sync, p_async = str(tmp_path / "sync.npz"), str(tmp_path / "async.npz")
    tckpt.save_slab_state(p_sync, state, extra=extra)
    tckpt.save_slab_state(p_async, state, extra=extra, blocking=False)
    tckpt.wait_for_async_saves()
    sha = [hashlib.sha256(open(p, "rb").read()).hexdigest()
           for p in (p_sync, p_async)]
    assert sha[0] == sha[1]
    back, extra2 = tckpt.load_slab_state(p_async, state.spec, device="cpu")
    _assert_bitwise(back, state)
    np.testing.assert_array_equal(extra2["key"], extra["key"])


def test_async_snapshot_precedes_later_writes(tmp_path):
    """The host copy is taken before the call returns: writing into the
    state's tensors right after it does not reach the file."""
    state = _ef_state()
    want = [to_np(x).copy() for x in _state_arrays(state)]
    path = str(tmp_path / "round_2.npz")
    tckpt.save_slab_state(path, state, blocking=False)
    for x in _state_arrays(state):
        x.zero_()
    back, _ = tckpt.load_slab_state(path, state.spec, device="cpu")
    for a, b in zip(want, _state_arrays(back)):
        np.testing.assert_array_equal(a, to_np(b))


def test_async_write_errors_surface(tmp_path, monkeypatch):
    def boom(path, arrays):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "_atomic_savez", boom)
    tckpt.save_slab_state(str(tmp_path / "x.npz"), _ef_state(),
                          blocking=False)
    with pytest.raises(RuntimeError, match="disk full"):
        tckpt.wait_for_async_saves()
    tckpt.wait_for_async_saves()          # reported once, then clear


def test_latest_round(tmp_path):
    assert tckpt.latest_round(str(tmp_path / "missing")) is None
    assert tckpt.latest_round(str(tmp_path)) is None
    state = _ef_state()
    for t in (2, 10, 4):
        tckpt.save_slab_state(str(tmp_path / f"round_{t}.npz"), state,
                              blocking=t != 2)
    (tmp_path / "round_x.npz").write_bytes(b"")
    (tmp_path / "other_99.npz").write_bytes(b"")
    got = tckpt.latest_round(str(tmp_path))
    assert got == str(tmp_path / "round_10.npz")
    assert got == jckpt.latest_round(str(tmp_path))


# ---------------------------------------------------------------------------
# run_rounds_slab resumed: start_round, chunk_hook, align
# ---------------------------------------------------------------------------

def _run_slab(run, state, draws, batches, n_rounds, **kw):
    return run_rounds_slab(run, state, draws, batches.__getitem__, n_rounds,
                           **kw)


def test_resumed_run_is_bitwise_the_uninterrupted_run(tmp_path):
    ch = OTAChannelConfig(downlink="int8",
                          uplink=UplinkConfig(mode="int8",
                                              error_feedback=True))
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha="auto")
    fl = FLConfig(n_clients=N)
    model = tvision.logistic_regression(D, C)
    run = make_slab_round_runner(model.loss_fn, ch, ad, fl, device="cpu")
    state0 = init_train_state(ad, params_from_numpy(_logreg_params(), "cpu"),
                              error_feedback=True, device="cpu")
    draws = TorchDraws(ch, state0.spec, N, seed=5, device="cpu")
    batches = _batches(7)
    calls, lines = [], []

    def hook(t, state, history):
        calls.append((t, len(history)))
        if t == 3:
            tckpt.save_slab_state(str(tmp_path / f"round_{t}.npz"), state,
                                  blocking=False)

    full, hist = _run_slab(run, state0, draws, batches, 7, chunk=4,
                                 align=(3,), chunk_hook=hook)
    # chunks clipped at every multiple of 3: rounds 0-2, 3-5, 6
    assert calls == [(3, 3), (6, 6), (7, 7)]
    path = tckpt.latest_round(str(tmp_path))
    resumed, _ = tckpt.load_slab_state(path, state0.spec, device="cpu")
    assert int(resumed.step) == 3
    resumed, rhist = _run_slab(run, resumed, draws, batches, 7,
                                     chunk=2, start_round=3, log_every=2,
                                     log=lines.append)
    _assert_bitwise(resumed, full)
    assert [h["round"] for h in rhist] == [3, 4, 5, 6]
    assert rhist == hist[3:]
    # logged at rounds 4 and 6 (1-based), read from history[i - start]
    assert [x.split()[1] for x in lines] == ["4", "6"]
    assert f"{hist[5]['loss']:.4f}" in lines[1]

