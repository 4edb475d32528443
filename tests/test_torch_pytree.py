"""The port's per-round pytree API against the JAX package's, on the CPU.

``make_round_step`` + ``init_server`` + ``run_rounds`` (``core/fl.py``),
the six tree-map server optimizers and ``make_server_optimizer``
(``core/adaptive.py``), the per-leaf interference and
``ota_aggregate_stacked`` (``core/ota.py``), the stable samplers
(``core/channel.py``), the NamedTuple nodes of ``core/slab.py``'s pytree
helpers and the two example twins. The ResNet-tiny trajectories are in
``tests/test_torch_pytree_resnet.py``.

Both packages get the same numpy inputs. The JAX round takes its round
key; the port takes the ``RoundDraws`` that ``tests/_torch_ref.py``
makes from that key with the JAX package's own functions, and the JAX
``run_rounds``' ``key, k_round, k_data = split(key, 3)`` chain is rebuilt in
the port's ``draws_fn``. The JAX side runs ``backend="pallas"`` (Pallas
interpret mode) where the port's round is the slab round.

Tiers: 1e-6 of scale for single calls (the kernels' tier of
``tests/test_torch_kernels_ref.py``: libm ulps, XLA's fused
multiply-add), 1e-5 for trajectories (``tests/test_torch_round.py``);
the interference statistics 1e-5 relative (sums of ~10^3 logs).
"""

import dataclasses
import importlib.util
import pathlib
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import (assert_close, assert_trajectories,
                        jax_channel_config, jax_configs, ref_draws,
                        run_rounds_both, to_np)
from repro.core import adaptive as jadaptive
from repro.core import channel as jchannel
from repro.core import fl as jfl
from repro.core import ota as jota
from repro.core.slab import make_slab_spec as j_make_slab_spec
from repro.models import vision as jvision
from repro_torch.convert import params_from_numpy
from repro_torch.core import adaptive as tadaptive
from repro_torch.core import channel as tchannel
from repro_torch.core import ota as tota
from repro_torch.core.adaptive import AdaptiveConfig, ServerOptState
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.draws import RoundDraws
from repro_torch.core.fl import (FLConfig, init_server, make_round_step,
                                 run_rounds)
from repro_torch.core.slab import (make_slab_spec, tree_flatten, tree_map,
                                   tree_unflatten, treedef_str)
from repro_torch.models import vision as tvision

OPTIMIZERS = ["adagrad_ota", "adam_ota", "amsgrad_ota", "yogi_ota",
              "fedavgm", "fedavg"]
TOL = 1e-5
RTOL = 1e-6
N, D, C, B = 6, 8, 4, 5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _assert_scaled(a, b, what=""):
    b_np = to_np(b)
    scale = float(np.max(np.abs(b_np))) if b_np.size else 0.0
    assert_close(a, b, RTOL, RTOL * scale, what)


def _logreg_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (0.1 * rng.normal(size=(D, C))).astype(np.float32),
            "b": (0.1 * rng.normal(size=(C,))).astype(np.float32)}


def _batches(rounds, n=N, local_steps=1, seed=1):
    rng = np.random.default_rng(seed)
    lead = (n,) if local_steps == 1 else (n, local_steps)
    return [{"x": rng.normal(size=lead + (B, D)).astype(np.float32),
             "y": rng.integers(0, C, lead + (B,)).astype(np.int64)}
            for _ in range(rounds)]


# ---------------------------------------------------------------------------
# The NamedTuple repair of the pytree helpers
# ---------------------------------------------------------------------------

class Pair(NamedTuple):
    a: object
    b: object


def _trees():
    z = np.zeros((2,), np.float32)
    return {
        "server_opt_state": ServerOptState(
            np.zeros((), np.int32), {"w": z + 1, "b": [z + 2, (z + 3,)]},
            {"v": z + 4, "vmax": z + 5}),
        "user_namedtuple": Pair(z + 1, Pair([z + 2, z + 3], {"k": z + 4})),
        "nested": {"p": Pair(z + 1, (z + 2, z + 3)), "q": [Pair(z, z + 5)]},
    }


@pytest.mark.parametrize("name", list(_trees()))
def test_tree_map_keeps_namedtuple_types(name):
    tree = _trees()[name]
    out = tree_map(lambda x: torch.from_numpy(x) + 1, tree)
    jout = jax.tree.map(lambda x: jnp.asarray(x) + 1, tree)
    assert type(out) is type(tree)
    leaves, treedef = tree_flatten(out)
    jleaves = jax.tree.leaves(jout)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    rebuilt = tree_unflatten(treedef, leaves)
    assert jax.tree.structure(jax.tree.map(to_np, rebuilt)) == \
        jax.tree.structure(tree)
    assert treedef_str(treedef) == str(jax.tree.structure(tree))


def test_plain_tuples_and_lists_keep_their_types():
    z = torch.zeros(1)
    out = tree_map(lambda x: x + 1, {"t": (z, z), "l": [z, (z,)]})
    assert type(out["t"]) is tuple and type(out["l"]) is list
    assert type(out["l"][1]) is tuple


# ---------------------------------------------------------------------------
# The samplers and the per-leaf interference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha,scale", [(1.2, 1.0), (1.5, 0.1), (2.0, 0.5)])
def test_sample_alpha_stable_matches_jax(alpha, scale):
    key = jax.random.key(3)
    u, e = jchannel.cms_inputs(key, (40, 7))
    want = jchannel.sample_alpha_stable(key, alpha, (40, 7), scale)
    got = tchannel.sample_alpha_stable(torch.from_numpy(np.array(u)),
                                       torch.from_numpy(np.array(e)), alpha,
                                       scale)
    _assert_scaled(got, want)


@pytest.mark.parametrize("interference", [True, False])
def test_sample_interference_matches_jax(interference):
    ch = OTAChannelConfig(alpha=1.3, xi_scale=0.2, interference=interference)
    key = jax.random.key(4)
    u, e = jchannel.cms_inputs(key, (300,))
    want = jchannel.sample_interference(key, jax_channel_config(ch), (300,))
    got = tchannel.sample_interference(torch.from_numpy(np.array(u)),
                                       torch.from_numpy(np.array(e)), ch)
    _assert_scaled(got, want)


@pytest.mark.parametrize("ch", [
    OTAChannelConfig(alpha=1.5, xi_scale=0.1),
    OTAChannelConfig(alpha=1.2, xi_scale=0.3, interference=False),
    OTAChannelConfig(alpha=1.8, power_control=True, pc_threshold=0.5),
], ids=["default", "no-interference", "power-control"])
def test_theory_constants_match_jax(ch):
    jch = jax_channel_config(ch)
    assert tchannel.interference_alpha_moment(ch, 1000) == \
        jchannel.interference_alpha_moment(jch, 1000)
    assert tchannel.upsilon(ch, 1000, 50, 2.0) == \
        jchannel.upsilon(jch, 1000, 50, 2.0)


def _grad_tree(seed=2):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(D, C)).astype(np.float32),
            "blocks": [{"k": rng.normal(size=(3, 3, 2)).astype(np.float32)},
                       rng.normal(size=(5,)).astype(np.float32)],
            "s": np.float32(0.5) * np.ones((), np.float32)}


def _round_draws(key, ch, tree, n=N):
    return ref_draws(key, ch, j_make_slab_spec(tree), n)


@pytest.mark.parametrize("interference", [True, False])
def test_add_interference_matches_jax(interference):
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.3, interference=interference)
    tree = _grad_tree()
    key = jax.random.key(5)
    _, kx = jax.random.split(key)
    want = jota.add_interference(kx, jax_channel_config(ch),
                                 jax.tree.map(jnp.asarray, tree))
    got = tota.add_interference(_round_draws(key, ch, tree), ch,
                                params_from_numpy(tree, "cpu"))
    for a, b in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        _assert_scaled(a, b)


def test_interference_log_moment_stats_match_jax():
    ch = OTAChannelConfig(alpha=1.4, xi_scale=0.2)
    tree = _grad_tree()
    key = jax.random.key(6)
    _, kx = jax.random.split(key)
    jch = jax_channel_config(ch)
    jtree = jax.tree.map(jnp.asarray, tree)
    draws = _round_draws(key, ch, tree)
    ttree = params_from_numpy(tree, "cpu")
    want = jota.interference_log_moment_stats(kx, jch, jtree)
    got = tota.interference_log_moment_stats(draws, ch, ttree)
    assert_close(got, want, TOL, 0.0, "stats")
    # the one-pass form: the same noisy tree and the same statistics
    jnoisy, jstats = jota._add_interference_with_stats(kx, jch, jtree)
    tnoisy, tstats = tota._add_interference_with_stats(draws, ch, ttree)
    assert_close(tstats, jstats, TOL, 0.0, "stats, one pass")
    for a, b in zip(tree_flatten(tnoisy)[0], jax.tree.leaves(jnoisy)):
        _assert_scaled(a, b)


@pytest.mark.parametrize("pilot_stats", [False, True])
def test_ota_aggregate_stacked_matches_jax(pilot_stats):
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.2)
    rng = np.random.default_rng(7)
    stacked = {"w": rng.normal(size=(N, D, C)).astype(np.float32),
               "b": [rng.normal(size=(N, C)).astype(np.float32)]}
    one = jax.tree.map(lambda x: x[0], stacked)
    key = jax.random.key(8)
    want = jota.ota_aggregate_stacked(key, jax_channel_config(ch, "pallas"),
                                      jax.tree.map(jnp.asarray, stacked),
                                      pilot_stats=pilot_stats)
    got = tota.ota_aggregate_stacked(_round_draws(key, ch, one), ch,
                                     params_from_numpy(stacked, "cpu"),
                                     pilot_stats=pilot_stats)
    assert len(got) == len(want)
    assert type(got[0]) is dict and type(got[0]["b"]) is list
    for a, b in zip(tree_flatten(got[0])[0], jax.tree.leaves(want[0])):
        _assert_scaled(a, b)
    _assert_scaled(got[1], want[1])
    if pilot_stats:
        assert_close(got[2], want[2], TOL, 0.0, "stats")


# ---------------------------------------------------------------------------
# The tree-map server optimizers
# ---------------------------------------------------------------------------

def _opt_params(seed=9):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(D, C)).astype(np.float32),
            "layers": [rng.normal(size=(3, 2)).astype(np.float32),
                       rng.normal(size=(7,)).astype(np.float32)]}


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                     params)
    g["w"][0, :] = 0.0                    # the |Delta| == 0 guard
    return g


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_tree_map_optimizer_matches_jax(name, traced):
    """Three updates of each per-leaf optimizer, f32 params, alpha the
    config's float or an override (a 0-dim tensor / traced scalar)."""
    ad = AdaptiveConfig(optimizer=name, lr=0.05, alpha=1.5, beta2=0.3)
    jad = jadaptive.AdaptiveConfig(**dataclasses.asdict(ad), backend="jnp")
    jopt = jadaptive._REGISTRY[name](jad)
    topt = tadaptive._REGISTRY[name](ad)
    assert topt.name == jopt.name == name
    params = _opt_params()
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    assert type(ts) is ServerOptState
    j_alpha = jnp.asarray(1.3, jnp.float32) if traced else None
    t_alpha = torch.tensor(1.3) if traced else None
    for i in range(3):
        g = _grads(params, 10 + i)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             alpha=j_alpha)
        tp, ts = topt.update(params_from_numpy(g, "cpu"), ts, tp,
                             alpha=t_alpha)
    assert int(ts.step) == int(js.step) == 3
    assert treedef_str(tree_flatten(ts)[1]) == str(jax.tree.structure(js))
    for a, b in zip(tree_flatten((tp, ts))[0], jax.tree.leaves((jp, js))):
        assert a.dtype == (torch.int32 if b.dtype == jnp.int32
                           else torch.float32)
        _assert_scaled(a, b)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_make_server_optimizer_is_the_fused_per_leaf_update(name):
    """``make_server_optimizer`` keeps the factory's init and routes the
    update through the fused slab launch (its plain version on the
    CPU): equal to the per-leaf update within 1e-6 of scale."""
    ad = AdaptiveConfig(optimizer=name, lr=0.05, alpha=1.5, beta2=0.3)
    fused = tadaptive.make_server_optimizer(ad)
    leaf = tadaptive._REGISTRY[name](ad)
    params = params_from_numpy(_opt_params(), "cpu")
    fs = fused.init(params)
    ls = leaf.init(params)
    fp, lp = params, params
    for i in range(3):
        g = params_from_numpy(_grads(_opt_params(), 20 + i), "cpu")
        fp, fs = fused.update(g, fs, fp)
        lp, ls = leaf.update(g, ls, lp)
    assert type(fs) is ServerOptState and int(fs.step) == 3
    assert tree_flatten(fs)[1] == tree_flatten(ls)[1]
    for a, b in zip(tree_flatten((fp, fs))[0], tree_flatten((lp, ls))[0]):
        _assert_scaled(a, b)


def test_make_server_optimizer_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown server optimizer"):
        tadaptive.make_server_optimizer(AdaptiveConfig(optimizer="lion"))


# ---------------------------------------------------------------------------
# make_round_step + run_rounds against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", OPTIMIZERS)
def test_logreg_five_rounds_match_jax(name):
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    ad = AdaptiveConfig(optimizer=name, lr=0.05, alpha=1.5, beta2=0.3)
    j, t = run_rounds_both(jvision.logistic_regression(D, C),
                     tvision.logistic_regression(D, C), _logreg_params(),
                     _batches(5), ch, ad, FLConfig(n_clients=N), 5)
    assert_trajectories(j, t, TOL)


def test_local_steps_round_matches_jax():
    """The k > 1 branch of CLIENTUPDATE (FedAvg-style local SGD)."""
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adagrad_ota", lr=0.05)
    fl = FLConfig(n_clients=N, local_steps=2, local_lr=0.1)
    j, t = run_rounds_both(jvision.logistic_regression(D, C),
                     tvision.logistic_regression(D, C), _logreg_params(),
                     _batches(3, local_steps=2), ch, ad, fl, 3)
    assert_trajectories(j, t, TOL)


def test_int8_uplink_round_matches_jax():
    """A quantized uplink without error feedback, which the JAX API
    accepts (``examples/quantized_uplink.py``): the slab pipeline's
    transmit and receive, in the tier of
    ``tests/test_torch_wire_round.py``."""
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1,
                          uplink=UplinkConfig(mode="int8"))
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05)
    j, t = run_rounds_both(jvision.logistic_regression(D, C),
                     tvision.logistic_regression(D, C), _logreg_params(),
                     _batches(3), ch, ad, FLConfig(n_clients=N), 3)
    assert_trajectories(j, t, TOL)


def test_run_rounds_eval_and_log():
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="fedavg", lr=0.1)
    model = tvision.logistic_regression(D, C)
    step = make_round_step(model.loss_fn, ch, ad, FLConfig(n_clients=N),
                           device="cpu")
    params = model.init(device="cpu")
    spec = make_slab_spec(params)
    draws = [RoundDraws(torch.ones(N), torch.zeros(spec.padded),
                        torch.ones(spec.padded)) for _ in range(4)]
    batches = _batches(4)
    lines = []
    params, state, hist = run_rounds(
        step, params, init_server(params, ad), draws.__getitem__,
        batches.__getitem__, 4, eval_fn=lambda p: {"accuracy": 0.5},
        eval_every=2, log_every=2, log=lines.append)
    assert [h["round"] for h in hist] == [0, 1, 2, 3]
    assert "accuracy" in hist[1] and "accuracy" in hist[3]
    assert "accuracy" not in hist[0]
    assert len(lines) == 2 and lines[0].startswith("round     2")
    assert lines[0].endswith("acc 0.5000")
    assert int(state.step) == 4 and all(h["n_participants"] == N
                                        for h in hist)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def _refusal(ch=None, ad=None, fl=None):
    ch = ch or OTAChannelConfig()
    ad = ad or AdaptiveConfig()
    fl = fl or FLConfig(n_clients=N)
    return ch, ad, fl


@pytest.mark.parametrize("case", [
    dict(ad=AdaptiveConfig(alpha="auto")),
    dict(fl=FLConfig(n_clients=N, client_chunk=2)),
    dict(fl=FLConfig(n_clients=N, sample_rate=0.5)),
    dict(ch=OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                                 error_feedback=True))),
    dict(ch=OTAChannelConfig(downlink="int8")),
], ids=["alpha-auto", "client-chunk", "sample-rate", "error-feedback",
        "int8-downlink"])
def test_refusals_are_jax_value_errors(case):
    ch, ad, fl = _refusal(**case)
    loss = tvision.logistic_regression(D, C).loss_fn
    with pytest.raises(ValueError) as got:
        make_round_step(loss, ch, ad, fl, device="cpu")
    with pytest.raises(ValueError) as want:
        jfl.make_round_step(jvision.logistic_regression(D, C).loss_fn,
                            *jax_configs(ch, ad, fl), backend="pallas")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(backend="pallas_sharded"), NotImplementedError, "A12"),
    (dict(mesh=object()), NotImplementedError, "A12"),
    (dict(backend="pallas"), ValueError, "the device decides"),
    (dict(backend="jnp"), ValueError, "the device decides"),
])
def test_backend_and_mesh_refusals(kw, exc, match):
    loss = tvision.logistic_regression(D, C).loss_fn
    with pytest.raises(exc, match=match):
        make_round_step(loss, *_refusal(), device="cpu", **kw)


def test_round_refuses_params_on_another_device_and_a_mask():
    model = tvision.logistic_regression(D, C)
    ad = AdaptiveConfig()
    step = make_round_step(model.loss_fn, OTAChannelConfig(), ad,
                           FLConfig(n_clients=N), device="cpu")
    params = model.init(device="cpu")
    spec = make_slab_spec(params)
    draws = RoundDraws(torch.ones(N), torch.zeros(spec.padded),
                       torch.ones(spec.padded), mask=torch.ones(N))
    with pytest.raises(ValueError, match="draws.mask"):
        step(params, init_server(params, ad), draws, _batches(1)[0])
    meta = tree_map(lambda p: p.to("meta"), params)
    with pytest.raises(ValueError, match="params live on meta"):
        step(meta, init_server(params, ad), draws, _batches(1)[0])


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loss = tvision.logistic_regression(D, C).loss_fn
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_round_step(loss, *_refusal())


# ---------------------------------------------------------------------------
# The example twins
# ---------------------------------------------------------------------------

def _example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,args", [
    ("quickstart_torch", ("adam_ota", 0.05)),
    ("quickstart_torch", ("fedavgm", 0.01)),
    ("quantized_uplink_torch", ("f32",)),
    ("quantized_uplink_torch", ("int8",)),
])
def test_example_twin_trains_on_the_cpu(name, args, capsys):
    out = _example(name).train(*args, device="cpu", rounds=3, log_every=1)
    text = capsys.readouterr().out
    assert text.count("round ") == 3 and "final loss" in text
    if name == "quickstart_torch":
        acc, hist = out
        assert len(hist) == 3
        assert all(np.isfinite(h["loss"]) for h in hist)
    else:
        loss, acc = out
        assert np.isfinite(loss)
    assert 0.0 <= acc <= 1.0
    if name == "quantized_uplink_torch":
        assert ("MAC payload 396 B/round" if args[0] == "int8"
                else "MAC payload 1536 B/round") in text


def test_example_twins_import_no_jax():
    """The twins are port programs: importing one pulls in no jax."""
    import subprocess
    code = ("import importlib.util, sys\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
            "for n in ('quickstart_torch', 'quantized_uplink_torch'):\n"
            f"    p = {str(ROOT / 'examples')!r} + '/' + n + '.py'\n"
            "    s = importlib.util.spec_from_file_location(n, p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
