"""The port's local optimizers and schedules (``repro_torch.optim``)
against ``repro.optim``, on the CPU.

A small pytree (a nested dict with a list, f32 and bf16 leaves, a 0-dim
leaf) takes 5 steps of each optimizer on gradients drawn from a numpy
seed; the parameters and the state are held to JAX's after every step:
f32 leaves within 1e-6 relative (the same elementwise formulas, pow and
sqrt in another library), bf16 leaves within one bf16 step of their
value. The schedules at steps across warm-up and decay within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import to_np
from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.convert import params_from_numpy
from repro_torch.core.slab import tree_flatten

STEPS = 5


def _tree(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"dense": {"kernel": f(6, 4), "bias": f(4)},
            "scale": np.asarray(f(1)[0]),
            "stack": [f(3, 5), f(2)]}


def _bf16(tree):
    """The tree as JAX arrays, its bias in bf16."""
    j = jax.tree.map(jnp.asarray, tree)
    j["dense"]["bias"] = j["dense"]["bias"].astype(jnp.bfloat16)
    return j


def _close(got, want, what):
    for a, b in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        a_np, b_np = to_np(a), to_np(b)
        assert a_np.shape == b_np.shape, what
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), what
        if str(b.dtype) == "bfloat16":
            tol = 2.0 ** -8 * np.abs(b_np) + 1e-30
        else:
            tol = 1e-6 * np.abs(b_np) + 1e-7
        assert (np.abs(a_np - b_np) <= tol).all(), (
            what, float(np.abs(a_np - b_np).max()))


OPTS = {
    "sgd": lambda m: m.sgd(0.1),
    "momentum": lambda m: m.momentum(0.05, beta=0.8),
    "adamw": lambda m: m.adamw(0.01, weight_decay=0.1),
    "adamw-defaults": lambda m: m.adamw(0.003),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_steps_match_jax(name):
    rng = np.random.default_rng(0)
    jp = _bf16(_tree(rng))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jopt, topt = OPTS[name](joptim), OPTS[name](toptim)
    assert topt.name == jopt.name
    js, ts = jopt.init(jp), topt.init(tp)
    _close(ts, js, f"{name} init")
    for step in range(STEPS):
        g = _tree(rng)
        jg = jax.tree.map(jnp.asarray, g)
        tg = params_from_numpy(g, "cpu")
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
        _close(tp, jp, f"{name} params after step {step}")
        _close(ts, js, f"{name} state after step {step}")
    if name.startswith("adamw"):
        assert int(ts.step) == STEPS and ts.step.dtype == torch.int32
        assert type(ts)._fields == ("step", "m", "v")


@pytest.mark.parametrize("warmup", [0, 3])
def test_cosine_schedule_matches_jax(warmup):
    j = joptim.cosine_schedule(0.1, 20, warmup)
    t = toptim.cosine_schedule(0.1, 20, warmup)
    for step in [0, 1, 2, 3, 4, 10, 19, 20, 25]:
        got = t(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(j(step)), rtol=1e-6,
                                   atol=1e-9)
    np.testing.assert_allclose(float(t(torch.tensor(7))), float(j(7)),
                               rtol=1e-6)


def test_constant_schedule_matches_jax():
    got = toptim.constant_schedule(0.25)(17)
    assert got.dtype == torch.float32 and float(got) == float(
        joptim.constant_schedule(0.25)(17))


def test_local_opt_is_a_named_tuple_of_the_jax_fields():
    assert toptim.LocalOpt._fields == joptim.LocalOpt._fields
    for make in OPTS.values():
        opt = make(toptim)
        assert isinstance(opt, toptim.LocalOpt)
        assert callable(opt.init) and callable(opt.update)
