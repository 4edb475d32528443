"""The port's round on the quantized wire and under the closed alpha loop,
against the JAX package's, on the CPU.

Both packages get the same parameters, batches and draws (the JAX round
takes the round key; the port takes the ``RoundDraws`` the reference
provider in ``tests/_torch_ref.py`` makes from that key, the
stochastic-rounding uniforms of the uplink and downlink included). The
JAX side runs ``make_slab_round_step`` with ``backend="pallas"`` (Pallas
interpret mode) and ``backend="jnp"`` (the ``kernels.ref`` oracles, or
the per-leaf reference where the JAX package delegates to it).

Tier: 1e-5 on every state slab (w, optimizer state, ``alpha_hat`` and
the error-feedback rows ``ef``) and on the loss, the trajectory tier of
``tests/test_wire_matrix.py``. A quantized round agrees that closely
only while both sides make the same rounding decisions; with these
inputs no entry sits within an ulp of a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import (METRICS, assert_close, assert_states, jax_configs,
                        ref_draws, run_both)
from repro.core.fl import make_slab_round_step as j_make_step
from repro.core.slab_state import init_train_state as j_init
from repro.models import vision as jvision
from repro_torch.convert import train_state_from_numpy
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.fl import FLConfig, make_slab_round_step
from repro_torch.core.slab import make_slab_spec
from repro_torch.models import vision as tvision

TOL = 1e-5
N, D, C, B = 6, 8, 4, 5

# Every valid cell of tests/test_wire_matrix.py:CELLS (EF needs a
# quantized uplink), plus the sign wire's other two containers.
CELLS = [(u, e, dl, "fold")
         for u in ("f32", "int8", "sign")
         for e in (False, True)
         for dl in ("f32", "int8")
         if not (u == "f32" and e)]
CELLS += [("sign", True, "f32", "planes"), ("sign", True, "f32", "int8")]


def _logreg_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (0.1 * rng.normal(size=(D, C))).astype(np.float32),
            "b": (0.1 * rng.normal(size=(C,))).astype(np.float32)}


def _batches(rounds, seed=1):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(N, B, D)).astype(np.float32),
             "y": rng.integers(0, C, (N, B)).astype(np.int64)}
            for _ in range(rounds)]


def _models():
    return (jvision.logistic_regression(D, C),
            tvision.logistic_regression(D, C))


def _assert_run(jstate, tstate, ms):
    assert_states(jstate, tstate, TOL)
    for jm, tm in ms:
        for f in METRICS:
            assert_close(getattr(tm, f), getattr(jm, f), TOL, TOL, f)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("uplink,ef,downlink,pack", CELLS,
                         ids=[f"{u}-ef{int(e)}-dl{d}-{p}"
                              for u, e, d, p in CELLS])
def test_wire_matrix_cell_matches_jax(uplink, ef, downlink, pack, backend):
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1, downlink=downlink,
                          uplink=UplinkConfig(mode=uplink, error_feedback=ef,
                                              sign_pack=pack))
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=1.5, beta2=0.3)
    jstate, tstate, ms = run_both(*_models(), _logreg_params(), _batches(2),
                                  ch, ad, FLConfig(n_clients=N), backend)
    _assert_run(jstate, tstate, ms)
    if ef:
        # a quantized round leaves a real residual behind
        assert float(torch.max(torch.abs(tstate.ef))) > 0.0


@pytest.mark.parametrize("uplink", [
    dict(mode="int8", stochastic_rounding=False),
    dict(mode="int8", sr_inkernel=True),
])
def test_int8_rounding_variants_match_jax(uplink):
    """Round-to-nearest, and ``sr_inkernel``, which the plain version
    (like the JAX package's interpret path) runs on the host draws."""
    ch = OTAChannelConfig(uplink=UplinkConfig(error_feedback=True, **uplink))
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05)
    jstate, tstate, ms = run_both(*_models(), _logreg_params(), _batches(2),
                                  ch, ad, FLConfig(n_clients=N), "pallas")
    _assert_run(jstate, tstate, ms)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("wire", ["f32", "int8-ef"])
def test_tracked_alpha_five_rounds_match_jax(wire, backend):
    """alpha="auto": the pilot statistics, the resident EMA and the
    tracked alpha in the update; ``alpha_hat`` is compared every round
    (it is a RoundMetrics field) and in the final state."""
    up = (UplinkConfig() if wire == "f32"
          else UplinkConfig(mode="int8", error_feedback=True))
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1, uplink=up)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha="auto",
                        alpha_ema=0.3)
    jstate, tstate, ms = run_both(*_models(), _logreg_params(), _batches(5),
                                  ch, ad, FLConfig(n_clients=N), backend)
    _assert_run(jstate, tstate, ms)
    assert 1.0 < float(tstate.alpha_hat) <= 2.0


def test_tracked_alpha_without_interference_stays_unseeded():
    """No interference -> no residual -> the EMA never seeds and the
    update runs at the Gaussian endpoint 2.0, as in the JAX package."""
    ch = OTAChannelConfig(interference=False)
    ad = AdaptiveConfig(optimizer="adagrad_ota", lr=0.05, alpha="auto")
    jstate, tstate, ms = run_both(*_models(), _logreg_params(), _batches(2),
                                  ch, ad, FLConfig(n_clients=N), "pallas")
    _assert_run(jstate, tstate, ms)
    assert float(tstate.alpha_hat) == 0.0


def test_jax_state_with_residual_carries_over():
    """A JAX state in the middle of a tracked int8 + EF run (alpha_hat
    seeded, ef nonzero) carried across with ``train_state_from_numpy``
    continues on the port as it does in the JAX package."""
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                              error_feedback=True))
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha="auto")
    fl = FLConfig(n_clients=N)
    jmodel, tmodel = _models()
    params = _logreg_params()
    jch, jad, jfl = jax_configs(ch, ad, fl)
    jstep = j_make_step(jmodel.loss_fn, jch, jad, jfl, backend="pallas")
    jstate = j_init(jad, jax.tree.map(jnp.asarray, params),
                    error_feedback=True)
    batches = _batches(3)
    keys = [jax.random.fold_in(jax.random.key(3), t) for t in range(3)]
    for t in range(2):
        jstate, _ = jstep(jstate, keys[t], jax.tree.map(jnp.asarray,
                                                        batches[t]))
    tstate = train_state_from_numpy(
        make_slab_spec(params), step=np.asarray(jstate.step),
        w=np.asarray(jstate.w), opt=[np.asarray(o) for o in jstate.opt],
        alpha_hat=np.asarray(jstate.alpha_hat), ef=np.asarray(jstate.ef),
        device="cpu")
    assert float(tstate.alpha_hat) > 0.0 and torch.any(tstate.ef != 0)
    tstep = make_slab_round_step(tmodel.loss_fn, ch, ad, fl, device="cpu")
    tstate, tm = tstep(tstate, ref_draws(keys[2], ch, jstate.spec, N),
                       batches[2])
    jstate, jm = jstep(jstate, keys[2], jax.tree.map(jnp.asarray,
                                                     batches[2]))
    assert_states(jstate, tstate, TOL)
    assert_close(tm.alpha_hat, jm.alpha_hat, TOL, TOL, "alpha_hat")
    with pytest.raises(ValueError, match="ef must be"):
        train_state_from_numpy(make_slab_spec(params), step=0,
                               w=np.asarray(jstate.w),
                               opt=[np.asarray(o) for o in jstate.opt],
                               alpha_hat=0.0, ef=np.zeros(3, np.float32),
                               device="cpu")
