"""The port's resident round against the JAX package's, on the CPU.

Both packages get the same parameters (numpy, carried across with
``repro_torch.convert``), the same client batches and the same draws:
the JAX round takes the round key, the port takes the ``RoundDraws`` the
reference provider makes from that key with the JAX package's own
functions (``tests/_torch_ref.py``). On the CPU the port's kernel
wrappers run their plain versions; the JAX side runs
``make_slab_round_step`` with ``backend="pallas"`` (Pallas interpret
mode) and with ``backend="jnp"`` (the per-leaf reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ref import (METRICS, assert_close, assert_states, jax_configs,
                        ref_draws, run_both)
from repro.core.fl import make_slab_round_runner as j_make_runner
from repro.core.fl import run_rounds_slab as j_run_rounds_slab
from repro.core.slab_state import init_train_state as j_init_train_state
from repro.data import FederatedBatcher as JFederatedBatcher
from repro.models import vision as jvision
from repro_torch.convert import params_from_numpy
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                 run_rounds_slab)
from repro_torch.core.slab_state import init_train_state
from repro_torch.data import FederatedBatcher, gaussian_mixture
from repro_torch.models import vision as tvision

OPTIMIZERS = ["adagrad_ota", "adam_ota", "amsgrad_ota", "yogi_ota",
              "fedavgm", "fedavg"]
# The trajectory tier of tests/test_backend_parity.py: 5 rounds agree
# to 1e-5 (the two frameworks' libm pow/sin/cos/log differ by ulps).
TOL = 1e-5

N, D, C, B = 6, 8, 4, 5


def _logreg_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (0.1 * rng.normal(size=(D, C))).astype(np.float32),
            "b": (0.1 * rng.normal(size=(C,))).astype(np.float32)}


def _batches(rounds, local_steps=1, seed=1):
    rng = np.random.default_rng(seed)
    lead = (N,) if local_steps == 1 else (N, local_steps)
    return [{"x": rng.normal(size=lead + (B, D)).astype(np.float32),
             "y": rng.integers(0, C, lead + (B,)).astype(np.int64)}
            for _ in range(rounds)]


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_logreg_five_rounds_match_jax(name, backend):
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    ad = AdaptiveConfig(optimizer=name, lr=0.05, alpha=1.5, beta2=0.3)
    fl = FLConfig(n_clients=N)
    model = (jvision.logistic_regression(D, C),
             tvision.logistic_regression(D, C))
    jstate, tstate, ms = run_both(*model, _logreg_params(), _batches(5),
                                   ch, ad, fl, backend)
    assert_states(jstate, tstate, TOL)
    for jm, tm in ms:
        for f in METRICS:
            assert_close(getattr(tm, f), getattr(jm, f), TOL, TOL, f)


@pytest.mark.parametrize("channel", [
    dict(interference=False),
    dict(fading="gaussian", sigma_c=0.3),
    dict(fading="none", alpha=2.0),
    dict(power_control=True, pc_threshold=0.8),
])
def test_logreg_channel_variants_match_jax(channel):
    ch = OTAChannelConfig(**channel)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05)
    fl = FLConfig(n_clients=N)
    model = (jvision.logistic_regression(D, C),
             tvision.logistic_regression(D, C))
    jstate, tstate, ms = run_both(*model, _logreg_params(), _batches(3),
                                   ch, ad, fl, "pallas")
    assert_states(jstate, tstate, TOL)
    for jm, tm in ms:
        for f in METRICS:
            assert_close(getattr(tm, f), getattr(jm, f), TOL, TOL, f)


def test_local_steps_pseudo_gradient_matches_jax():
    """The k > 1 branch of _client_update (FedAvg-style local SGD)."""
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adagrad_ota", lr=0.05)
    fl = FLConfig(n_clients=N, local_steps=2, local_lr=0.1)
    model = (jvision.logistic_regression(D, C),
             tvision.logistic_regression(D, C))
    jstate, tstate, ms = run_both(*model, _logreg_params(),
                                   _batches(3, local_steps=2), ch, ad, fl,
                                   "pallas")
    assert_states(jstate, tstate, TOL)
    for jm, tm in ms:
        assert_close(tm.loss, jm.loss, TOL, TOL, "loss")


def test_runner_and_driver_match_jax_driver():
    """make_slab_round_runner + run_rounds_slab against the JAX driver:
    the JAX round keys come from its sequential split, the port gets the
    draws of those keys by absolute round index; both batchers are seeded
    alike, so the histories and final states agree."""
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05)
    fl = FLConfig(n_clients=N)
    data = gaussian_mixture(300, D, C, seed=0)
    jch, jad, jfl = jax_configs(ch, ad, fl)
    params = _logreg_params()
    jstate = j_init_train_state(jad, jax.tree.map(jnp.asarray, params))
    tstate = init_train_state(ad, params_from_numpy(params, "cpu"),
                              device="cpu")
    key = jax.random.key(11)
    round_keys, k = [], key
    for _ in range(5):
        k, k_round, _ = jax.random.split(k, 3)
        round_keys.append(k_round)

    jrun = j_make_runner(jvision.logistic_regression(D, C).loss_fn, jch, jad,
                         jfl)
    jbatch = JFederatedBatcher(data, N, B, seed=0)
    jstate, jhist = j_run_rounds_slab(jrun, jstate, key, jbatch, 5, chunk=2)

    trun = make_slab_round_runner(tvision.logistic_regression(D, C).loss_fn,
                                  ch, ad, fl, device="cpu")
    tbatch = FederatedBatcher(data, N, B, seed=0)
    tstate, thist = run_rounds_slab(
        trun, tstate, lambda t: ref_draws(round_keys[t], ch, jstate.spec, N),
        tbatch, 5, chunk=2)
    assert [h["round"] for h in thist] == [h["round"] for h in jhist]
    for th, jh in zip(thist, jhist):
        for f in ("loss", "grad_norm", "noisy_grad_norm", "alpha_hat",
                  "n_participants"):
            np.testing.assert_allclose(th[f], jh[f], rtol=TOL, atol=TOL)
    assert_close(tstate.w, jstate.w, TOL, TOL, "w")


def test_run_rounds_slab_eval_and_log():
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="fedavg", lr=0.1)
    fl = FLConfig(n_clients=N)
    model = tvision.logistic_regression(D, C)
    data = gaussian_mixture(300, D, C, seed=0)
    state = init_train_state(ad, model.init(device="cpu"), device="cpu")
    run = make_slab_round_runner(model.loss_fn, ch, ad, fl, device="cpu")
    lines = []

    def eval_fn(params):
        return {"accuracy": tvision.accuracy(model, params, data.x, data.y)}

    provider = TorchDraws(ch, state.spec, N, seed=1, device="cpu")
    state, hist = run_rounds_slab(run, state, provider,
                                  FederatedBatcher(data, N, B), 6, chunk=4,
                                  eval_fn=eval_fn, eval_every=3, log_every=3,
                                  log=lines.append)
    assert [h["round"] for h in hist] == list(range(6))
    assert "accuracy" in hist[2] and "accuracy" in hist[5]
    assert len(lines) == 2 and lines[0].startswith("round     3")
    assert int(state.step) == 6
    assert all(np.isfinite(h["loss"]) for h in hist)
