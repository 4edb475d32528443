"""The port's streamed rounds against the JAX package's, on the CPU:
5-round trajectories.

Both packages get the same parameters, batches and draws (the
participation mask included, from ``tests/_torch_ref.py``). The JAX side
runs ``make_slab_round_step`` with ``backend="pallas"`` (Pallas
interpret mode) and ``backend="jnp"`` (the ``kernels.ref`` oracles).
Chunks of 2 (serial), 3 (ragged: 8 = 3 + 3 + 2) and N (one chunk),
full or half participation, and uniform or dataset-size weights; then
the closed alpha loop and the double-buffered loop on a narrow MLP.

Tier: 1e-5 on every state slab and on every metric, the trajectory tier
of ``tests/test_backend_parity.py``.
"""

import numpy as np
import pytest

from _torch_ref import METRICS, assert_close, assert_states, run_both
from repro.models import vision as jvision
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.fl import FLConfig
from repro_torch.models import vision as tvision

TOL = 1e-5
N, D, C, B = 8, 8, 4, 5
WEIGHTS = (4.0, 2.0, 7.0, 1.0, 3.0, 5.0, 2.0, 8.0)


def _logreg_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (0.1 * rng.normal(size=(D, C))).astype(np.float32),
            "b": (0.1 * rng.normal(size=(C,))).astype(np.float32)}


def _batches(rounds, seed=1):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(N, B, D)).astype(np.float32),
             "y": rng.integers(0, C, (N, B)).astype(np.int64)}
            for _ in range(rounds)]


def _assert_run(jstate, tstate, ms):
    assert_states(jstate, tstate, TOL)
    for jm, tm in ms:
        for f in METRICS:
            assert_close(getattr(tm, f), getattr(jm, f), TOL, TOL, f)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rate", [1.0, 0.5])
@pytest.mark.parametrize("chunk", [2, 3, N])
@pytest.mark.parametrize("optimizer", ["adam_ota", "adagrad_ota"])
def test_streamed_trajectory_matches_jax(optimizer, chunk, rate, weighted,
                                         backend):
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    ad = AdaptiveConfig(optimizer=optimizer, lr=0.05, alpha=1.5, beta2=0.3)
    fl = FLConfig(n_clients=N, client_chunk=chunk, sample_rate=rate,
                  client_weights=WEIGHTS if weighted else None)
    models = (jvision.logistic_regression(D, C),
              tvision.logistic_regression(D, C))
    jstate, tstate, ms = run_both(*models, _logreg_params(), _batches(5),
                                  ch, ad, fl, backend)
    _assert_run(jstate, tstate, ms)
    parts = [float(tm.n_participants) for _, tm in ms]
    assert parts == [float(N)] * 5 if rate == 1.0 else min(parts) < N


MLP_CASES = {
    "auto-ragged-weighted": (dict(client_chunk=3, sample_rate=0.5,
                                  client_weights=WEIGHTS),
                             UplinkConfig(), "auto"),
    "auto-int8-ef-double": (dict(client_chunk=3, double_buffer=True,
                                 sample_rate=0.5),
                            UplinkConfig(mode="int8", error_feedback=True),
                            "auto"),
    "sign-fold-ef-double-weighted": (
        dict(client_chunk=2, double_buffer=True, client_weights=WEIGHTS),
        UplinkConfig(mode="sign", error_feedback=True, sign_pack="fold"),
        1.5),
}


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_streamed_mlp_trajectory_matches_jax(case, backend):
    """A narrow MLP (8 -> 16 -> 4), 5 rounds: the tracked alpha, the
    double-buffered fold and the quantized finish stage with EF."""
    fl_kw, up, alpha = MLP_CASES[case]
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1, uplink=up)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=alpha,
                        alpha_ema=0.3, beta2=0.3)
    fl = FLConfig(n_clients=N, **fl_kw)
    jmodel, tmodel = (jvision.mlp(D, C, hidden=16),
                      tvision.mlp(D, C, hidden=16))
    params = {k: np.asarray(v) for k, v in
              tmodel.init(seed=3, device="cpu").items()}
    jstate, tstate, ms = run_both(jmodel, tmodel, params, _batches(5), ch,
                                  ad, fl, backend)
    _assert_run(jstate, tstate, ms)
