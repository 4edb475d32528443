"""The closed alpha loop of the port against the JAX package's.

* ``repro_torch.core.tail_index`` against ``repro.core.tail_index``, on
  the same numpy samples, at 1e-6 relative (f32 libm log/sqrt/exp differ
  by an ulp between the frameworks; sums of 1e4 logs differ in order).
* The plain server update with alpha a 0-dim f32 tensor (the tracked
  alpha, as the round passes it) against the JAX kernel with a traced
  alpha in Pallas interpret mode, for the four alpha modes, at the tier
  of ``tests/test_torch_kernels_ref.py``.
* Every tail-index function keeps its result on the device as a tensor:
  nothing is read back to the host.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, to_np
from repro.core import tail_index as jti
from repro.kernels.adaptive_update import adaptive_update_slab as j_update
from repro_torch.core import tail_index as tti
from repro_torch.kernels import ref as tref
from repro_torch.kernels.adaptive_update import adaptive_update_slab

RTOL = 1e-6


def _stable(alpha, n, seed):
    """Symmetric alpha-stable samples (CMS, numpy)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-np.pi / 2, np.pi / 2, n)
    e = rng.exponential(1.0, n)
    x = (np.sin(alpha * u) / np.cos(u) ** (1 / alpha)
         * (np.cos((1 - alpha) * u) / e) ** ((1 - alpha) / alpha))
    return (0.1 * x).astype(np.float32)


@pytest.mark.parametrize("alpha", [1.2, 1.6, 2.0])
def test_log_moment_estimate_matches_jax(alpha):
    x = _stable(alpha, 20000, 1)
    a_t, s_t = tti.log_moment_estimate(torch.from_numpy(x))
    a_j, s_j = jti.log_moment_estimate(jnp.asarray(x))
    assert_close(a_t, a_j, RTOL, 0.0, "alpha")
    assert_close(s_t, s_j, RTOL, 0.0, "scale")
    assert abs(float(a_t) - alpha) < 0.1


@pytest.mark.parametrize("n", [1, 5, 9, 4000])
def test_hill_estimate_matches_jax(n):
    x = _stable(1.5, n, 2)
    for k_frac in (0.05, 0.2):
        a = tti.hill_estimate(torch.from_numpy(x), k_frac)
        b = jti.hill_estimate(jnp.asarray(x), k_frac)
        assert_close(a, b, RTOL, 0.0, f"n={n} k_frac={k_frac}")
    same = np.full(20, 0.5, np.float32)         # no spread: the upper clip
    assert float(tti.hill_estimate(torch.from_numpy(same))) == float(
        jti.hill_estimate(jnp.asarray(same))) == 4.0


def test_log_moment_stats_is_the_one_in_kernels_ref():
    assert tref.log_moment_stats is tti.log_moment_stats
    x = _stable(1.4, 3000, 3)
    x[::9] = 0.0
    a = tti.log_moment_stats(torch.from_numpy(x))
    b = jti.log_moment_stats(jnp.asarray(x))
    assert float(a[0]) == float(b[0]) == float(np.count_nonzero(x))
    assert_close(a, b, 1e-5, 1e-3)


@pytest.mark.parametrize("alpha", [1.1, 1.5, 1.9])
def test_alpha_from_log_moments_matches_jax(alpha):
    stats = np.array(jti.log_moment_stats(jnp.asarray(
        _stable(alpha, 20000, 4))))
    a_t, s_t = tti.alpha_from_log_moments(torch.from_numpy(stats))
    a_j, s_j = jti.alpha_from_log_moments(jnp.asarray(stats))
    assert_close(a_t, a_j, RTOL, 0.0, "alpha")
    assert_close(s_t, s_j, RTOL, 0.0, "scale")
    # count == 0: the clip values, gated off by the callers
    z = np.zeros(3, np.float32)
    assert_close(tti.alpha_from_log_moments(torch.from_numpy(z))[0],
                 jti.alpha_from_log_moments(jnp.asarray(z))[0], RTOL, 0.0)


@pytest.mark.parametrize("prev", [0.0, 1.3, 1.9])
@pytest.mark.parametrize("empty", [False, True])
def test_update_alpha_ema_and_effective_alpha_match_jax(prev, empty):
    stats = np.array(jti.log_moment_stats(jnp.asarray(
        _stable(1.6, 5000, 5))))
    if empty:
        stats = np.zeros(3, np.float32)
    for rho in (0.1, 0.5):
        a = tti.update_alpha_ema(torch.tensor(prev), torch.from_numpy(stats),
                                 rho)
        b = jti.update_alpha_ema(jnp.asarray(prev, jnp.float32),
                                 jnp.asarray(stats), rho)
        assert a.dtype == torch.float32 and a.dim() == 0
        assert_close(a, b, RTOL, 0.0, f"ema rho={rho}")
        assert_close(tti.effective_alpha(a), jti.effective_alpha(b), RTOL,
                     0.0, "effective")
    if empty:
        assert float(a) == float(np.float32(prev))   # nothing observed
    if prev == 0.0 and empty:
        assert float(tti.effective_alpha(a)) == 2.0


def test_estimate_from_gradient_residual_matches_jax():
    rng = np.random.default_rng(6)
    clean = rng.normal(0, 1, 8000).astype(np.float32)
    noisy = clean + _stable(1.3, 8000, 7)
    a = tti.estimate_from_gradient_residual(torch.from_numpy(clean),
                                            torch.from_numpy(noisy))
    b = jti.estimate_from_gradient_residual(jnp.asarray(clean),
                                            jnp.asarray(noisy))
    for x, y in zip(a, b):
        # the residual itself is one f32 subtraction in each framework
        assert_close(x, y, 1e-5, 0.0)


D = 1000


@pytest.mark.parametrize("alpha", [1.2, 1.5, 1.83, 2.0])
@pytest.mark.parametrize("mode", ["adagrad", "adam", "amsgrad", "yogi"])
def test_update_with_tensor_alpha_matches_jax_traced_alpha(mode, alpha):
    rng = np.random.default_rng(8)
    g, w = (rng.normal(0, 1, D).astype(np.float32) for _ in range(2))
    delta = (0.1 * rng.normal(0, 1, D)).astype(np.float32)
    delta[::17] = 0.0
    g[::17] = 0.0
    nu = (0.01 * rng.random(D)).astype(np.float32)
    nu_max = (nu + 0.01 * rng.random(D)).astype(np.float32)
    kw = dict(lr=0.05, beta1=0.9, beta2=0.3, eps=1e-8, mode=mode)
    a_t = torch.tensor(alpha, dtype=torch.float32)
    t_out = adaptive_update_slab(
        *map(torch.from_numpy, (g, delta, nu, w)), alpha=a_t,
        nu_max=torch.from_numpy(nu_max) if mode == "amsgrad" else None, **kw)
    j_out = j_update(*map(jnp.asarray, (g, delta, nu, w)),
                     alpha=jnp.asarray(alpha, jnp.float32),
                     nu_max=jnp.asarray(nu_max) if mode == "amsgrad"
                     else None, interpret=True, **kw)
    assert len(t_out) == len(j_out)
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        scale = float(np.max(np.abs(to_np(b))))
        assert_close(a, b, RTOL, RTOL * scale, f"output {i}")


def test_tensor_alpha_takes_the_same_path_as_a_float():
    """A tensor alpha and the equal float give the same plain update
    (1/alpha is the same f32 number either way at these values)."""
    rng = np.random.default_rng(9)
    g, w, delta = (torch.from_numpy(rng.normal(0, 1, 512).astype(np.float32))
                   for _ in range(3))
    nu = torch.from_numpy((0.01 * rng.random(512)).astype(np.float32))
    kw = dict(lr=0.05, beta1=0.9, beta2=0.3, eps=1e-8, mode="adam")
    a = adaptive_update_slab(g, delta, nu, w, alpha=torch.tensor(1.5), **kw)
    b = adaptive_update_slab(g, delta, nu, w, alpha=1.5, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
