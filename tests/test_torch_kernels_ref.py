"""The port's plain kernel versions against the JAX package's kernels.

``repro_torch.kernels.ref`` is what the port's kernel wrappers run on a
CPU tensor and what ``chip_smoke.py`` holds each CUDA kernel against on
the card. Here it is held against the JAX package's Pallas kernels
(run in interpret mode on the CPU, as the JAX package's own tests run
them) on the same numpy inputs.

Tolerances: f32 elementwise results agree to 1e-6 relative, plus 1e-6
of the output's largest magnitude: the two frameworks' libm
``pow``/``sin``/``cos``/``log`` differ by an ulp or two, and XLA
contracts ``b1*Delta + (1-b1)*g`` into one fused multiply-add where
torch rounds twice, which after cancellation is an ulp of the operands,
not of the result. A bf16 weight agrees to one bf16 step (the same f32
value can round either way when the f32 results differ by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, to_np
from repro.core import adaptive as jadaptive
from repro.core import channel as jchannel
from repro.core.tail_index import log_moment_stats as j_log_moment_stats
from repro.kernels.adaptive_update import MODES as J_MODES
from repro.kernels.adaptive_update import adaptive_update_slab as j_update
from repro.kernels.ota_channel import ota_channel_slab as j_channel
from repro_torch.core import adaptive as tadaptive
from repro_torch.core import channel as tchannel
from repro_torch.kernels.adaptive_update import MODES, adaptive_update_slab
from repro_torch.kernels.ota_channel import ota_channel_slab
from repro_torch.kernels.ref import (adaptive_update_ref, log_moment_stats,
                                     ota_channel_ref)

D = 1000          # not a multiple of 128 on purpose
RTOL = 1e-6


def _update_inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 1, D).astype(np.float32)
    w = rng.normal(0, 1, D).astype(np.float32)
    delta = (0.1 * rng.normal(0, 1, D)).astype(np.float32)
    delta[::17] = 0.0                     # the |Delta| == 0 guard
    g[::17] = 0.0
    nu = (0.01 * rng.random(D)).astype(np.float32)
    nu[::23] = 0.0
    nu_max = (nu + 0.01 * rng.random(D)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(g=g, w=w, delta=delta, nu=nu, nu_max=nu_max).items()}
    j = {k: jnp.asarray(v) for k, v in
         dict(g=g, w=w, delta=delta, nu=nu, nu_max=nu_max).items()}
    if dtype == "bf16":
        for k in ("g", "w"):
            t[k] = t[k].to(torch.bfloat16)
            j[k] = j[k].astype(jnp.bfloat16)
    return t, j


def _assert_scaled(a, b, what=""):
    b_np = to_np(b)
    scale = float(np.max(np.abs(b_np))) if b_np.size else 0.0
    assert_close(a, b, RTOL, RTOL * scale, what)


def test_modes_are_the_jax_modes():
    assert MODES == J_MODES


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_adaptive_update_ref_matches_jax_kernel(mode, traced, dtype):
    t, j = _update_inputs(3, dtype)
    alpha = 1.5
    kw = dict(lr=0.05, beta1=0.9, beta2=0.3, eps=1e-8, mode=mode)
    j_alpha = jnp.asarray(alpha, jnp.float32) if traced else alpha
    t_alpha = torch.tensor(alpha) if traced else alpha
    j_out = j_update(j["g"], j["delta"], j["nu"], j["w"], alpha=j_alpha,
                     nu_max=j["nu_max"] if mode == "amsgrad" else None,
                     interpret=True, **kw)
    t_out = adaptive_update_ref(
        t["g"], t["delta"], t["nu"], t["w"], alpha=t_alpha,
        nu_max=t["nu_max"] if mode == "amsgrad" else None, **kw)
    assert len(t_out) == len(j_out)
    for i, (a, b) in enumerate(zip(t_out[:-1], j_out[:-1])):
        assert a.dtype == torch.float32
        _assert_scaled(a, b, f"state {i}")
    w_t, w_j = t_out[-1], j_out[-1]
    assert w_t.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    if dtype == "f32":
        _assert_scaled(w_t, w_j, "w")
    else:
        step = 2.0 ** -7 * np.maximum(np.abs(to_np(w_j)), 2.0 ** -126)
        assert np.all(np.abs(to_np(w_t) - to_np(w_j)) <= step)


def _channel_inputs(seed, n=7, pad=100):
    rng = np.random.default_rng(seed)
    grads = rng.normal(0, 1, (n, D)).astype(np.float32)
    h = (0.5 + rng.random(n)).astype(np.float32)
    u = rng.uniform(-tchannel.CMS_U_BOUND, tchannel.CMS_U_BOUND,
                    D).astype(np.float32)
    e = (-np.log(rng.random(D))).astype(np.float32)
    # a padding tail: no gradient, and the CMS fixed point (0, 1)
    grads[:, -pad:] = 0.0
    u[-pad:] = 0.0
    e[-pad:] = 1.0
    return grads, h, u, e


@pytest.mark.parametrize("n_total", [None, 20])
@pytest.mark.parametrize("pilot_stats", [False, True])
@pytest.mark.parametrize("alpha", [1.2, 1.5, 2.0])
def test_ota_channel_ref_matches_jax_kernel(alpha, pilot_stats, n_total):
    arrs = _channel_inputs(4)
    kw = dict(alpha=alpha, scale=0.1, n_total=n_total,
              pilot_stats=pilot_stats)
    j_out = j_channel(*map(jnp.asarray, arrs), interpret=True, **kw)
    t_out = ota_channel_ref(*map(torch.from_numpy, arrs), **kw)
    if pilot_stats:
        (j_out, j_stats), (t_out, t_stats) = j_out, t_out
        assert float(t_stats[0]) == float(j_stats[0]) == D - 100
        assert_close(t_stats, j_stats, 1e-5, 1e-3, "stats")
    # The faded sum is a dot over clients: both sum N=7 products, in
    # their own order, so the tier is absolute at the sum's scale.
    assert_close(t_out, j_out, RTOL, 1e-6, "out")
    assert np.all(to_np(t_out)[-100:] == 0.0)
    assert np.all(to_np(j_out)[-100:] == 0.0)


def test_log_moment_stats_matches_jax():
    rng = np.random.default_rng(6)
    r = rng.standard_cauchy(5000).astype(np.float32)
    r[::7] = 0.0
    a = log_moment_stats(torch.from_numpy(r))
    b = j_log_moment_stats(jnp.asarray(r))
    assert float(a[0]) == float(b[0]) == float(np.count_nonzero(r))
    assert_close(a, b, 1e-5, 1e-3)


@pytest.mark.parametrize("alpha", [1.1, 1.5, 2.0])
def test_cms_transforms_match_jax(alpha):
    rng = np.random.default_rng(7)
    u = rng.uniform(-np.pi / 2, np.pi / 2, 4000).astype(np.float32)
    e = rng.exponential(1.0, 4000).astype(np.float32)
    u[:3] = [np.pi / 2, -np.pi / 2, 0.0]      # endpoints get clipped
    e[:3] = [0.0, 1e-12, 1.0]                 # and e floored
    for tf, jf in ((tchannel.cms_transform, jchannel.cms_transform),
                   (tchannel.cms_transform_fast,
                    jchannel.cms_transform_fast)):
        a = tf(torch.from_numpy(u), torch.from_numpy(e), alpha)
        b = jf(jnp.asarray(u), jnp.asarray(e), alpha)
        assert np.all(np.isfinite(to_np(a)))
        assert_close(a, b, 2e-6, 1e-6, tf.__name__)


@pytest.mark.parametrize("alpha", [1.3, 2.0])
def test_abs_pow_and_alpha_root_match_jax(alpha):
    """Equal to 1e-6 relative, except below the f32 normal range: XLA's
    CPU code flushes subnormal results to zero, torch keeps them
    ((1e-30)^1.3 is 1e-39 here, 0 there), hence the 1e-37 floor."""
    x = np.array([0.0, -0.0, 1e-30, -2.5, 3.0, 1e-3], np.float32)
    assert_close(tadaptive._abs_pow(torch.from_numpy(x), alpha),
                 jadaptive._abs_pow(jnp.asarray(x), alpha), RTOL, 1e-37)
    y = np.abs(x) - 1e-3
    assert_close(tadaptive._alpha_root(torch.from_numpy(y), alpha),
                 jadaptive._alpha_root(jnp.asarray(y), alpha), RTOL, 1e-37)


def test_cpu_wrappers_run_the_plain_versions():
    """On a CPU tensor each wrapper IS its plain version (bitwise) and
    launches nothing."""
    t, _ = _update_inputs(8, "f32")
    before = (adaptive_update_slab.launches, ota_channel_slab.launches)
    kw = dict(lr=0.05, beta1=0.9, beta2=0.3, alpha=1.5, eps=1e-8,
              mode="amsgrad", nu_max=t["nu_max"])
    for a, b in zip(adaptive_update_slab(t["g"], t["delta"], t["nu"], t["w"],
                                         **kw),
                    adaptive_update_ref(t["g"], t["delta"], t["nu"], t["w"],
                                        **kw)):
        assert torch.equal(a, b)
    arrs = [torch.from_numpy(x) for x in _channel_inputs(9)]
    a = ota_channel_slab(*arrs, alpha=1.5, scale=0.1, pilot_stats=True)
    b = ota_channel_ref(*arrs, alpha=1.5, scale=0.1, pilot_stats=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (adaptive_update_slab.launches,
            ota_channel_slab.launches) == before


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor reaches the plain version: any other device
    goes to the kernel or raises (here: the meta device raises)."""
    m = torch.empty(256, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        adaptive_update_slab(m, m, m, m, lr=0.1, beta1=0.9, beta2=0.3,
                             alpha=1.5, eps=1e-8, mode="adam")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ota_channel_slab(torch.empty((2, 256), device="meta"),
                         torch.empty(2, device="meta"), m, m, alpha=1.5,
                         scale=0.1)


def test_wrapper_argument_checks():
    x = torch.zeros(256)
    with pytest.raises(ValueError, match="unknown update mode"):
        adaptive_update_slab(x, x, x, x, lr=0.1, beta1=0.9, beta2=0.3,
                             alpha=1.5, eps=1e-8, mode="lion")
    with pytest.raises(ValueError, match="alpha"):
        ota_channel_slab(torch.zeros((2, 256)), torch.ones(2), x, x,
                         alpha=2.5, scale=0.1)


def test_jax_reference_draws_are_on_cpu_float32():
    """The parity inputs really are plain f32 CPU arrays (a guard for
    the tests above: no bf16 or f64 slips into the JAX side)."""
    _, j = _update_inputs(1, "f32")
    assert all(v.dtype == jnp.float32 for v in j.values())
    assert jax.default_backend() == "cpu"
