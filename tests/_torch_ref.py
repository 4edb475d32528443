"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Holds the REFERENCE draws provider: it draws a round's (h, u, e) with
the JAX package's own functions and key splits
(``kh, kx = jax.random.split(key)`` as ``repro.core.ota.ota_aggregate_slab``
does; ``sample_fading(kh, ...)``; ``_cms_slab_inputs(kx, spec)``) and
hands them to the port as ``RoundDraws``. It lives here, beside the
tests, because the port's package never imports jax.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.adaptive import AdaptiveConfig as JAdaptiveConfig
from repro.core.channel import OTAChannelConfig as JOTAChannelConfig
from repro.core.channel import UplinkConfig as JUplinkConfig
from repro.core.channel import sample_fading
from repro.core.fl import FLConfig as JFLConfig
from repro.core.fl import make_slab_round_step as j_make_step
from repro.core.slab_state import init_train_state as j_init_train_state
from repro.core.ota import _cms_slab_inputs
from repro_torch.convert import params_from_numpy
from repro_torch.core.draws import RoundDraws
from repro_torch.core.fl import make_slab_round_step
from repro_torch.core.slab_state import init_train_state

METRICS = ("loss", "grad_norm", "noisy_grad_norm", "fading_mean",
           "alpha_hat", "n_participants")


def jax_channel_config(ch, backend="pallas"):
    fields = {f.name: getattr(ch, f.name) for f in dataclasses.fields(ch)}
    fields["uplink"] = JUplinkConfig(**dataclasses.asdict(ch.uplink))
    return JOTAChannelConfig(**fields, backend=backend)


def jax_configs(ch, ad, fl, backend="pallas"):
    """The JAX package's configs equal to the port's (plus ``backend``)."""
    return (jax_channel_config(ch, backend),
            JAdaptiveConfig(**dataclasses.asdict(ad), backend=backend),
            JFLConfig(**dataclasses.asdict(fl)))


def ref_draws(key, ch, jspec, n: int) -> RoundDraws:
    """The draws the JAX round makes from ``key``, as tensors."""
    kh, kx = jax.random.split(key)
    h = sample_fading(kh, jax_channel_config(ch), (n,))
    if ch.interference:
        u, e = _cms_slab_inputs(kx, jspec)
    else:
        u = jnp.zeros((jspec.padded,), jnp.float32)
        e = jnp.ones((jspec.padded,), jnp.float32)
    return RoundDraws(*(torch.from_numpy(np.array(x, np.float32))
                        for x in (h, u, e)))


def to_np(x) -> np.ndarray:
    """A jax array or a tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=rtol, atol=atol,
                               err_msg=what)


def max_rel_err(a, b, floor=1e-6) -> float:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


def run_both(jmodel, tmodel, params_np, batches, ch, ad, fl, backend):
    """Drive the JAX round (``backend``) and the port's (CPU) over the
    same params, batches and draws; return both final states and the
    per-round ``(jax metrics, port metrics)``."""
    jch, jad, jfl = jax_configs(ch, ad, fl, backend)
    jstate = j_init_train_state(jad, jax.tree.map(jnp.asarray, params_np))
    tstate = init_train_state(ad, params_from_numpy(params_np, "cpu"),
                              device="cpu")
    jstep = j_make_step(jmodel.loss_fn, jch, jad, jfl, backend=backend)
    tstep = make_slab_round_step(tmodel.loss_fn, ch, ad, fl, device="cpu")
    out = []
    for t, batch in enumerate(batches):
        key = jax.random.fold_in(jax.random.key(7), t)
        draws = ref_draws(key, ch, jstate.spec, fl.n_clients)
        jstate, jm = jstep(jstate, key, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, draws, batch)
        out.append((jm, tm))
    return jstate, tstate, out


def assert_states(jstate, tstate, tol):
    assert_close(tstate.w, jstate.w, tol, tol, "w")
    assert len(tstate.opt) == len(jstate.opt)
    for i, (a, b) in enumerate(zip(tstate.opt, jstate.opt)):
        assert_close(a, b, tol, tol, f"opt[{i}]")
    assert int(tstate.step) == int(jstate.step)
