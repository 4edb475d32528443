"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Holds the REFERENCE draws provider: it draws a round's (h, u, e) with
the JAX package's own functions and key splits
(``kh, kx = jax.random.split(key)`` as ``repro.core.ota.ota_aggregate_slab``
does; ``sample_fading(kh, ...)``; ``_cms_slab_inputs(kx, spec)``), and
for the quantized wire the stochastic-rounding uniforms the JAX round
draws from the same key (``uplink_sr_slab_inputs(key, spec)[0]``,
``downlink_sr_slab_inputs(key, spec.padded)``), and under partial
participation the mask (``repro.core.stream.participation_mask(key, N,
rate)``, keyed off the round key itself), and hands them to the port as
``RoundDraws``. It lives here, beside the tests, because the
port's package never imports jax.
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
from repro.core.fl import init_server as j_init_server
from repro.core.fl import make_round_step as j_make_round_step
from repro.core.fl import make_slab_round_step as j_make_step
from repro.core.fl import run_rounds as j_run_rounds
from repro.core.slab import make_slab_spec as j_make_slab_spec
from repro.core.slab_state import init_train_state as j_init_train_state
from repro.core.ota import (_cms_slab_inputs, downlink_sr_slab_inputs,
                            uplink_sr_slab_inputs)
from repro.core.stream import participation_mask
from repro_torch.convert import params_from_numpy
from repro_torch.core.adaptive import ServerOptState
from repro_torch.core.draws import RoundDraws
from repro_torch.core.fl import (init_server, make_round_step,
                                 make_slab_round_step, run_rounds)
from repro_torch.core.slab import tree_flatten, treedef_str
from repro_torch.core.slab_state import init_train_state

# One compiled program for the whole slab's draw (the eager draw compiles
# one per leaf shape); the same values, bit for bit.
_cms_slab_inputs_jit = jax.jit(_cms_slab_inputs, static_argnums=1)

METRICS = ("loss", "grad_norm", "noisy_grad_norm", "fading_mean",
           "alpha_hat", "n_participants")
HISTORY = ("loss", "grad_norm", "noisy_grad_norm", "alpha_hat",
           "n_participants")


def jax_channel_config(ch, backend="pallas"):
    fields = {f.name: getattr(ch, f.name) for f in dataclasses.fields(ch)}
    fields["uplink"] = JUplinkConfig(**dataclasses.asdict(ch.uplink))
    return JOTAChannelConfig(**fields, backend=backend)


def jax_configs(ch, ad, fl, backend="pallas"):
    """The JAX package's configs equal to the port's (plus ``backend``)."""
    return (jax_channel_config(ch, backend),
            JAdaptiveConfig(**dataclasses.asdict(ad), backend=backend),
            JFLConfig(**dataclasses.asdict(fl)))


def ref_draws(key, ch, jspec, n: int, sample_rate: float = 1.0,
              shard_index=None) -> RoundDraws:
    """The draws the JAX round makes from ``key``, as tensors; the wire's
    fields and the participation mask only for a config that uses them.
    ``shard_index=p`` makes a rank's draws for the sharded engine:
    transmitter p's rounding rows ``uplink_sr_slab_inputs(key, jspec,
    p)`` (row 0 ``r_up``, row 1 ``r_clean``) and ``shard=p``."""
    kh, kx = jax.random.split(key)
    h = sample_fading(kh, jax_channel_config(ch), (n,))
    if ch.interference:
        u, e = _cms_slab_inputs_jit(kx, jspec)
    else:
        u = jnp.zeros((jspec.padded,), jnp.float32)
        e = jnp.ones((jspec.padded,), jnp.float32)
    r_up = r_dl = r_clean = None
    if ch.uplink.mode == "int8" and ch.uplink.stochastic_rounding:
        rows = uplink_sr_slab_inputs(key, jspec, shard_index or 0)
        r_up = rows[0]
        if shard_index is not None:
            r_clean = rows[1]
    if ch.downlink == "int8":
        r_dl = downlink_sr_slab_inputs(key, jspec.padded)

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x, np.float32))

    mask = (participation_mask(key, n, sample_rate) if sample_rate < 1.0
            else None)
    return RoundDraws(t(h), t(u), t(e), t(r_up), t(r_dl), mask=t(mask),
                      r_clean=t(r_clean), shard=shard_index)


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
    ef = ch.uplink.error_feedback
    jstate = j_init_train_state(jad, jax.tree.map(jnp.asarray, params_np),
                                error_feedback=ef)
    tstate = init_train_state(ad, params_from_numpy(params_np, "cpu"),
                              error_feedback=ef, device="cpu")
    jstep = j_make_step(jmodel.loss_fn, jch, jad, jfl, backend=backend)
    tstep = make_slab_round_step(tmodel.loss_fn, ch, ad, fl, device="cpu")
    out = []
    for t, batch in enumerate(batches):
        key = jax.random.fold_in(jax.random.key(7), t)
        draws = ref_draws(key, ch, jstate.spec, fl.n_clients,
                          fl.sample_rate)
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
    assert_close(tstate.alpha_hat, jstate.alpha_hat, tol, tol, "alpha_hat")
    assert (tstate.ef is None) == (jstate.ef is None)
    if jstate.ef is not None:
        assert tuple(tstate.ef.shape) == tuple(jstate.ef.shape)
        assert_close(tstate.ef, jstate.ef, tol, tol, "ef")


def round_key_chain(key, n: int):
    """The round keys of JAX's ``run_rounds`` chain: ``key, k_round, k_data =
    split(key, 3)`` each round."""
    out = []
    for _ in range(n):
        key, k_round, _ = jax.random.split(key, 3)
        out.append(k_round)
    return out


def run_rounds_both(jmodel, tmodel, params_np, batches, ch, ad, fl,
                    n_rounds, draws_cache=None):
    """Drive JAX's ``make_round_step(backend="pallas")`` + ``run_rounds``
    and the port's (CPU) over the same params, batches and draws (the
    JAX ``run_rounds`` key chain rebuilt in the port's ``draws_fn``). Returns
    ``(jax (params, state, history), port (params, state, history))``.
    ``draws_cache``, a dict, keeps the draws of each round for runs that
    share the channel, the model and the client count."""
    jch, jad, jfl = jax_configs(ch, ad, fl)
    jstep = j_make_round_step(jmodel.loss_fn, jch, jad, jfl, backend="pallas")
    jp = jax.tree.map(jnp.asarray, params_np)
    key = jax.random.key(1)
    jp_out, js, jhist = j_run_rounds(
        jstep, jp, j_init_server(jp, jad), key,
        lambda t, k: jax.tree.map(jnp.asarray, batches[t]), n_rounds)
    jspec = j_make_slab_spec(jp)
    keys = round_key_chain(key, n_rounds)
    cache = {} if draws_cache is None else draws_cache

    def draws_fn(t):
        if t not in cache:
            cache[t] = ref_draws(keys[t], ch, jspec, fl.n_clients)
        return cache[t]

    tstep = make_round_step(tmodel.loss_fn, ch, ad, fl, device="cpu")
    tp = params_from_numpy(params_np, "cpu")
    tp, ts, thist = run_rounds(tstep, tp, init_server(tp, ad), draws_fn,
                               lambda t: batches[t], n_rounds)
    return (jp_out, js, jhist), (tp, ts, thist)


def assert_trajectories(j, t, tol):
    """Final params, optimizer state (type and structure too) and every
    history record of the two runs of ``run_rounds_both``."""
    (jp, js, jhist), (tp, ts, thist) = j, t
    assert type(ts) is ServerOptState and int(ts.step) == int(js.step)
    assert treedef_str(tree_flatten((tp, ts))[1]) == \
        str(jax.tree.structure((jp, js)))
    for a, b in zip(tree_flatten((tp, ts))[0], jax.tree.leaves((jp, js))):
        assert_close(a, b, tol, tol)
    assert [h["round"] for h in thist] == [h["round"] for h in jhist]
    for th, jh in zip(thist, jhist):
        assert set(th) == set(jh)
        for f in HISTORY:
            np.testing.assert_allclose(th[f], jh[f], rtol=tol, atol=tol,
                                       err_msg=f)
