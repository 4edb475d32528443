"""The port's streamed client axis against the JAX package's, on the CPU.

Covers ``repro_torch.core.stream`` and the streamed transmit's plain
version: the accumulating transmit (``acc=``, ``row_chunk=``) against
the JAX oracle and the JAX Pallas kernel in interpret mode; one streamed
uplink pass (serial, double-buffered, ragged and single-chunk loops on
the f32, int8 + EF and folded-sign + EF wires, pilot statistics on)
against ``repro.core.stream.streamed_round_parts`` with
``use_kernels`` True and False; the dead round; ``batch_gen``; the
participation draw; and the refusals. The 5-round trajectories are in
``tests/test_torch_stream_round.py``.

Tiers: 1e-6 of the output's scale for the transmit (an f32 sum in
another order), 1e-5 for a streamed pass and for rounds (the trajectory
tier of ``tests/test_backend_parity.py``); a dead round leaves the state
bitwise unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from _torch_ref import (assert_close, assert_states, jax_configs, ref_draws,
                        to_np)
from repro.core.fl import make_slab_round_runner as j_make_runner
from repro.core.fl import make_slab_round_step as j_make_step
from repro.core.slab import make_slab_spec as j_make_slab_spec
from repro.core.slab_state import init_train_state as j_init
from repro.core.stream import round_participation as j_round_participation
from repro.core.stream import streamed_round_parts as j_streamed_round_parts
from repro.kernels.ota_channel import ota_transmit_slab as j_transmit_slab
from repro.kernels.ref import ota_transmit_ref as j_transmit_ref
from repro.models import vision as jvision
from repro_torch.convert import params_from_numpy
from repro_torch.core import stream as tstream
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.draws import RoundDraws, TorchDraws
from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                 make_slab_round_step, run_rounds_slab)
from repro_torch.core.round import client_update
from repro_torch.core.slab import make_slab_spec
from repro_torch.core.slab_state import init_train_state
from repro_torch.kernels import ota_channel as tkern
from repro_torch.kernels import ref as tref
from repro_torch.models import vision as tvision

N, D, C, B = 8, 8, 4, 5
TOL = 1e-5
WEIGHTS = (4.0, 2.0, 7.0, 1.0, 3.0, 5.0, 2.0, 8.0)   # dataset sizes
WIRES = {
    "f32": UplinkConfig(),
    "int8-ef": UplinkConfig(mode="int8", error_feedback=True),
    "sign-fold-ef": UplinkConfig(mode="sign", error_feedback=True,
                                 sign_pack="fold"),
}


def _logreg_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (0.1 * rng.normal(size=(D, C))).astype(np.float32),
            "b": (0.1 * rng.normal(size=(C,))).astype(np.float32)}


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(N, B, D)).astype(np.float32),
            "y": rng.integers(0, C, (N, B)).astype(np.int64)}


def _models():
    return (jvision.logistic_regression(D, C),
            tvision.logistic_regression(D, C))


# ---------------------------------------------------------------------------
# The streamed transmit (B3b's plain version)
# ---------------------------------------------------------------------------

def _scale_close(got, want, what):
    got, want = to_np(got), to_np(want)
    tol = 1e-6 * np.abs(want) + 1e-6 * float(np.abs(want).max())
    err = np.abs(got - want)
    assert np.all(err <= tol), f"{what}: max err {err.max()}"


@pytest.mark.parametrize("d", [301, 256])
@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("row_chunk", [None, 1, 3, 12])
def test_stream_transmit_ref_matches_jax(row_chunk, with_acc, d):
    n, n_total = 12, 5                   # n_total != N, as under weights
    rng = np.random.default_rng(d + (row_chunk or 0))
    g = rng.normal(size=(n, d)).astype(np.float32)
    h = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    acc = rng.normal(size=(d,)).astype(np.float32) if with_acc else None
    kw = dict(n_total=n_total, row_chunk=row_chunk)
    jkw = dict(kw, acc=None if acc is None else jnp.asarray(acc))
    tkw = dict(kw, acc=None if acc is None else torch.from_numpy(acc))
    if row_chunk is None and acc is None:
        jkw["acc"] = jnp.zeros((d,), jnp.float32)   # select the stream path
    want = j_transmit_ref(jnp.asarray(g), jnp.asarray(h), **jkw)
    kern = j_transmit_slab(jnp.asarray(g), jnp.asarray(h), interpret=True,
                           **jkw)
    before = tkern.ota_transmit_slab.stream_launches
    got = tref.ota_transmit_ref(torch.from_numpy(g), torch.from_numpy(h),
                                **tkw)
    wrapped = tkern.ota_transmit_slab(torch.from_numpy(g),
                                      torch.from_numpy(h), **tkw)
    assert tkern.ota_transmit_slab.stream_launches == before   # CPU: plain
    assert torch.equal(got, wrapped)
    assert got.shape == (d,) and got.dtype == torch.float32
    _scale_close(got, want, "vs JAX ota_transmit_ref")
    _scale_close(got, kern, "vs JAX ota_transmit_slab (interpret)")


def test_f32_transmit_without_carry_is_the_resident_sum():
    """B3a: ``quantize=False`` without ``acc`` is the faded partial sum,
    and equals the one-chunk, zero-carry stream (0 + x == x in f32)."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(6, 384)).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.5, 1.5, size=(6,)).astype(np.float32))
    full = tkern.ota_transmit_slab(g, h)
    assert torch.equal(full, torch.sum(h[:, None] * g, dim=0) / 6)
    assert torch.equal(full, tkern.ota_transmit_slab(
        g, h, acc=torch.zeros(384), row_chunk=6))
    want = j_transmit_ref(jnp.asarray(g.numpy()), jnp.asarray(h.numpy()))
    _scale_close(full, want, "B3a vs JAX ota_transmit_ref")


def test_stream_transmit_refusals():
    g, h = torch.zeros((4, 128)), torch.ones(4)
    with pytest.raises(ValueError, match="quantize"):
        tkern.ota_transmit_slab(g, h, quantize=True, acc=torch.zeros(128))
    with pytest.raises(ValueError, match="quantize"):
        tkern.ota_transmit_slab(g, h, quantize=True, row_chunk=2,
                                stochastic=False)
    with pytest.raises(ValueError, match="quantize"):
        tref.ota_transmit_ref(g, h, quantize=True, acc=torch.zeros(128))
    with pytest.raises(ValueError, match="row_chunk"):
        tkern.ota_transmit_slab(g, h, row_chunk=0)
    with pytest.raises(ValueError, match="row_chunk"):
        tref.ota_transmit_ref(g, h, row_chunk=0)
    with pytest.raises(ValueError, match="acc must be"):
        tkern.ota_transmit_slab(g, h, acc=torch.zeros(64))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tkern.ota_transmit_slab(torch.empty((2, 8), device="meta"),
                                torch.empty(2, device="meta"), row_chunk=1)


# ---------------------------------------------------------------------------
# One streamed uplink pass against repro.core.stream
# ---------------------------------------------------------------------------

LOOPS = {
    "serial": dict(client_chunk=2),
    "double": dict(client_chunk=2, double_buffer=True, sample_rate=0.5),
    "ragged": dict(client_chunk=3, sample_rate=0.5, client_weights=WEIGHTS),
    "single": dict(client_chunk=N),
}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_streamed_round_parts_match_jax(loop, wire, use_kernels):
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1, uplink=WIRES[wire])
    ad = AdaptiveConfig()
    fl = FLConfig(n_clients=N, **LOOPS[loop])
    jch, _, jfl = jax_configs(ch, ad, fl)
    jmodel, tmodel = _models()
    params = _logreg_params()
    batch = _batch()
    jspec = j_make_slab_spec(jax.tree.map(jnp.asarray, params))
    spec = make_slab_spec(params_from_numpy(params, "cpu"))
    quantized = ch.uplink.quantized
    ef = (np.random.default_rng(2).normal(size=(spec.padded,))
          .astype(np.float32) * 1e-3) if quantized else None
    if ef is not None:
        ef[spec.total:] = 0.0
    key = jax.random.key(11)

    def jclient(p, b):
        return jax.grad(jmodel.loss_fn)(p, b), jmodel.loss_fn(p, b)

    want = j_streamed_round_parts(
        key, jch, jfl, jspec, jclient, jax.tree.map(jnp.asarray, params),
        client_batches=jax.tree.map(jnp.asarray, batch), pilot_stats=True,
        use_kernels=use_kernels,
        ef=None if ef is None else jnp.asarray(ef))
    got = tstream.streamed_round_parts(
        ref_draws(key, ch, jspec, N, fl.sample_rate), ch, fl, spec,
        vmap(client_update(tmodel.loss_fn, fl), in_dims=(None, 0)),
        params_from_numpy(params, "cpu"),
        client_batches={k: torch.from_numpy(v) for k, v in batch.items()},
        pilot_stats=True, ef=None if ef is None else torch.from_numpy(ef))
    for f in ("g_slab", "h", "mask", "n_participants", "norm", "loss_sum",
              "clean_slab", "stats"):
        assert_close(getattr(got, f), getattr(want, f), TOL, TOL, f)
    assert (got.ef_new is None) == (want.ef_new is None) == (not quantized)
    if quantized:
        assert_close(got.ef_new, want.ef_new, TOL, TOL, "ef_new")


# ---------------------------------------------------------------------------
# The dead round
# ---------------------------------------------------------------------------

def _dead_key(fl):
    """The first key(k) whose participation draw is empty: the JAX side
    of a dead round, found by search (the draw's bits depend on the jax
    version, so no pinned key)."""
    jfl = jax_configs(OTAChannelConfig(), AdaptiveConfig(), fl)[2]
    for k in range(1000):
        if float(jnp.sum(j_round_participation(jax.random.key(k),
                                               jfl)[0])) == 0.0:
            return jax.random.key(k)
    raise AssertionError("no dead round in 1000 keys")


@pytest.mark.parametrize("wire,alpha", [("f32", 1.5), ("int8-ef", "auto")])
def test_dead_round_matches_jax_and_keeps_the_state(wire, alpha):
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1, uplink=WIRES[wire])
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=alpha,
                        beta2=0.3)
    fl = FLConfig(n_clients=N, sample_rate=0.05, client_chunk=3)
    jch, jad, jfl = jax_configs(ch, ad, fl)
    jmodel, tmodel = _models()
    params = _logreg_params()
    ef = ch.uplink.error_feedback
    jstep = j_make_step(jmodel.loss_fn, jch, jad, jfl, backend="pallas")
    tstep = make_slab_round_step(tmodel.loss_fn, ch, ad, fl, device="cpu")
    jstate = j_init(jad, jax.tree.map(jnp.asarray, params),
                    error_feedback=ef)
    tstate = init_train_state(ad, params_from_numpy(params, "cpu"),
                              error_feedback=ef, device="cpu")
    # one live round (all clients in) first, so the state is not zero
    live = jax.random.key(5)
    live_draws = ref_draws(live, ch, jstate.spec, N, fl.sample_rate)
    live_draws = RoundDraws(**{**live_draws.__dict__,
                               "mask": torch.ones(N)})
    tstate, _ = tstep(tstate, live_draws, _batch(3))
    key = _dead_key(fl)
    draws = ref_draws(key, ch, jstate.spec, N, fl.sample_rate)
    assert float(draws.mask.sum()) == 0.0
    before = tstate
    tstate, tm = tstep(tstate, draws, _batch(4))
    assert int(tstate.step) == int(before.step) + 1
    for a, b in ((tstate.w, before.w), (tstate.alpha_hat, before.alpha_hat),
                 *zip(tstate.opt, before.opt)):
        assert torch.equal(a, b)
    if ef:
        assert torch.equal(tstate.ef, before.ef)
    assert float(tm.n_participants) == 0.0 and np.isfinite(float(tm.loss))
    # the JAX round on the same dead key: also skipped, same metrics
    j0 = jstate
    jstate, jm = jstep(jstate, key, jax.tree.map(jnp.asarray, _batch(4)))
    assert np.array_equal(np.asarray(jstate.w), np.asarray(j0.w))
    assert float(jm.n_participants) == 0.0
    for f in ("loss", "grad_norm", "fading_mean", "n_participants"):
        assert_close(getattr(tm, f), getattr(jm, f), TOL, TOL, f)


def test_dead_round_from_explicit_mask_and_torch_draws():
    """The port's own draws with an all-zero mask: the update is skipped
    on every wire, and the logged history says so once per interval."""
    model = tvision.logistic_regression(D, C)
    ad = AdaptiveConfig(optimizer="adagrad_ota", lr=0.05, alpha="auto")
    fl = FLConfig(n_clients=N, sample_rate=0.5, client_weights=WEIGHTS)
    for wire in WIRES.values():
        ch = OTAChannelConfig(uplink=wire)
        ef = wire.error_feedback
        state = init_train_state(ad, model.init(seed=0, device="cpu"),
                                 error_feedback=ef, device="cpu")
        provider = TorchDraws(ch, state.spec, N, seed=2, device="cpu",
                              sample_rate=0.5)
        step = make_slab_round_step(model.loss_fn, ch, ad, fl, device="cpu")
        state, _ = step(state, provider(0), _batch())
        dead = RoundDraws(**{**provider(1).__dict__,
                             "mask": torch.zeros(N)})
        new, m = step(state, dead, _batch())
        assert torch.equal(new.w, state.w)
        assert all(torch.equal(a, b) for a, b in zip(new.opt, state.opt))
        assert torch.equal(new.alpha_hat, state.alpha_hat)
        assert (not ef) or torch.equal(new.ef, state.ef)
        assert int(new.step) == 2 and float(m.n_participants) == 0.0
        assert np.isfinite(float(m.loss)) and float(m.loss) == 0.0

    run = make_slab_round_runner(model.loss_fn, OTAChannelConfig(), ad, fl,
                                 device="cpu")
    state = init_train_state(ad, model.init(seed=0, device="cpu"),
                             device="cpu")
    provider = TorchDraws(OTAChannelConfig(), state.spec, N, seed=2,
                          device="cpu", sample_rate=0.5)

    def draws_fn(t):
        d = provider(t)
        return RoundDraws(**{**d.__dict__, "mask": torch.zeros(N)}) \
            if t in (1, 2, 4) else d

    lines = []
    state, hist = run_rounds_slab(run, state, draws_fn, lambda t: _batch(t),
                                  6, chunk=2, log_every=3, log=lines.append)
    assert [h["n_participants"] == 0.0 for h in hist] == [
        False, True, True, False, True, False]
    warnings = [x for x in lines if "WARNING" in x]
    assert warnings == [
        "rounds 2-3  WARNING: 2 dead round(s) — no participants, server "
        "update skipped; consider a higher sample_rate",
        "round     5  WARNING: 1 dead round(s) — no participants, server "
        "update skipped; consider a higher sample_rate"]
    assert int(state.step) == 6


# ---------------------------------------------------------------------------
# batch_gen, the runner and the driver
# ---------------------------------------------------------------------------

def _phase_loss(p, b):
    return (p["w"] - b["phase"].sin()).square().mean()


def test_batch_gen_matches_materialised_batches_and_jax():
    """In-graph batches: the port's ``batch_gen(draws, idx)`` against the
    same batches materialised, and against the JAX runner's
    ``batch_gen(key, idx)`` over the same draws (the JAX package's
    streamed benchmark loss, at d = 64)."""
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.02, alpha=1.5)
    fl = FLConfig(n_clients=16, client_chunk=5, sample_rate=0.75)
    w0 = np.random.default_rng(0).normal(size=(64,)).astype(np.float32)
    rounds = 3
    keys = [jax.random.fold_in(jax.random.key(7), t) for t in range(rounds)]
    jch, jad, jfl = jax_configs(ch, ad, fl)

    def j_loss(p, b):
        return jnp.mean((p["w"] - jnp.sin(b["phase"])) ** 2)

    jrun = j_make_runner(j_loss, jch, jad, jfl, backend="pallas",
                         batch_gen=lambda k, idx: {
                             "phase": idx.astype(jnp.float32) * 1e-1})
    jstate, jms = jrun(j_init(jad, {"w": jnp.asarray(w0)}), jnp.stack(keys))

    def gen(draws, idx):
        return {"phase": idx.to(torch.float32) * 1e-1}

    tstate0 = init_train_state(ad, {"w": torch.from_numpy(w0)},
                               device="cpu")
    run = make_slab_round_runner(_phase_loss, ch, ad, fl, device="cpu",
                                 batch_gen=gen)
    draws = [ref_draws(k, ch, jstate.spec, 16, fl.sample_rate) for k in keys]
    tstate, tms = run(tstate0, draws)
    assert_states(jstate, tstate, TOL)
    for f in ("loss", "n_participants", "grad_norm"):
        assert_close(getattr(tms, f), getattr(jms, f), TOL, TOL, f)
    with pytest.raises(ValueError, match="no materialised"):
        run(tstate0, draws, {"phase": torch.zeros(rounds, 16)})

    # the same data materialised (batch_fn) -> the same state, bitwise
    mat = make_slab_round_runner(_phase_loss, ch, ad, fl, device="cpu")
    phase = {"phase": torch.arange(16, dtype=torch.float32) * 1e-1}
    s_mat, _ = run_rounds_slab(mat, tstate0, lambda t: draws[t],
                               lambda t: phase, rounds)
    s_gen, hist = run_rounds_slab(run, tstate0, lambda t: draws[t],
                                  lambda t: None, rounds)
    assert torch.equal(s_mat.w, s_gen.w) and torch.equal(s_gen.w, tstate.w)
    assert len(hist) == rounds


# ---------------------------------------------------------------------------
# The participation draw
# ---------------------------------------------------------------------------

def test_sample_rate_one_draws_nothing_more():
    """``sample_rate >= 1`` draws no mask and leaves every existing field
    bitwise as before; a rate below 1 draws the mask after them, so the
    other fields stay bitwise the same too."""
    spec = make_slab_spec(tvision.mlp(12, 3, hidden=10).init(device="cpu"))
    for ch in (OTAChannelConfig(),
               OTAChannelConfig(uplink=UplinkConfig(mode="int8"),
                                downlink="int8"),
               OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                                    sr_inkernel=True))):
        base = TorchDraws(ch, spec, N, seed=4, device="cpu")(3)
        one = TorchDraws(ch, spec, N, seed=4, device="cpu",
                         sample_rate=1.0)(3)
        half = TorchDraws(ch, spec, N, seed=4, device="cpu",
                          sample_rate=0.5)(3)
        assert base.mask is None and one.mask is None
        for d in (one, half):
            for f in ("h", "u", "e", "r_up", "r_dl"):
                a, b = getattr(base, f), getattr(d, f)
                assert (a is None and b is None) or torch.equal(a, b), f
            assert d.sr_seed == base.sr_seed
        m = half.mask
        assert m.shape == (N,) and m.dtype == torch.float32
        assert bool(torch.all((m == 0) | (m == 1)))
    many = TorchDraws(OTAChannelConfig(), spec, 4000, seed=1, device="cpu",
                      sample_rate=0.25)(0).mask
    assert abs(float(many.mean()) - 0.25) < 0.03
    with pytest.raises(ValueError, match="sample_rate"):
        TorchDraws(OTAChannelConfig(), spec, N, device="cpu",
                   sample_rate=0.0)
    d0 = tstream.participation_mask(N, 1.0, torch.Generator())
    assert torch.equal(d0, torch.ones(N))


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_streamed_round_refusals():
    model = tvision.logistic_regression(D, C)
    ch, ad = OTAChannelConfig(), AdaptiveConfig()
    stream_fl = FLConfig(n_clients=N, client_chunk=3)
    with pytest.raises(ValueError, match="streamed round config"):
        make_slab_round_step(model.loss_fn, ch, ad, FLConfig(n_clients=N),
                             device="cpu", batch_gen=lambda d, i: None)
    with pytest.raises(ValueError, match="streamed round config"):
        make_slab_round_runner(model.loss_fn, ch, ad, FLConfig(n_clients=N),
                               device="cpu", batch_gen=lambda d, i: None)
    # the sharded engine's options without its mesh
    for fl, kw, match in (
            (stream_fl, dict(backend="pallas_sharded"), "needs a mesh"),
            (FLConfig(n_clients=N, sample_rate=0.5), {},
             "comm_buckets > 1 buckets the sharded MAC collective")):
        c = ch if kw else OTAChannelConfig(comm_buckets=2)
        with pytest.raises(ValueError, match=match):
            make_slab_round_step(model.loss_fn, c, ad, fl, device="cpu", **kw)
    with pytest.raises(ValueError, match="only supported by the streamed "
                                         "single-device backends"):
        make_slab_round_step(model.loss_fn, ch, ad, stream_fl, device="cpu",
                             backend="pallas_sharded", mesh=object(),
                             batch_gen=lambda d, i: None)
    state = init_train_state(ad, model.init(device="cpu"), device="cpu")
    provider = TorchDraws(ch, state.spec, N, device="cpu")
    step = make_slab_round_step(model.loss_fn, ch, ad, stream_fl,
                                device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        step(state, provider(0), None)
    sampled = make_slab_round_step(model.loss_fn, ch, ad,
                                   FLConfig(n_clients=N, sample_rate=0.5),
                                   device="cpu")
    with pytest.raises(ValueError, match="needs draws.mask"):
        sampled(state, provider(0), _batch())
    masked = RoundDraws(**{**provider(0).__dict__, "mask": torch.ones(N)})
    with pytest.raises(ValueError, match="draws.mask is set"):
        step(state, masked, _batch())
    resident = make_slab_round_step(model.loss_fn, ch, ad,
                                    FLConfig(n_clients=N), device="cpu")
    with pytest.raises(ValueError, match="draws.mask is set"):
        resident(state, masked, _batch())
    spec = state.spec
    with pytest.raises(ValueError, match="needs a quantized uplink"):
        tstream.streamed_round_parts(
            provider(0), ch, stream_fl, spec, None, None,
            client_batches=_batch(), ef=torch.zeros(spec.padded))
