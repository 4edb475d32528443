"""The port's sharded engine (``repro_torch.core.shard``) on the CPU: its
collectives, the (1,)-mesh against the resident engine, launch counts,
draws and refusals.

* The collectives at P = 2 and (2, 2), one gloo worker process a rank
  (``repro_torch.launch.shard_check.collectives``), against plain torch
  on the gathered inputs: bitwise for the gather and the exchange (int8,
  uint32 words, f32 scales), within f32 rounding for the reduce-scatter
  and the all-reduce; the state boundary (slices out, gathered back)
  bitwise.
* The (1,)-mesh in this process (a one-rank gloo group on a
  ``HashStore``), 5 rounds on the same ``TorchDraws``: the f32 wire
  within 1e-5 of the resident engine for all six optimizers (B3a, a
  reduce-scatter and plain CMS against B2's one pass); the quantized
  wire's state bitwise (the same transmit on the same draws); the
  streamed axis, its dead round (an all-zero mask) included; the
  wrapper calls a round; and JAX's (1,)-mesh on JAX's draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_ref import jax_configs, ref_draws
from repro.core.fl import make_slab_round_runner as j_make_runner
from repro.core.ota import uplink_sr_slab_inputs
from repro.core.shard import shard_round_step as j_shard_round_step
from repro.core.slab_state import init_train_state as j_init
from repro.launch.mesh import make_client_mesh as j_make_client_mesh
from repro.launch.shard_check import _loss_fn as j_quadratic_loss
from repro_torch.core import shard
from repro_torch.core import stream as tstream
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.draws import RoundDraws, TorchDraws
from repro_torch.core.fl import (FLConfig, make_round_step,
                                 make_sharded_round_step,
                                 make_slab_round_runner,
                                 make_slab_round_step)
from repro_torch.core.ota import ota_psum
from repro_torch.core.slab import make_slab_spec, tree_map
from repro_torch.core.slab_state import init_train_state
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.shard_check import (check_params, collective_inputs,
                                            collectives, quadratic_loss)

N, R = 8, 5
OPTIMIZERS = ("adagrad_ota", "adam_ota", "amsgrad_ota", "yogi_ota",
              "fedavgm", "fedavg")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """The (1,)-mesh: a one-rank gloo group in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield launch_mesh.make_client_mesh((1,), "cpu")
    dist.destroy_process_group()


def _inputs(bucketed=False):
    params = check_params(bucketed)
    rng = np.random.default_rng(3)
    batches = {k: rng.normal(size=(R, N) + p.shape).astype(np.float32)
               for k, p in params.items()}
    return params, batches


def _both(mesh, ch, ad, fl, params=None, batches=None, draws_of=None):
    """R rounds on the resident runner and on the (1,)-mesh, the same
    initial state, batches and TorchDraws; returns both final states
    (full width) and metrics."""
    if params is None:
        params, batches = _inputs()
    tp = tree_map(torch.from_numpy, params)
    ef = ch.uplink.error_feedback
    state = init_train_state(ad, tp, error_feedback=ef, device="cpu")
    res_ch = dataclasses.replace(ch, comm_buckets=1)
    prov = TorchDraws(ch, state.spec, N, seed=5, device="cpu",
                      sample_rate=fl.sample_rate)
    draws = [prov(t) for t in range(R)] if draws_of is None else \
        [draws_of(prov(t), t) for t in range(R)]
    a, ma = make_slab_round_runner(quadratic_loss, res_ch, ad, fl,
                                   device="cpu")(state, draws, batches)
    sprov = TorchDraws(ch, state.spec, N, seed=5, device="cpu",
                       sample_rate=fl.sample_rate, shard_index=0)
    sdraws = [sprov(t) for t in range(R)] if draws_of is None else \
        [draws_of(sprov(t), t) for t in range(R)]
    run = make_slab_round_runner(quadratic_loss, ch, ad, fl, device="cpu",
                                 backend="pallas_sharded", mesh=mesh)
    b, mb = run(shard.shard_train_state(state, mesh), sdraws, batches)
    return a, ma, shard.gather_train_state(b, mesh), mb


def _slabs(s):
    return [s.w, *s.opt, s.alpha_hat] + ([s.ef] if s.ef is not None else [])


def _assert_states(a, b, tol):
    assert int(a.step) == int(b.step) == R
    for x, y in zip(_slabs(a), _slabs(b), strict=True):
        if tol == 0:
            assert torch.equal(x, y)
        else:
            torch.testing.assert_close(x, y, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The collectives at P > 1 (gloo worker processes)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(2,), (2, 2)], ids=["p2", "p2x2"])
def gathered(request):
    torch.set_num_threads(1)
    return request.param, launch_mesh.run_on_mesh(
        collectives, request.param, "cpu", args=(11,), timeout=300)


def _expected(shape):
    p = int(np.prod(shape))
    ins = [collective_inputs(11, i, p) for i in range(p)]
    return p, ins


def test_reduce_scatter_is_the_sum_of_each_block(gathered):
    shape, out = gathered
    p, ins = _expected(shape)
    rows = sum(x["rows"].astype(np.float64) for x in ins)
    flat = sum(x["flat"].astype(np.float64) for x in ins)
    for q, got in enumerate(out["ranks"]):
        assert got["idx"] == q
        ln = 256
        np.testing.assert_allclose(got["scatter_rows"],
                                   rows[:, q * ln:(q + 1) * ln], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got["scatter_flat"],
                                   flat[q * ln:(q + 1) * ln], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(
            got["psum"], sum(x["scalar"].astype(np.float64) for x in ins),
            rtol=1e-6, atol=1e-6)


def test_gather_concatenates_in_linear_order_bitwise(gathered):
    shape, out = gathered
    p, ins = _expected(shape)
    for got in out["ranks"]:
        np.testing.assert_array_equal(
            got["gather"], np.concatenate([x["slice"] for x in ins]))
        np.testing.assert_array_equal(
            got["gather_rows"], np.concatenate([x["ef"] for x in ins]))
        assert got["roundtrip"]


@pytest.mark.parametrize("field", ["q", "words", "scales"])
def test_exchange_routes_row_p_to_shard_p_bitwise(gathered, field):
    shape, out = gathered
    p, ins = _expected(shape)
    for q, got in enumerate(out["ranks"]):
        want = np.stack([ins[s][field][q] for s in range(p)])
        assert got[field].dtype == want.dtype
        np.testing.assert_array_equal(got[field], want)


def test_refusals_that_need_several_ranks(gathered):
    shape, out = gathered
    p = int(np.prod(shape))
    assert out["refusals"]["n_clients"].startswith(
        f"n_clients={p + 1} must be divisible by the mesh's client-shard "
        f"count {p}")
    assert "comm_buckets=4 must divide the per-shard 128-block count" in \
        out["refusals"]["comm_buckets"]


# ---------------------------------------------------------------------------
# The (1,)-mesh against the resident engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_f32_one_rank_mesh_matches_resident(mesh, opt):
    ad = AdaptiveConfig(optimizer=opt, lr=0.05, beta2=0.3)
    a, ma, b, mb = _both(mesh, OTAChannelConfig(), ad, FLConfig(n_clients=N))
    _assert_states(a, b, 1e-5)
    for f in ("loss", "grad_norm", "noisy_grad_norm", "fading_mean"):
        torch.testing.assert_close(getattr(ma, f), getattr(mb, f),
                                   rtol=1e-5, atol=1e-5)


QUANTIZED = {
    "int8-ef-dl8-auto": (OTAChannelConfig(
        uplink=UplinkConfig(mode="int8", error_feedback=True),
        downlink="int8"), "auto"),
    "sign-fold-ef": (OTAChannelConfig(
        uplink=UplinkConfig(mode="sign", error_feedback=True)), 1.5),
    "sign-planes-ef": (OTAChannelConfig(
        uplink=UplinkConfig(mode="sign", error_feedback=True,
                            sign_pack="planes")), 1.5),
}


@pytest.mark.parametrize("name", sorted(QUANTIZED))
def test_quantized_one_rank_mesh_state_is_resident_bitwise(mesh, name):
    ch, alpha = QUANTIZED[name]
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, beta2=0.3,
                        alpha=alpha)
    a, ma, b, mb = _both(mesh, ch, ad, FLConfig(n_clients=N))
    _assert_states(a, b, 0)
    assert torch.equal(ma.loss, mb.loss)
    assert torch.equal(ma.noisy_grad_norm, mb.noisy_grad_norm)


STREAMED = {
    "chunk-sampled-weighted": FLConfig(
        n_clients=N, client_chunk=3, sample_rate=0.5,
        client_weights=(1.0, 3.0, 0.5, 2.0, 1.0, 4.0, 0.25, 1.5)),
    "chunk-double-buffered": FLConfig(n_clients=N, client_chunk=2,
                                      double_buffer=True),
}


@pytest.mark.parametrize("name", sorted(STREAMED))
def test_streamed_one_rank_mesh_matches_resident(mesh, name):
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, beta2=0.3,
                        alpha="auto")
    a, ma, b, mb = _both(mesh, OTAChannelConfig(), ad, STREAMED[name])
    _assert_states(a, b, 1e-5)
    assert torch.equal(ma.n_participants, mb.n_participants)


def test_streamed_quantized_one_rank_mesh_is_resident_bitwise(mesh):
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                              error_feedback=True),
                          downlink="int8")
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, beta2=0.3)
    a, _, b, _ = _both(mesh, ch, ad, FLConfig(n_clients=N, client_chunk=3,
                                              sample_rate=0.5))
    _assert_states(a, b, 0)


def test_dead_round_leaves_the_state_as_it_was(mesh):
    """Round 2 built from an all-zero mask: nobody transmits, the server
    update is skipped (state carried over, step advanced) on both
    engines, and the metrics record 0 participants."""
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                              error_feedback=True))
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, beta2=0.3,
                        alpha="auto")
    fl = FLConfig(n_clients=N, client_chunk=4, sample_rate=0.5)

    def dead_at_2(d, t):
        return d if t != 2 else dataclasses.replace(
            d, mask=torch.zeros_like(d.mask))

    a, ma, b, mb = _both(mesh, ch, ad, fl, draws_of=dead_at_2)
    _assert_states(a, b, 0)
    assert float(mb.n_participants[2]) == 0.0 == float(ma.n_participants[2])
    params, batches = _inputs()
    tp = tree_map(torch.from_numpy, params)
    state = shard.shard_train_state(
        init_train_state(ad, tp, error_feedback=True, device="cpu"), mesh)
    prov = TorchDraws(ch, state.spec, N, seed=5, device="cpu",
                      sample_rate=0.5, shard_index=0)
    step = make_slab_round_step(quadratic_loss, ch, ad, fl, device="cpu",
                                backend="pallas_sharded", mesh=mesh)
    state, _ = step(state, prov(0), tree_map(lambda x: x[0], batches))
    after, m = step(state, dead_at_2(prov(1), 2),
                    tree_map(lambda x: x[1], batches))
    assert int(after.step) == int(state.step) + 1
    for x, y in zip(_slabs(after), _slabs(state)):
        assert torch.equal(x, y)
    assert float(m.n_participants) == 0.0


def test_overlap_engine_one_rank_mesh_within_its_tier(mesh):
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, beta2=0.3,
                        alpha="auto")
    params, batches = _inputs(bucketed=True)
    a, ma, b, mb = _both(mesh, OTAChannelConfig(comm_buckets=2), ad,
                         FLConfig(n_clients=N), params, batches)
    _assert_states(a, b, 1e-4)


# ---------------------------------------------------------------------------
# Launch counts a round (the kernel wrappers' calls, counted here)
# ---------------------------------------------------------------------------

class _Calls:
    def __init__(self, monkeypatch):
        self.n = {"B1": 0, "B2": 0, "B3a": 0, "B3b": 0, "B3c": 0, "B4": 0}
        tx, rx = shard.ota_transmit_slab, shard.ota_receive_slab
        upd = shard.slab_update_slabs

        def transmit(grads, h, **kw):
            kind = ("B3c" if kw.get("quantize") else
                    "B3b" if kw.get("acc") is not None else "B3a")
            self.n[kind] += 1
            return tx(grads, h, **kw)

        def receive(*a, **kw):
            self.n["B4"] += 1
            return rx(*a, **kw)

        def update(*a, **kw):
            self.n["B1"] += 1
            return upd(*a, **kw)

        def channel(*a, **kw):
            self.n["B2"] += 1
            raise AssertionError("the sharded round launched B2")

        monkeypatch.setattr(shard, "ota_transmit_slab", transmit)
        # the streamed rounds' chunks fold in core.stream's chunk loop
        monkeypatch.setattr(tstream, "ota_transmit_slab", transmit)
        monkeypatch.setattr(shard, "ota_receive_slab", receive)
        monkeypatch.setattr(shard, "slab_update_slabs", update)
        import repro_torch.core.ota as ota
        import repro_torch.kernels.ota_channel as kernels
        monkeypatch.setattr(ota, "ota_channel_slab", channel)
        monkeypatch.setattr(kernels, "ota_channel_slab", channel)


COUNTS = {
    "f32": (OTAChannelConfig(), FLConfig(n_clients=N),
            {"B1": 1, "B3a": 1}),
    "int8-ef": (OTAChannelConfig(uplink=UplinkConfig(
        mode="int8", error_feedback=True)), FLConfig(n_clients=N),
        {"B1": 1, "B3c": 2, "B4": 2}),
    "sign-fold-ef": (OTAChannelConfig(uplink=UplinkConfig(
        mode="sign", error_feedback=True)), FLConfig(n_clients=N),
        {"B1": 1, "B3c": 2, "B4": 2}),
    "streamed-f32": (OTAChannelConfig(), FLConfig(n_clients=N,
                                                  client_chunk=2),
                     {"B1": 1, "B3b": 4}),
    "streamed-int8": (OTAChannelConfig(uplink=UplinkConfig(mode="int8")),
                      FLConfig(n_clients=N, client_chunk=4),
                      {"B1": 1, "B3b": 2, "B3c": 2, "B4": 2}),
}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_launches_a_round(mesh, monkeypatch, name):
    ch, fl, want = COUNTS[name]
    calls = _Calls(monkeypatch)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05)
    params, batches = _inputs()
    tp = tree_map(torch.from_numpy, params)
    state = shard.shard_train_state(init_train_state(
        ad, tp, error_feedback=ch.uplink.error_feedback, device="cpu"), mesh)
    prov = TorchDraws(ch, state.spec, N, device="cpu", shard_index=0)
    step = shard.make_shard_slab_step(quadratic_loss, ch, ad, fl, mesh,
                                      device="cpu")
    for t in range(2):
        state, _ = step(state, prov(t), tree_map(lambda x: x[t], batches))
    assert calls.n == {k: 2 * want.get(k, 0) for k in calls.n}


# ---------------------------------------------------------------------------
# Against JAX's (1,)-mesh on JAX's own draws
# ---------------------------------------------------------------------------

def test_one_rank_mesh_matches_jax_on_its_draws(mesh):
    """int8 + EF + the int8 downlink + alpha "auto": the port's (1,)-mesh
    on ``ref_draws(..., shard_index=0)`` against JAX's pallas_sharded
    (1,)-mesh, 3 rounds, at 1e-5."""
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                              error_feedback=True),
                          downlink="int8")
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, beta2=0.3,
                        alpha="auto")
    fl = FLConfig(n_clients=N)
    params, batches = _inputs()
    jch, jad, jfl = jax_configs(ch, ad, fl, backend="pallas_sharded")
    jstate = j_init(jad, jax.tree.map(jnp.asarray, params),
                    error_feedback=True)
    keys = [jax.random.fold_in(jax.random.key(7), t) for t in range(3)]
    jrun = j_make_runner(j_quadratic_loss, jch, jad, jfl,
                         backend="pallas_sharded",
                         mesh=j_make_client_mesh((1,)))
    jb = jax.tree.map(lambda b: jnp.asarray(b[:3]), batches)
    jstate, jms = jrun(jstate, jnp.stack(keys), jb)
    draws = [ref_draws(k, ch, jstate.spec, N, shard_index=0) for k in keys]
    tp = tree_map(torch.from_numpy, params)
    state = shard.shard_train_state(init_train_state(
        ad, tp, error_feedback=True, device="cpu"), mesh)
    run = make_slab_round_runner(quadratic_loss, ch, ad, fl, device="cpu",
                                 backend="pallas_sharded", mesh=mesh)
    state, ms = run(state, draws, tree_map(lambda b: b[:3], batches))
    state = shard.gather_train_state(state, mesh)
    for x, y in zip(_slabs(state), [jstate.w, *jstate.opt, jstate.alpha_hat,
                                    jstate.ef]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)
    for f in ("loss", "grad_norm", "noisy_grad_norm", "alpha_hat"):
        np.testing.assert_allclose(getattr(ms, f).numpy(),
                                   np.asarray(getattr(jms, f)), rtol=1e-5,
                                   atol=1e-5)


def test_ref_draws_carry_each_transmitters_rounding():
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8"))
    jspec = make_slab_spec({"w": np.zeros(300, np.float32)}, shards=2)
    key = jax.random.key(3)
    plain = ref_draws(key, ch, jspec, N)
    for p in range(2):
        d = ref_draws(key, ch, jspec, N, shard_index=p)
        rows = np.asarray(uplink_sr_slab_inputs(key, jspec, p))
        assert d.shard == p
        np.testing.assert_array_equal(d.r_up.numpy(), rows[0])
        np.testing.assert_array_equal(d.r_clean.numpy(), rows[1])
        for f in ("h", "u", "e"):
            assert torch.equal(getattr(d, f), getattr(plain, f))
    np.testing.assert_array_equal(
        ref_draws(key, ch, jspec, N, shard_index=0).r_up, plain.r_up)


# ---------------------------------------------------------------------------
# Draws of a transmitter (TorchDraws)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inkernel", [False, True])
def test_torch_draws_of_transmitter_zero_are_the_single_device_draws(
        inkernel):
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                              sr_inkernel=inkernel),
                          downlink="int8")
    spec = make_slab_spec({"w": np.zeros(300, np.float32)}, shards=2)
    plain = TorchDraws(ch, spec, N, seed=4, device="cpu", sample_rate=0.5)
    ranks = [TorchDraws(ch, spec, N, seed=4, device="cpu", sample_rate=0.5,
                        shard_index=p) for p in range(2)]
    for t in (0, 7):
        d, d0, d1 = plain(t), ranks[0](t), ranks[1](t)
        assert d.shard is None and (d0.shard, d1.shard) == (0, 1)
        for f in ("h", "u", "e", "r_dl", "mask"):
            assert torch.equal(getattr(d0, f), getattr(d, f))
            assert torch.equal(getattr(d1, f), getattr(d, f))
        assert torch.equal(d0.r_up, d.r_up) and d0.sr_seed == d.sr_seed
        assert d.r_clean is None and d.sr_seed_clean is None
        assert not torch.equal(d1.r_up, d.r_up)
        assert not torch.equal(d0.r_clean, d1.r_clean)
        assert len({d0.r_clean[0].item(), d0.r_up[0].item()}) == 2
        if inkernel:
            seeds = {d0.sr_seed, d0.sr_seed_clean, d1.sr_seed,
                     d1.sr_seed_clean}
            assert len(seeds) == 4
        r = torch.cat([d0.r_clean, d1.r_up, d1.r_clean])
        assert float(r.min()) >= 0.0 and float(r.max()) < 1.0
    with pytest.raises(ValueError, match="shard_index must be in"):
        TorchDraws(ch, spec, N, device="cpu", shard_index=2)


def test_draws_for_another_transmitter_are_refused(mesh):
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8"))
    ad = AdaptiveConfig()
    params, batches = _inputs()
    tp = tree_map(torch.from_numpy, params)
    state = shard.shard_train_state(init_train_state(ad, tp, device="cpu"),
                                    mesh)
    step = shard.make_shard_slab_step(quadratic_loss, ch, ad,
                                      FLConfig(n_clients=N), mesh,
                                      device="cpu")
    plain = TorchDraws(ch, state.spec, N, device="cpu")(0)
    with pytest.raises(ValueError, match="made for transmitter None"):
        step(state, plain, tree_map(lambda x: x[0], batches))


# ---------------------------------------------------------------------------
# Refusals and the per-leaf round
# ---------------------------------------------------------------------------

def _loss():
    return quadratic_loss


@pytest.mark.parametrize("kw,match", [
    (dict(backend="pallas_sharded", mesh=object()),
     "DeviceMesh over an initialised process group"),
    (dict(backend="pallas_sharded", mesh=(2,)),
     "DeviceMesh over an initialised process group"),
])
def test_a_mesh_needs_a_device_mesh_over_a_process_group(kw, match):
    for make in (make_slab_round_step, make_slab_round_runner):
        with pytest.raises(ValueError, match=match):
            make(_loss(), OTAChannelConfig(), AdaptiveConfig(),
                 FLConfig(n_clients=N), device="cpu", **kw)


def test_a_cuda_mesh_larger_than_the_card_count_is_refused(monkeypatch):
    with pytest.raises(ValueError, match="this machine has 0"):
        launch_mesh.check_cards(2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    launch_mesh.check_cards(1, "cuda")
    with pytest.raises(ValueError, match="needs 2 cards.*has 1.*--mesh 1"):
        launch_mesh.check_cards(2, "cuda")
    launch_mesh.check_cards(8, "cpu")


def test_a_cuda_round_on_a_gloo_mesh_is_refused(mesh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="cpu mesh, the round runs on cuda"):
        shard.make_shard_slab_step(_loss(), OTAChannelConfig(),
                                   AdaptiveConfig(), FLConfig(n_clients=N),
                                   mesh, device="cuda")


def test_resident_refusals_match_jax(mesh):
    """shard_round_step refuses alpha "auto" and error feedback with the
    JAX package's words."""
    ad_auto = AdaptiveConfig(alpha="auto")
    ch_ef = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                                 error_feedback=True))
    jmesh = j_make_client_mesh((1,))
    for ch, ad in ((OTAChannelConfig(), ad_auto), (ch_ef, AdaptiveConfig())):
        fl = FLConfig(n_clients=N)
        with pytest.raises(ValueError) as got:
            shard.shard_round_step(_loss(), ch, ad, fl, mesh, device="cpu")
        with pytest.raises(ValueError) as want:
            j_shard_round_step(j_quadratic_loss,
                               *jax_configs(ch, ad, fl, "pallas_sharded"),
                               jmesh)
        assert str(got.value) == str(want.value)


def test_per_round_api_on_one_rank_mesh_matches_resident_api(mesh):
    params, batches = _inputs()
    tp = tree_map(torch.from_numpy, params)
    ad = AdaptiveConfig(optimizer="amsgrad_ota", lr=0.05)
    ch, fl = OTAChannelConfig(), FLConfig(n_clients=N)
    spec = make_slab_spec(tp)
    prov = TorchDraws(ch, spec, N, seed=2, device="cpu", shard_index=0)
    from repro_torch.core.fl import init_server
    a = make_round_step(_loss(), ch, ad, fl, device="cpu")
    b = make_round_step(_loss(), ch, ad, fl, device="cpu",
                        backend="pallas_sharded", mesh=mesh)
    pa, sa = tp, init_server(tp, ad)
    pb, sb = tp, init_server(tp, ad)
    for t in range(3):
        batch = tree_map(lambda x: x[t], batches)
        pa, sa, _ = a(pa, sa, prov(t), batch)
        pb, sb, _ = b(pb, sb, prov(t), batch)
    for x, y in zip(jax.tree.leaves((pa, sa)), jax.tree.leaves((pb, sb))):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_ota_psum_refuses_a_quantized_uplink_with_jax_words(mesh):
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8"))
    spec = make_slab_spec({"w": np.zeros(3, np.float32)})
    draws = TorchDraws(ch, spec, 1, device="cpu")(0)
    with pytest.raises(NotImplementedError) as got:
        ota_psum({"w": torch.ones(3)}, draws, ch, mesh, ("data",))
    body = make_sharded_round_step(_loss(), ch, AdaptiveConfig(), mesh)
    with pytest.raises(NotImplementedError):
        body({"w": torch.ones(3)}, None, draws, {"w": torch.ones(1, 3)})
    want = ("ota_psum / make_sharded_round_step do not implement the "
            "quantized uplink (uplink='int8'); use the slab engine "
            "(backend='pallas_sharded', repro_torch.core.shard) for the "
            "int8 MAC")
    assert str(got.value) == want


def test_ota_psum_on_one_rank_is_the_faded_gradient_plus_interference(mesh):
    ch = OTAChannelConfig()
    g = {"a": torch.randn(3, 5), "b": torch.randn(7)}
    spec = make_slab_spec(g)
    draws = TorchDraws(ch, spec, 1, seed=1, device="cpu")(0)
    from repro_torch.core.ota import add_interference
    want = add_interference(draws, ch, tree_map(lambda x: draws.h[0] * x, g))
    got = ota_psum(g, draws, ch, mesh, ("data",))
    for k in g:
        assert torch.equal(got[k], want[k])
    bad = dataclasses.replace(draws, h=torch.ones(2))
    with pytest.raises(ValueError, match=r"one fading draw a client group, "
                                         r"\(1,\)"):
        ota_psum(g, bad, ch, mesh, ("data",))


def test_round_draws_move_their_shard_fields():
    d = RoundDraws(torch.ones(2), torch.zeros(4), torch.ones(4),
                   r_clean=torch.full((4,), 0.5), sr_seed_clean=9, shard=1)
    m = d.to("cpu")
    assert torch.equal(m.r_clean, d.r_clean)
    assert (m.sr_seed_clean, m.shard) == (9, 1)
