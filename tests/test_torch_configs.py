"""The port's configs, device policy and refusals.

* The config dataclasses mirror the JAX package's field for field, with
  the same defaults and the same checks; the only difference is that
  the port has no ``backend`` / ``interpret`` fields (the device
  decides).
* Every entry point runs on the card by default and raises without one
  unless the caller asks for the CPU.
* Every configuration this slice does not port raises
  ``NotImplementedError`` naming the ROADMAP item that brings it.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, jax_channel_config
from repro.core import adaptive as jadaptive
from repro.core import channel as jchannel
from repro.core import fl as jfl
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.core import adaptive as tadaptive
from repro_torch.core import channel as tchannel
from repro_torch.core import fl as tfl
from repro_torch.core.draws import TorchDraws
from repro_torch.core.slab import make_slab_spec
from repro_torch.core.slab_state import init_train_state
from repro_torch.device import resolve_device
from repro_torch.models import vision as tvision

PAIRS = [
    (tchannel.UplinkConfig, jchannel.UplinkConfig),
    (tchannel.OTAChannelConfig, jchannel.OTAChannelConfig),
    (tadaptive.AdaptiveConfig, jadaptive.AdaptiveConfig),
    (tfl.FLConfig, jfl.FLConfig),
]
# The one deliberate difference: no backend switch in the port.
DROPPED = {"backend", "interpret"}


@pytest.mark.parametrize("ours,theirs", PAIRS,
                         ids=[p[0].__name__ for p in PAIRS])
def test_config_fields_and_defaults_mirror_jax(ours, theirs):
    mine = {f.name: f.default for f in dataclasses.fields(ours)}
    ref = {f.name: f.default for f in dataclasses.fields(theirs)}
    dropped = set(ref) - set(mine)
    assert dropped == (DROPPED & set(ref))
    assert set(mine) <= set(ref)
    for name in mine:
        assert mine[name] == ref[name] or (
            dataclasses.is_dataclass(mine[name])
            and dataclasses.asdict(mine[name])
            == dataclasses.asdict(ref[name])), name


BAD = [
    (tchannel.UplinkConfig, dict(mode="fp8")),
    (tchannel.UplinkConfig, dict(block=64)),
    (tchannel.UplinkConfig, dict(error_feedback=True)),
    (tchannel.UplinkConfig, dict(mode="sign", sign_pack="nibble")),
    (tchannel.UplinkConfig, dict(mode="sign", sr_inkernel=True)),
    (tchannel.OTAChannelConfig, dict(alpha=1.0)),
    (tchannel.OTAChannelConfig, dict(alpha=2.1)),
    (tchannel.OTAChannelConfig, dict(fading="rician")),
    (tchannel.OTAChannelConfig, dict(downlink="int4")),
    (tchannel.OTAChannelConfig, dict(comm_buckets=0)),
    (tadaptive.AdaptiveConfig, dict(alpha="tracked")),
    (tadaptive.AdaptiveConfig, dict(alpha_ema=0.0)),
    (tfl.FLConfig, dict(sample_rate=0.0)),
    (tfl.FLConfig, dict(client_chunk=0)),
    (tfl.FLConfig, dict(double_buffer=True)),
    (tfl.FLConfig, dict(n_clients=2, client_weights=(1.0,))),
    (tfl.FLConfig, dict(n_clients=2, client_weights=(1.0, -1.0))),
    (tfl.FLConfig, dict(n_clients=2, client_weights=(0.0, 0.0))),
]


@pytest.mark.parametrize("cls,kw", BAD,
                         ids=[f"{c.__name__}-{next(iter(k))}" for c, k in BAD])
def test_config_checks_mirror_jax(cls, kw):
    theirs = dict(PAIRS)[cls]
    with pytest.raises(ValueError):
        theirs(**kw)
    with pytest.raises(ValueError):
        cls(**kw)


def test_config_properties_mirror_jax():
    for kw in (dict(), dict(power_control=True), dict(fading="gaussian"),
               dict(fading="gaussian", power_control=True, pc_threshold=1.1),
               dict(fading="none"), dict(fading="none", power_control=True),
               dict(mu_c=2.0, sigma_c=0.5), dict(uplink="int8")):
        ours, theirs = tchannel.OTAChannelConfig(**kw), \
            jchannel.OTAChannelConfig(**kw)
        for prop in ("pc_transmit_prob", "fading_mean", "fading_var"):
            assert getattr(ours, prop) == getattr(theirs, prop), (kw, prop)
        for prop in ("quantized", "packed_sign", "zero_fold"):
            assert getattr(ours.uplink, prop) == getattr(theirs.uplink, prop)
    assert tadaptive.AdaptiveConfig(alpha="auto").track_alpha
    flc = tfl.FLConfig(n_clients=2, client_weights=[1, 2])
    assert flc.client_weights == (1.0, 2.0) and flc.dynamic_round
    assert tchannel.CMS_U_BOUND == jchannel.CMS_U_BOUND
    assert tchannel.CMS_E_FLOOR == jchannel.CMS_E_FLOOR


@pytest.mark.parametrize("kind", ["rayleigh", "gaussian", "rayleigh_pc"])
def test_fading_transforms_match_sample_fading(kind):
    """The port's transforms applied to the base draws JAX's
    ``sample_fading`` makes from a key give its h."""
    kw = dict(fading="gaussian", sigma_c=0.4) if kind == "gaussian" else {}
    if kind == "rayleigh_pc":
        kw = dict(power_control=True, pc_threshold=0.9)
    ch = tchannel.OTAChannelConfig(**kw)
    key = jax.random.key(5)
    h = jchannel.sample_fading(key, jax_channel_config(ch), (4000,))
    if ch.fading == "rayleigh":
        base = jax.random.uniform(key, (4000,), minval=jnp.finfo(
            jnp.float32).tiny)
        ours = tchannel.rayleigh_from_uniform(
            torch.from_numpy(np.array(base)), ch.mu_c)
    else:
        base = jax.random.normal(key, (4000,))
        ours = tchannel.gaussian_from_normal(
            torch.from_numpy(np.array(base)), ch.mu_c, ch.sigma_c)
    if ch.power_control:
        ours = tchannel.power_control(ours, ch.pc_threshold)
        # the 0/1 map is exact, except where h sits within an ulp of the
        # threshold (none does for this key)
        assert np.array_equal(ours.numpy(), np.asarray(h))
    assert_close(ours, h, 1e-6, 1e-6)


def test_resolve_device_policy(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def _entry_points():
    model = tvision.logistic_regression(4, 3)
    params = model.init(device="cpu")
    spec = make_slab_spec(params)
    ch, ad, fl = (tchannel.OTAChannelConfig(), tadaptive.AdaptiveConfig(),
                  tfl.FLConfig(n_clients=2))
    np_params = {k: v.numpy() for k, v in params.items()}
    return {
        "make_slab_round_step": lambda **kw: tfl.make_slab_round_step(
            model.loss_fn, ch, ad, fl, **kw),
        "make_slab_round_runner": lambda **kw: tfl.make_slab_round_runner(
            model.loss_fn, ch, ad, fl, **kw),
        "init_train_state": lambda **kw: init_train_state(ad, params, **kw),
        "logistic_regression.init": lambda **kw: model.init(**kw),
        "mlp.init": lambda **kw: tvision.mlp(4, 3, hidden=8).init(**kw),
        "resnet_tiny.init": lambda **kw: tvision.resnet_tiny(
            10, channels=(8,), blocks_per_stage=1).init(**kw),
        "TorchDraws": lambda **kw: TorchDraws(ch, spec, 2, **kw),
        "params_from_numpy": lambda **kw: params_from_numpy(np_params, **kw),
        "train_state_from_numpy": lambda **kw: train_state_from_numpy(
            spec, step=0, w=np.zeros(spec.padded, np.float32),
            opt=[np.zeros(spec.padded, np.float32)] * 2, alpha_hat=0.0,
            **kw),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_need_cuda_unless_cpu_is_asked(name, monkeypatch):
    entry = _entry_points()[name]
    entry(device="cpu")                   # asked for the CPU: runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()                           # the default is the card


REFUSED = [
    ("A8", dict(ch=dict(uplink="int8"))),
    ("A8", dict(ch=dict(uplink="sign"))),
    ("A8", dict(ch=dict(downlink="int8"))),
    ("A12", dict(ch=dict(comm_buckets=2))),
    ("A7", dict(ad=dict(alpha="auto"))),
    ("A9", dict(fl=dict(client_chunk=2))),
    ("A9", dict(fl=dict(sample_rate=0.5))),
    ("A9", dict(fl=dict(client_weights=(1.0, 2.0)))),
    ("A9", dict(batch_gen=lambda key, idx: None)),
    ("A12", dict(backend="pallas_sharded")),
]


@pytest.mark.parametrize("item,kw", REFUSED,
                         ids=[f"{i}-{sorted(k)[0]}-{j}" for j, (i, k)
                              in enumerate(REFUSED)])
def test_uncovered_configs_raise_not_implemented(item, kw):
    model = tvision.logistic_regression(4, 3)
    ch = tchannel.OTAChannelConfig(**kw.get("ch", {}))
    ad = tadaptive.AdaptiveConfig(**kw.get("ad", {}))
    fl = tfl.FLConfig(n_clients=2, **kw.get("fl", {}))
    extra = {k: v for k, v in kw.items() if k in ("backend", "batch_gen")}
    for make in (tfl.make_slab_round_step, tfl.make_slab_round_runner):
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
            make(model.loss_fn, ch, ad, fl, device="cpu", **extra)


def test_other_refusals():
    model = tvision.logistic_regression(4, 3)
    ch, ad, fl = (tchannel.OTAChannelConfig(), tadaptive.AdaptiveConfig(),
                  tfl.FLConfig(n_clients=2))
    with pytest.raises(ValueError, match="the device decides"):
        tfl.make_slab_round_step(model.loss_fn, ch, ad, fl, device="cpu",
                                 backend="pallas")
    with pytest.raises(ValueError, match="unknown server optimizer"):
        tfl.make_slab_round_step(model.loss_fn, ch, tadaptive.AdaptiveConfig(
            optimizer="lamb"), fl, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        init_train_state(ad, model.init(device="cpu"), device="cpu",
                         error_feedback=True)
    with pytest.raises(NotImplementedError, match="A7"):
        tadaptive.slab_update_slabs(
            tadaptive.AdaptiveConfig(alpha="auto"), torch.zeros(128),
            (torch.zeros(128),) * 2, torch.zeros(128))
    assert math.isclose(tadaptive.AdaptiveConfig().resolve_alpha(None), 1.5)
