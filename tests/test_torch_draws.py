"""The port's own draws provider (``repro_torch.core.draws.TorchDraws``).

It cannot reproduce threefry's bits, so it is held to the laws instead:
the same shapes and dtypes as the JAX package's draws (the reference
provider in ``tests/_torch_ref.py``), the padding fixed point u = 0,
e = 1, the guards, and moments within statistical bounds (about five
standard errors at these sample sizes, so a correct provider fails
with probability below 1e-5 per check).
"""

import math

import jax
import numpy as np
import pytest
import torch

from _torch_ref import ref_draws
from repro.core import slab as jslab
from repro_torch.core.channel import (CMS_E_FLOOR, CMS_U_BOUND,
                                      OTAChannelConfig, UplinkConfig,
                                      cms_transform)
from repro_torch.core.draws import TorchDraws
from repro_torch.core.slab import make_slab_spec

N_CLIENTS = 50000
TREE = {"a": np.zeros((300, 301), np.float32), "b": np.zeros((77,),
                                                             np.float32)}


def _z(sample: torch.Tensor, mean: float, var: float) -> float:
    """|sample mean - mean| in standard errors."""
    x = sample.double()
    return abs(float(x.mean()) - mean) / math.sqrt(var / x.numel())


@pytest.fixture(scope="module")
def spec():
    return make_slab_spec(TREE)


def test_same_shapes_and_dtypes_as_the_reference_provider(spec):
    ch = OTAChannelConfig()
    ours = TorchDraws(ch, spec, 7, seed=0, device="cpu")(0)
    ref = ref_draws(jax.random.key(0), ch, jslab.make_slab_spec(TREE), 7)
    for f in ("h", "u", "e"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32


def test_padding_fixed_point_and_guards(spec):
    d = TorchDraws(OTAChannelConfig(), spec, 3, seed=1, device="cpu")(4)
    pad = slice(spec.total, spec.padded)
    assert spec.padded > spec.total
    assert torch.all(d.u[pad] == 0.0) and torch.all(d.e[pad] == 1.0)
    assert torch.all(cms_transform(d.u[pad], d.e[pad], 1.3) == 0.0)
    real = slice(0, spec.total)
    assert float(d.u[real].abs().max()) <= CMS_U_BOUND
    assert float(d.e[real].min()) >= np.float32(CMS_E_FLOOR)
    assert torch.all(torch.isfinite(cms_transform(d.u, d.e, 1.1)))


def test_keyed_by_seed_and_absolute_round(spec):
    ch = OTAChannelConfig()
    p = TorchDraws(ch, spec, 5, seed=3, device="cpu")
    a, b = p(7), p(2)
    c = TorchDraws(ch, spec, 5, seed=3, device="cpu")(7)
    assert torch.equal(a.u, c.u) and torch.equal(a.h, c.h)
    assert not torch.equal(a.u, b.u)
    assert not torch.equal(a.u, TorchDraws(ch, spec, 5, seed=4,
                                           device="cpu")(7).u)
    with pytest.raises(ValueError):
        p(-1)


def test_cms_input_moments(spec):
    d = TorchDraws(OTAChannelConfig(), spec, 2, seed=5, device="cpu")(0)
    u, e = d.u[:spec.total], d.e[:spec.total]
    assert _z(u, 0.0, CMS_U_BOUND ** 2 / 3) < 5
    assert abs(float(u.double().var()) - CMS_U_BOUND ** 2 / 3) < 0.01
    assert _z(e, 1.0, 1.0) < 5
    assert abs(float(e.double().var()) - 1.0) < 0.03
    # alpha == 2: the CMS transform of the draws is N(0, 2)
    x = cms_transform(u, e, 2.0).double()
    assert _z(x, 0.0, 2.0) < 5
    assert abs(float(x.var()) - 2.0) < 0.05


@pytest.mark.parametrize("kw", [dict(), dict(mu_c=2.0),
                                dict(fading="gaussian", sigma_c=0.3),
                                dict(power_control=True, pc_threshold=0.7),
                                dict(fading="none")])
def test_fading_moments(spec, kw):
    ch = OTAChannelConfig(**kw)
    h = TorchDraws(ch, spec, N_CLIENTS, seed=6, device="cpu")(1).h
    assert h.shape == (N_CLIENTS,)
    if ch.fading == "none":
        assert torch.all(h == 1.0)
        return
    assert _z(h, ch.fading_mean, ch.fading_var) < 5
    assert abs(float(h.double().var()) - ch.fading_var) < 0.05 * max(
        ch.fading_var, 0.05)
    if ch.power_control:
        assert set(torch.unique(h).tolist()) <= {0.0, 1.0}
    elif ch.fading == "rayleigh":
        assert float(h.min()) > 0.0


def test_interference_off_is_the_fixed_point(spec):
    d = TorchDraws(OTAChannelConfig(interference=False), spec, 4,
                   device="cpu")(0)
    assert torch.all(d.u == 0.0) and torch.all(d.e == 1.0)


WIRES = {
    "f32": OTAChannelConfig(),
    "int8": OTAChannelConfig(uplink="int8"),
    "int8-rtn": OTAChannelConfig(uplink=UplinkConfig(
        mode="int8", stochastic_rounding=False)),
    "int8-inkernel": OTAChannelConfig(uplink=UplinkConfig(
        mode="int8", sr_inkernel=True)),
    "sign": OTAChannelConfig(uplink="sign"),
    "dl-int8": OTAChannelConfig(downlink="int8"),
    "int8-dl-int8": OTAChannelConfig(uplink="int8", downlink="int8"),
}


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_wire_fields_drawn_only_when_the_config_uses_them(spec, wire):
    ch = WIRES[wire]
    d = TorchDraws(ch, spec, 3, seed=2, device="cpu")(1)
    sr = ch.uplink.mode == "int8" and ch.uplink.stochastic_rounding
    # on the CPU the round always rounds with the host draw
    assert (d.r_up is not None) == sr
    assert (d.r_dl is not None) == (ch.downlink == "int8")
    assert (d.sr_seed is not None) == ch.uplink.sr_inkernel
    if d.sr_seed is not None:
        assert isinstance(d.sr_seed, int) and 0 <= d.sr_seed < 2 ** 64
    # the reference provider draws the same fields for the same config
    ref = ref_draws(jax.random.key(0), ch, jslab.make_slab_spec(TREE), 3)
    for f in ("r_up", "r_dl"):
        a, b = getattr(d, f), getattr(ref, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape == (spec.padded,)
            assert a.dtype == b.dtype == torch.float32
    moved = d.to("cpu")
    assert moved.sr_seed == d.sr_seed
    assert (moved.r_up is None) == (d.r_up is None)


def test_wire_field_laws(spec):
    d = TorchDraws(WIRES["int8-dl-int8"], spec, 3, seed=4, device="cpu")(0)
    for x in (d.r_up, d.r_dl):
        assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
        assert _z(x, 0.5, 1.0 / 12.0) < 5
        assert abs(float(x.double().var()) - 1.0 / 12.0) < 0.002
    assert not torch.equal(d.r_up, d.r_dl)
    k = TorchDraws(WIRES["int8-inkernel"], spec, 3, seed=4, device="cpu")
    seeds = {k(t).sr_seed for t in range(50)}
    assert len(seeds) == 50                    # a fresh key every round
    assert k(7).sr_seed == TorchDraws(WIRES["int8-inkernel"], spec, 3,
                                      seed=4, device="cpu")(7).sr_seed


def test_f32_draws_are_unchanged_by_the_wire(spec):
    """h, u and e come first, so a quantized wire does not move them, and
    an f32 config's draws are those the provider made before the wire's
    fields existed (values pinned from that provider, seed 3, round 2)."""
    base = TorchDraws(WIRES["f32"], spec, 5, seed=3, device="cpu")(2)
    for wire in ("int8", "int8-dl-int8", "sign"):
        d = TorchDraws(WIRES[wire], spec, 5, seed=3, device="cpu")(2)
        for f in ("h", "u", "e"):
            assert torch.equal(getattr(d, f), getattr(base, f)), (wire, f)
    np.testing.assert_array_equal(base.h.numpy(), np.array(
        [1.6411184072494507, 0.22680427134037018, 0.4743141531944275,
         1.0096547603607178, 1.0694395303726196], np.float32))
    np.testing.assert_array_equal(base.u[:3].numpy(), np.array(
        [-1.1547446250915527, 1.5411531925201416, -0.7170934081077576],
        np.float32))
    np.testing.assert_array_equal(base.e[:3].numpy(), np.array(
        [1.3558493852615356, 1.9337083101272583, 0.7208516001701355],
        np.float32))
    assert float(base.u.double().sum()) == 138.6367769241333
    assert float(base.e.double().sum()) == 90350.23848593148
