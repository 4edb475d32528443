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
                                      OTAChannelConfig, cms_transform)
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
