"""The round's CMS draws in one launch (``kernels/cms_draws.py``,
``csrc/cms_draws.cu``) against their plain version
(``kernels.ref.cms_draws_ref``: two ``torch.rand`` calls, the
transforms, the padding).

On the CPU: the host's restatement of how the card's torch launches
``torch.rand`` (grids, each launch's Philox offset, the generator's
advance; hand-worked for an H100's 132 SMs of 2048 threads and, for the
sizes marked so, the advances ``g.get_offset()`` read on an H100 80GB
HBM3 with torch 2.11.0+cu128), the CUDA path refused on a torch release
whose launches were not read there, the CPU path bit for bit the plain
version, and no launch counted.

Marked ``cuda`` (each test skips from a fixture where there is no CUDA
device or no nvcc): the kernel bit for bit the plain version run on the
same card and generator, at sizes on both sides of a block, of the
grid-stride step (256 x 1056 x 4) and of the 32-bit split, and at
StarCoder2-15B's 987,833,344 entries; the generator's offset after the
draw and the next draw equal; whole ``TorchDraws`` rounds (f32 wire,
int8 wire with host rounding, partial participation) equal field for
field, one launch a round. This file imports neither jax nor the JAX
package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cms_draws.py
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.core import draws as draws_mod
from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.slab import make_slab_spec
from repro_torch.kernels import build
from repro_torch.kernels.cms_draws import (CARD_TORCH, PIECE_MAX,
                                           check_torch_release,
                                           cms_draws_slab, launch_policy,
                                           rand_launches)
from repro_torch.kernels.ref import cms_draws_ref

H100 = (132, 2048)         # SMs, threads an SM
STEP = 256 * 1056 * 4      # an H100's grid-stride step: 1,081,344
SC2 = 987_833_344          # StarCoder2-15B at depth 1, a multiple of 128


def _spec(total: int, pad: int = 0):
    return types.SimpleNamespace(total=total, padded=total + pad)


# --- the launch policy, on the host ---------------------------------------

@pytest.mark.parametrize("numel, grid, co", [
    (1, 1, 4), (255, 1, 4), (256, 1, 4), (257, 2, 4),
    (175_104, 684, 4),                      # 684 blocks: one step
    (STEP - 1, 1056, 4), (STEP, 1056, 4), (STEP + 1, 1056, 8),
    (PIECE_MAX, 1056, 1988),                # 496.5 steps -> 497 x 4
    (SC2, 1056, 3656),                      # 913.5 steps -> 914 x 4
])
def test_launch_policy_on_an_h100(numel, grid, co):
    assert launch_policy(numel, *H100) == (grid, co)


@pytest.mark.parametrize("numel, advance", [
    # g.get_offset() after one torch.rand((numel,)) from offset 0
    (1, 4), (255, 4), (256, 4), (257, 4), (175_104, 4), (STEP - 1, 4),
    (STEP, 4), (STEP + 1, 8), (PIECE_MAX - 1, 1988), (PIECE_MAX, 1988),
    (PIECE_MAX + 1, 3980), (PIECE_MAX + 7, 3980), (877_455_872, 6496),
    (SC2, 7312),
])
def test_rand_advance_matches_the_card(numel, advance):
    assert rand_launches(numel, *H100)[1] == advance


def test_starcoder2_slab_draws_as_two_halves():
    # The whole call's offset (3656) is taken and left unused; each half
    # of 493,916,672 entries takes 457 steps of 4.
    launches, advance = rand_launches(SC2, *H100)
    half = SC2 // 2
    assert launches == [(0, half, 1056, 3656), (half, half, 1056, 5484)]
    assert advance == 3656 + 2 * 1828


@pytest.mark.parametrize("numel", [PIECE_MAX + 1, 3 * PIECE_MAX + 5,
                                   2 ** 31 + 3])
def test_split_pieces_cover_the_vector_in_order(numel):
    launches, advance = rand_launches(numel, *H100)
    starts = [s for s, _, _, _ in launches]
    sizes = [n for _, n, _, _ in launches]
    assert starts == list(np.cumsum([0] + sizes[:-1]))
    assert sum(sizes) == numel and max(sizes) <= PIECE_MAX
    # The first half is n // 2, halved again depth first; only the
    # whole call (not an intermediate half) takes an offset of its own.
    first = numel
    while first > PIECE_MAX:
        first //= 2
    assert sizes[0] == first
    top = launch_policy(numel, *H100)[1]
    offsets = [o for _, _, _, o in launches]
    assert offsets[0] == top
    for (_, n, _, o), o_next in zip(launches, offsets[1:] + [advance]):
        assert o_next - o == launch_policy(n, *H100)[1]


def test_generator_rounds_each_advance_to_four():
    # philox_cuda_state rounds an increment up to a multiple of 4; the
    # launch policy's counter offsets are multiples of 4 already, so on
    # every size the advance is the sum of the counter offsets.
    for n in (1, 300, STEP + 1, 5 * STEP, PIECE_MAX + 1):
        launches, advance = rand_launches(n, *H100)
        assert advance % 4 == 0
        assert all(o % 4 == 0 for _, _, _, o in launches)


@pytest.mark.parametrize("version, known", [
    ("2.11.0+cu128", True), ("2.11.1", True), ("2.1.1", False),
    ("2.12.0+cu126", False), ("2.13.0+cpu", False), ("3.11.0", False)])
def test_the_card_path_takes_only_releases_read_on_the_card(version, known):
    assert "2.11" in CARD_TORCH
    if known:
        check_torch_release(version)
    else:
        with pytest.raises(RuntimeError, match="not read on the card"):
            check_torch_release(version)


def test_the_card_path_refuses_an_unread_release(monkeypatch):
    monkeypatch.setattr(torch, "__version__", "2.13.0+cu130")
    before = cms_draws_slab.launches
    gen = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="not read on the card"):
        cms_draws_slab(_spec(4), gen)
    assert cms_draws_slab.launches == before


# --- the CPU path ---------------------------------------------------------

@pytest.mark.parametrize("total, pad", [(1, 127), (300, 84), (90_377, 119)])
def test_cpu_path_is_the_plain_version_bitwise(total, pad):
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(1234)
    g2.manual_seed(1234)
    before = cms_draws_slab.launches
    u, e = cms_draws_slab(_spec(total, pad), g1)
    ur, er = cms_draws_ref(_spec(total, pad), g2)
    assert cms_draws_slab.launches == before
    assert torch.equal(u, ur) and torch.equal(e, er)
    assert torch.all(u[total:] == 0.0) and torch.all(e[total:] == 1.0)
    assert torch.equal(torch.rand((64,), generator=g1),
                       torch.rand((64,), generator=g2))


def test_cpu_torch_draws_take_the_plain_version():
    spec = make_slab_spec({"a": np.zeros((300, 301), np.float32)})
    before = cms_draws_slab.launches
    d = TorchDraws(OTAChannelConfig(), spec, 5, seed=3, device="cpu")(2)
    assert cms_draws_slab.launches == before
    g = torch.Generator()
    g.manual_seed(draws_mod._mix64((3 << 32) | 2))
    torch.rand((5,), generator=g)                   # the Rayleigh fading
    u, e = cms_draws_ref(spec, g)
    assert torch.equal(d.u, u) and torch.equal(d.e, e)


def test_unknown_device_is_refused():
    gen = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="cuda or cpu generator"):
        cms_draws_slab(_spec(4), gen)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("total, pad", [
    (1, 127), (255, 1), (257, 127), (STEP - 1, 1), (STEP, 0), (STEP + 1, 127),
    (175_104, 0), (PIECE_MAX + 1, 127), (SC2, 0), (SC2, 384)])
def test_kernel_is_the_plain_version_bitwise(cuda, total, pad):
    spec = _spec(total, pad)
    gk = torch.Generator(device=cuda)
    gr = torch.Generator(device=cuda)
    seed = 0xDEADBEEF12345 + total
    for g in (gk, gr):
        g.manual_seed(seed)
        torch.rand((7,), generator=g, device=cuda)  # a fading draw first
    before = cms_draws_slab.launches
    u, e = cms_draws_slab(spec, gk)
    assert cms_draws_slab.launches == before + 1
    ur, er = cms_draws_ref(spec, gr)
    assert torch.equal(u, ur), int((u != ur).sum())
    assert torch.equal(e, er), int((e != er).sum())
    assert torch.all(u[total:] == 0.0) and torch.all(e[total:] == 1.0)
    assert gk.get_offset() == gr.get_offset()
    assert torch.equal(torch.rand((1000,), generator=gk, device=cuda),
                       torch.rand((1000,), generator=gr, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "int8_sr", "sampled"])
def test_torch_draws_rounds_are_unchanged(cuda, monkeypatch, wire):
    spec = make_slab_spec({"a": np.zeros((300, 301), np.float32),
                           "b": np.zeros((77,), np.float32)})
    ch = OTAChannelConfig()
    if wire == "int8_sr":
        ch = OTAChannelConfig(uplink=UplinkConfig(
            mode="int8", stochastic_rounding=True))
    rate = 0.5 if wire == "sampled" else 1.0
    kernel = TorchDraws(ch, spec, 6, seed=11, device=cuda, sample_rate=rate)
    before = cms_draws_slab.launches
    got = [kernel(t) for t in (0, 1, 7)]
    assert cms_draws_slab.launches == before + 3
    monkeypatch.setattr(draws_mod, "cms_draws_slab", cms_draws_ref)
    plain = TorchDraws(ch, spec, 6, seed=11, device=cuda, sample_rate=rate)
    for d, r in zip(got, (plain(t) for t in (0, 1, 7))):
        for f in ("h", "u", "e", "r_up", "r_dl", "mask"):
            a, b = getattr(d, f), getattr(r, f)
            assert (a is None) == (b is None), f
            assert a is None or torch.equal(a, b), f
    if wire == "int8_sr":
        assert got[0].r_up is not None
    if wire == "sampled":
        assert got[0].mask is not None
