"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (from a fixture, at run time) where
there is no CUDA device or no nvcc. This file imports neither jax nor
the JAX package, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the update kernel computes the plain version's f32
operations in the same order (precise ``powf``, no mul+add contraction),
so it agrees to 1e-6 relative; a bf16 weight to one bf16 step. The
channel kernel sums the client rows in another order than the plain
``einsum``, so it agrees to 1e-6 of the sum's scale.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import CMS_U_BOUND, OTAChannelConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import FLConfig, make_slab_round_step
from repro_torch.core.slab_state import init_train_state
from repro_torch.kernels import build
from repro_torch.kernels.adaptive_update import MODES, adaptive_update_slab
from repro_torch.kernels.ota_channel import ota_channel_slab
from repro_torch.kernels.ref import adaptive_update_ref, ota_channel_ref
from repro_torch.models.vision import logistic_regression

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, rtol=1e-6):
    a, b = a.float(), b.float()
    scale = float(b.abs().max()) if b.numel() else 0.0
    assert torch.allclose(a, b, rtol=rtol, atol=rtol * scale), \
        float((a - b).abs().max())


@pytest.mark.parametrize("offset", [0, 3])      # 3: unaligned -> scalar path
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_adaptive_update_kernel_matches_plain(cuda, mode, dtype, offset):
    gen = torch.Generator(device=cuda).manual_seed(0)
    d = 5001

    def r(scale=1.0):
        return (torch.randn(d + offset, generator=gen, device=cuda)
                * scale)[offset:]

    g, w = r().to(dtype), r().to(dtype)
    delta, nu = r(0.1), r(0.01).abs()
    nu_max = nu + r(0.01).abs()
    delta[::13] = 0.0
    for alpha in (1.2, 1.5, 2.0):
        kw = dict(lr=0.05, beta1=0.9, beta2=0.3, alpha=alpha, eps=1e-8,
                  mode=mode, nu_max=nu_max if mode == "amsgrad" else None)
        n0 = adaptive_update_slab.launches
        got = adaptive_update_slab(g, delta, nu, w, **kw)
        assert adaptive_update_slab.launches == n0 + 1
        want = adaptive_update_ref(g, delta, nu, w, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got[:-1], want[:-1]):
            _close(a, b)
        if dtype == torch.float32:
            _close(got[-1], want[-1])
        else:
            step = 2.0 ** -7 * want[-1].float().abs().clamp_min(2.0 ** -126)
            assert torch.all((got[-1].float() - want[-1].float()).abs()
                             <= step)


@pytest.mark.parametrize("shape", [(50, 175104), (7, 1001), (1500, 256)])
@pytest.mark.parametrize("pilot_stats", [False, True])
def test_ota_channel_kernel_matches_plain(cuda, shape, pilot_stats):
    n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    grads = torch.randn(n, d, generator=gen, device=cuda)
    h = 0.5 + torch.rand(n, generator=gen, device=cuda)
    u = (2 * torch.rand(d, generator=gen, device=cuda) - 1) * CMS_U_BOUND
    e = -torch.log(torch.rand(d, generator=gen, device=cuda))
    grads[:, -64:], u[-64:], e[-64:] = 0.0, 0.0, 1.0     # a padding tail
    for alpha in (1.2, 1.5, 2.0):
        kw = dict(alpha=alpha, scale=0.1, pilot_stats=pilot_stats)
        got = ota_channel_slab(grads, h, u, e, **kw)
        want = ota_channel_ref(grads, h, u, e, **kw)
        torch.cuda.synchronize()
        if pilot_stats:
            (got, gs), (want, ws) = got, want
            assert float(gs[0]) == float(ws[0]) == d - 64
            _close(gs, ws, 1e-5)
        _close(got, want)
        assert torch.all(got[-64:] == 0.0)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(256, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        adaptive_update_slab(torch.zeros(512, device=cuda)[::2], x, x, x,
                             lr=0.1, beta1=0.9, beta2=0.3, alpha=1.5,
                             eps=1e-8, mode="adam")
    with pytest.raises(ValueError, match="needs nu"):
        adaptive_update_slab(x, x, None, x, lr=0.1, beta1=0.9, beta2=0.3,
                             alpha=1.5, eps=1e-8, mode="adam")
    with pytest.raises(ValueError, match="float32"):
        ota_channel_slab(torch.zeros((2, 256), device=cuda,
                                     dtype=torch.float64),
                         torch.ones(2, device=cuda), x, x, alpha=1.5,
                         scale=0.1)


@pytest.mark.parametrize("optimizer", ["adam_ota", "adagrad_ota",
                                       "amsgrad_ota", "yogi_ota", "fedavgm",
                                       "fedavg"])
def test_round_on_the_card_matches_the_cpu_round(cuda, optimizer):
    """Three logreg rounds through the kernels agree with the same rounds
    through the plain versions on the CPU, on the same draws."""
    d, c, n, b = 16, 4, 8, 6
    model = logistic_regression(d, c)
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(0.1 * rng.normal(size=(d, c)).astype(
        np.float32)), "b": torch.zeros(c)}
    ch, ad, fl = (OTAChannelConfig(), AdaptiveConfig(optimizer=optimizer,
                                                     lr=0.05),
                  FLConfig(n_clients=n))
    states = {dev: init_train_state(ad, params, device=dev)
              for dev in ("cpu", "cuda")}
    steps = {dev: make_slab_round_step(model.loss_fn, ch, ad, fl, device=dev)
             for dev in states}
    provider = TorchDraws(ch, states["cpu"].spec, n, seed=2, device="cpu")
    launches = (adaptive_update_slab.launches, ota_channel_slab.launches)
    for t in range(3):
        batch = {"x": rng.normal(size=(n, b, d)).astype(np.float32),
                 "y": rng.integers(0, c, (n, b)).astype(np.int64)}
        draws = provider(t)
        for dev in states:
            states[dev], _ = steps[dev](states[dev], draws, batch)
    assert (adaptive_update_slab.launches - launches[0],
            ota_channel_slab.launches - launches[1]) == (3, 3)
    _close(states["cuda"].w.cpu(), states["cpu"].w, 1e-5)
    for a, b_ in zip(states["cuda"].opt, states["cpu"].opt):
        _close(a.cpu(), b_, 1e-5)
