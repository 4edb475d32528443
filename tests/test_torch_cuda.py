"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (from a fixture, at run time) where
there is no CUDA device or no nvcc. This file imports neither jax nor
the JAX package, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the update kernel computes the plain version's f32
operations in the same order (precise ``powf``, no mul+add contraction),
so it agrees to 1e-6 relative; a bf16 weight to one bf16 step. The
channel kernel sums the client rows in another order than the plain
``einsum``, so it agrees to 1e-6 of the sum's scale. The transmit
kernel's payload is held to the wire's contract (equal on >= 99.9 % of
entries, one quantization step on the rest; scales at 1e-6, the residual
at 1e-6 of the partial's scale where the payloads agree); its in-kernel
rounding to one step of x/s and to zero bias. The receive kernel agrees
to 1e-6 of the output's scale. The flash-attention kernels sum in
another order than the plain ``einsum`` and contract into FMAs: 2e-5 in
f32, and 1e-2 of the output's scale in bf16 (about one bf16 ulp there);
and each variant is also held an element at a time to its
``flash_tolerance``: the Hopper one, which rounds p to bf16 for its
``wgmma``, to 2^-7 |ref| + 2^-8 attn(q, k, |v|) + 2e-5.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import (CMS_U_BOUND, OTAChannelConfig,
                                      UplinkConfig)
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import FLConfig, make_slab_round_step
from repro_torch.core.slab_state import init_train_state
from repro_torch.kernels import build
from repro_torch.kernels.adaptive_update import MODES, adaptive_update_slab
from repro_torch.kernels.ota_channel import (ota_channel_slab,
                                             ota_receive_slab,
                                             ota_transmit_slab,
                                             pack_sign_slab)
from repro_torch.kernels.ref import (adaptive_update_ref, ota_channel_ref,
                                     ota_receive_ref, ota_transmit_ref)
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


def _wire_inputs(cuda, n, d, pad=38, seed=3):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    grads = torch.randn(n, d, generator=gen, device=cuda)
    h = 0.5 + torch.rand(n, generator=gen, device=cuda)
    r = torch.rand(d, generator=gen, device=cuda)
    ef = 0.01 * torch.randn(d, generator=gen, device=cuda)
    grads[:, d - pad:], ef[d - pad:] = 0.0, 0.0
    grads[:, 128:256], ef[128:256] = 0.0, 0.0        # an all-zero block
    return grads, h, r, ef


@pytest.mark.parametrize("use_ef", [False, True])
@pytest.mark.parametrize("qmode,stochastic,zero_fold",
                         [("int8", True, False), ("int8", False, False),
                          ("sign", False, False), ("sign", False, True)])
@pytest.mark.parametrize("shape", [(50, 175104), (7, 1024), (1500, 256)])
def test_transmit_kernel_matches_plain(cuda, shape, qmode, stochastic,
                                       zero_fold, use_ef):
    n, d = shape
    grads, h, r, ef = _wire_inputs(cuda, n, d)
    kw = dict(quantize=True, r=r if stochastic else None,
              stochastic=stochastic, qmode=qmode, zero_fold=zero_fold,
              ef=ef if use_ef else None, return_residual=use_ef)
    n0 = ota_transmit_slab.launches
    got = ota_transmit_slab(grads, h, **kw)
    assert ota_transmit_slab.launches == n0 + 1
    want = ota_transmit_ref(grads, h, **kw)
    x = ota_transmit_ref(grads, h) + (ef if use_ef else 0.0)
    torch.cuda.synchronize()
    q, qw = got[0].float(), want[0].float()
    same = q == qw
    assert float(same.float().mean()) >= 0.999
    assert torch.all((q - qw).abs() <= 1.0)
    _close(got[1], want[1])
    if use_ef:
        err = (got[2] - want[2]).abs()
        tol = 1e-6 * want[2].abs() + 1e-6 * float(x.abs().max())
        step = want[1].repeat_interleave(128) * (1 + 1e-6)
        assert torch.all(torch.where(same, err <= tol, err <= step))
    assert torch.all(got[0][d - 38:] == (1 if zero_fold else 0))
    assert float(got[1][1]) == (0.0 if zero_fold else 1.0)


def test_transmit_kernel_in_kernel_rounding(cuda):
    """Philox draws: one step from x/s everywhere, unbiased over the
    slab, a different stream for another seed, the same for the same."""
    grads, h, _, ef = _wire_inputs(cuda, 50, 175104)
    x = ota_transmit_ref(grads, h) + ef
    q, s, res = ota_transmit_slab(grads, h, quantize=True, sr_seed=7,
                                  ef=ef, return_residual=True)
    q2, _ = ota_transmit_slab(grads, h, quantize=True, sr_seed=7, ef=ef)
    q3, _ = ota_transmit_slab(grads, h, quantize=True, sr_seed=8, ef=ef)
    torch.cuda.synchronize()
    assert torch.equal(q, q2) and not torch.equal(q, q3)
    sb = s.repeat_interleave(128)
    y = x / sb
    steps = (q.float() - y)[:-38]
    assert torch.all(steps.abs() < 1.0 + 1e-5)
    frac = (y - torch.floor(y))[:-38].double()
    se = float(torch.sqrt((frac * (1 - frac)).sum())) / steps.numel()
    assert abs(float(steps.double().mean())) <= 3 * se
    # x here is the plain version's sum, an ulp from the kernel's, and
    # an ulp of x carries into the residual as it is
    assert torch.all((res - (x - q.float() * sb)).abs()
                     <= 1e-6 * float(x.abs().max()))


@pytest.mark.parametrize("pilot_stats", [False, True])
@pytest.mark.parametrize("packed", [None, "fold", "planes"])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("d", [175104, 1024])
def test_receive_kernel_matches_plain(cuda, d, rows, packed, pilot_stats):
    gen = torch.Generator(device=cuda).manual_seed(4)
    s = torch.rand(rows, d // 128, generator=gen, device=cuda)
    u = (2 * torch.rand(d, generator=gen, device=cuda) - 1) * CMS_U_BOUND
    e = -torch.log(torch.rand(d, generator=gen, device=cuda))
    u[-38:], e[-38:] = 0.0, 1.0
    if packed is None:
        payload = torch.randint(-127, 128, (rows, d), generator=gen,
                                device=cuda, dtype=torch.int8)
        payload[:, -38:] = 0
    else:
        q = torch.randint(-1, 2, (rows, d), generator=gen, device=cuda,
                          dtype=torch.int8)
        q[:, -38:] = 0
        if packed == "fold":
            q = torch.where(q < 0, -1, 1).to(torch.int8)
        payload = pack_sign_slab(q, planes=packed == "planes")
    for alpha in (1.2, 1.5, 2.0):
        kw = dict(alpha=alpha, scale=0.1, packed=packed,
                  pilot_stats=pilot_stats)
        n0 = ota_receive_slab.launches
        got = ota_receive_slab(payload, s, u, e, **kw)
        assert ota_receive_slab.launches == n0 + 1
        want = ota_receive_ref(payload, s, u, e, **kw)
        torch.cuda.synchronize()
        if pilot_stats:
            (got, gs), (want, ws) = got, want
            assert float(gs[0]) == float(ws[0]) == d - 38
            _close(gs, ws, 1e-5)
        _close(got, want)
        if packed != "fold":
            assert torch.all(got[-38:] == 0.0)


@pytest.mark.parametrize("mode", ["adagrad", "adam", "amsgrad", "yogi"])
def test_update_kernel_with_device_alpha_matches_plain(cuda, mode):
    gen = torch.Generator(device=cuda).manual_seed(5)
    g, w = (torch.randn(5000, generator=gen, device=cuda) for _ in range(2))
    delta = 0.1 * torch.randn(5000, generator=gen, device=cuda)
    nu = 0.01 * torch.rand(5000, generator=gen, device=cuda)
    nu_max = nu + 0.01 * torch.rand(5000, generator=gen, device=cuda)
    for a in (1.2, 1.5, 1.83, 2.0):
        kw = dict(lr=0.05, beta1=0.9, beta2=0.3, eps=1e-8, mode=mode,
                  nu_max=nu_max if mode == "amsgrad" else None)
        got = adaptive_update_slab(g, delta, nu, w,
                                   alpha=torch.tensor(a, device=cuda), **kw)
        want = adaptive_update_ref(g, delta, nu, w,
                                   alpha=torch.tensor(a, device=cuda), **kw)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            _close(x, y)
    with pytest.raises(ValueError, match="0-dim float32"):
        adaptive_update_slab(g, delta, nu, w, alpha=torch.tensor(1.5), **kw)


def test_tracked_server_half_makes_no_host_sync(cuda):
    from repro_torch.core.adaptive import slab_update_slabs
    from repro_torch.core.tail_index import effective_alpha, update_alpha_ema
    grads, h, _, _ = _wire_inputs(cuda, 8, 4096)
    gen = torch.Generator(device=cuda).manual_seed(6)
    u = (2 * torch.rand(4096, generator=gen, device=cuda) - 1) * CMS_U_BOUND
    e = -torch.log(torch.rand(4096, generator=gen, device=cuda))
    w = torch.randn(4096, generator=gen, device=cuda)
    state = (torch.zeros_like(w), torch.zeros_like(w))
    cfg = AdaptiveConfig(alpha="auto")
    alpha_hat = torch.zeros((), device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g_slab, stats = ota_channel_slab(grads, h, u, e, alpha=1.5,
                                         scale=0.1, pilot_stats=True)
        alpha_hat = update_alpha_ema(alpha_hat, stats, cfg.alpha_ema)
        state, w = slab_update_slabs(cfg, g_slab, state, w,
                                     alpha=effective_alpha(alpha_hat))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert 1.0 < float(alpha_hat) <= 2.0


WIRES = [
    ("int8-ef", dict(uplink=UplinkConfig(mode="int8", error_feedback=True))),
    ("int8-rtn", dict(uplink=UplinkConfig(mode="int8",
                                          stochastic_rounding=False))),
    ("sign-fold-ef", dict(uplink=UplinkConfig(mode="sign",
                                              error_feedback=True))),
    ("sign-planes-ef", dict(uplink=UplinkConfig(
        mode="sign", error_feedback=True, sign_pack="planes"))),
    ("sign-int8-dl8", dict(uplink=UplinkConfig(mode="sign",
                                               sign_pack="int8"),
                           downlink="int8")),
]


@pytest.mark.parametrize("tracked", [False, True])
@pytest.mark.parametrize("name,chkw", WIRES, ids=[w[0] for w in WIRES])
def test_quantized_round_on_the_card_matches_the_cpu_round(cuda, name, chkw,
                                                           tracked):
    d, c, n, b = 16, 4, 8, 6
    model = logistic_regression(d, c)
    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(0.1 * rng.normal(size=(d, c)).astype(
        np.float32)), "b": torch.zeros(c)}
    ch = OTAChannelConfig(**chkw)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05,
                        alpha="auto" if tracked else 1.5)
    fl = FLConfig(n_clients=n)
    ef = ch.uplink.error_feedback
    states = {dev: init_train_state(ad, params, error_feedback=ef,
                                    device=dev) for dev in ("cpu", "cuda")}
    steps = {dev: make_slab_round_step(model.loss_fn, ch, ad, fl, device=dev)
             for dev in states}
    provider = TorchDraws(ch, states["cpu"].spec, n, seed=2, device="cpu")
    n0 = (ota_transmit_slab.launches, ota_receive_slab.launches)
    for t in range(3):
        batch = {"x": rng.normal(size=(n, b, d)).astype(np.float32),
                 "y": rng.integers(0, c, (n, b)).astype(np.int64)}
        draws = provider(t)
        for dev in states:
            states[dev], _ = steps[dev](states[dev], draws, batch)
    assert (ota_transmit_slab.launches - n0[0],
            ota_receive_slab.launches - n0[1]) == (3, 3)
    _close(states["cuda"].w.cpu(), states["cpu"].w, 1e-5)
    for a, b_ in zip(states["cuda"].opt, states["cpu"].opt):
        _close(a.cpu(), b_, 1e-5)
    if ef:
        # the residual x - q s carries an ulp of x (the card's gradients
        # differ from the CPU's by ulps), so it is held at the wire
        # matrix's absolute tier, not relative to its own small scale
        assert torch.allclose(states["cuda"].ef.cpu(), states["cpu"].ef,
                              rtol=1e-5, atol=1e-5)
    _close(states["cuda"].alpha_hat.cpu(), states["cpu"].alpha_hat, 1e-5)


def test_in_kernel_rounding_round_runs_on_the_card(cuda):
    """sr_inkernel through the entry points: the card's provider draws
    the seed and no host uniforms; each round launches the transmit
    kernel once."""
    d, c, n = 16, 4, 8
    model = logistic_regression(d, c)
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8", sr_inkernel=True,
                                              error_feedback=True))
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha="auto")
    state = init_train_state(ad, model.init(device=cuda), error_feedback=True,
                             device=cuda)
    provider = TorchDraws(ch, state.spec, n, seed=3, device=cuda)
    draws = provider(0)
    assert draws.r_up is None and isinstance(draws.sr_seed, int)
    step = make_slab_round_step(model.loss_fn, ch, ad, FLConfig(n_clients=n),
                                device=cuda)
    rng = np.random.default_rng(2)
    n0 = ota_transmit_slab.launches
    for t in range(3):
        batch = {"x": rng.normal(size=(n, 6, d)).astype(np.float32),
                 "y": rng.integers(0, c, (n, 6)).astype(np.int64)}
        state, m = step(state, provider(t), batch)
    assert ota_transmit_slab.launches - n0 == 3
    assert torch.isfinite(state.w).all() and float(state.ef.abs().max()) > 0


# ---------------------------------------------------------------------------
# The streamed client axis: the accumulating transmit kernel (B3b, and
# B3a through it) and the streamed round on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("row_chunk", [None, 1, 7, "N"])
@pytest.mark.parametrize("shape", [(50, 175104), (37, 4097), (12, 300)])
def test_stream_transmit_kernel_matches_plain(cuda, shape, row_chunk,
                                              with_acc):
    n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(7)
    grads = torch.randn(n, d, generator=gen, device=cuda)
    h = 0.5 + torch.rand(n, generator=gen, device=cuda)
    acc = torch.randn(d, generator=gen, device=cuda) if with_acc else None
    grads[:, d - 38:] = 0.0                 # the slab's padding columns
    if acc is not None:
        acc[d - 38:] = 0.0
    rc = n if row_chunk == "N" else row_chunk
    kw = dict(n_total=n + 3, acc=acc, row_chunk=rc)
    n0 = ota_transmit_slab.stream_launches
    got = ota_transmit_slab(grads, h, **kw)
    want = ota_transmit_ref(grads, h, **kw)
    torch.cuda.synchronize()
    assert ota_transmit_slab.stream_launches - n0 == 1
    _close(got, want)
    assert torch.all(got[d - 38:] == 0.0)


def test_stream_transmit_one_chunk_is_the_channel_kernels_sum(cuda):
    """One chunk and a zero carry give the channel kernel's faded sum
    bitwise (u = 0, e = 1 synthesize no interference): the property the
    streamed round's chunk >= N parity rests on. Also B3a's case."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    grads = torch.randn(50, 4096, generator=gen, device=cuda)
    h = 0.5 + torch.rand(50, generator=gen, device=cuda)
    u, e = torch.zeros(4096, device=cuda), torch.ones(4096, device=cuda)
    chan = ota_channel_slab(grads, h, u, e, alpha=1.5, scale=0.0)
    for kw in (dict(), dict(acc=torch.zeros(4096, device=cuda)),
               dict(row_chunk=50)):
        assert torch.equal(ota_transmit_slab(grads, h, **kw), chan)


def _stream_model_inputs(cuda, n, d=16, c=4, b=6, seed=1):
    rng = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(0.1 * rng.normal(size=(d, c)).astype(
        np.float32)), "b": torch.zeros(c)}
    batches = [{"x": rng.normal(size=(n, b, d)).astype(np.float32),
                "y": rng.integers(0, c, (n, b)).astype(np.int64)}
               for _ in range(3)]
    return logistic_regression(d, c), params, batches


STREAMS = [
    ("serial", dict(client_chunk=3), UplinkConfig()),
    ("double", dict(client_chunk=3, double_buffer=True), UplinkConfig()),
    ("ragged-weighted", dict(client_chunk=3, sample_rate=0.5,
                             client_weights=tuple(range(1, 9))),
     UplinkConfig()),
    ("int8-ef", dict(client_chunk=4, sample_rate=0.5),
     UplinkConfig(mode="int8", error_feedback=True)),
]


@pytest.mark.parametrize("name,flkw,up", STREAMS,
                         ids=[s[0] for s in STREAMS])
def test_streamed_round_on_the_card_matches_the_cpu_round(cuda, name, flkw,
                                                          up):
    n = 8
    model, params, batches = _stream_model_inputs(cuda, n)
    ch = OTAChannelConfig(uplink=up)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha="auto")
    fl = FLConfig(n_clients=n, **flkw)
    ef = up.error_feedback
    states = {dev: init_train_state(ad, params, error_feedback=ef,
                                    device=dev) for dev in ("cpu", "cuda")}
    steps = {dev: make_slab_round_step(model.loss_fn, ch, ad, fl, device=dev)
             for dev in states}
    provider = TorchDraws(ch, states["cpu"].spec, n, seed=2, device="cpu",
                          sample_rate=fl.sample_rate)
    n0 = ota_transmit_slab.stream_launches
    for t in range(3):
        for dev in states:
            states[dev], _ = steps[dev](states[dev], provider(t), batches[t])
    chunks = 0 if fl.double_buffer else -(-n // fl.client_chunk)
    assert ota_transmit_slab.stream_launches - n0 == 3 * chunks
    for a, b_ in ((states["cuda"].w, states["cpu"].w),
                  (states["cuda"].alpha_hat, states["cpu"].alpha_hat),
                  *zip(states["cuda"].opt, states["cpu"].opt)):
        assert torch.allclose(a.cpu(), b_, rtol=1e-5, atol=1e-5)
    if ef:
        assert torch.allclose(states["cuda"].ef.cpu(), states["cpu"].ef,
                              rtol=1e-5, atol=1e-5)


def test_streamed_round_with_one_chunk_is_the_resident_round(cuda):
    n = 8
    model, params, batches = _stream_model_inputs(cuda, n)
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05)
    out = []
    for fl in (FLConfig(n_clients=n), FLConfig(n_clients=n, client_chunk=n)):
        state = init_train_state(ad, params, device=cuda)
        step = make_slab_round_step(model.loss_fn, ch, ad, fl, device=cuda)
        provider = TorchDraws(ch, state.spec, n, seed=4, device=cuda)
        for t in range(3):
            state, _ = step(state, provider(t), batches[t])
        out.append(state)
    assert torch.equal(out[0].w, out[1].w)
    assert all(torch.equal(a, b) for a, b in zip(out[0].opt, out[1].opt))


def test_streamed_round_reads_nothing_back(cuda):
    """batch_gen on the card, a dead round from an all-zero mask, and
    rounds under set_sync_debug_mode("error")."""
    from repro_torch.core.draws import RoundDraws
    n, d = 64, 256

    def loss_fn(p, b):
        return (p["w"] - b["phase"].sin()).square().mean()

    def gen(draws, idx):
        return {"phase": idx.to(torch.float32) * 1e-3}

    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                              error_feedback=True))
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.02, alpha="auto")
    fl = FLConfig(n_clients=n, client_chunk=10, sample_rate=0.5)
    state = init_train_state(ad, {"w": torch.zeros(d)}, error_feedback=True,
                             device=cuda)
    step = make_slab_round_step(loss_fn, ch, ad, fl, device=cuda,
                                batch_gen=gen)
    provider = TorchDraws(ch, state.spec, n, seed=5, device=cuda,
                          sample_rate=0.5)
    state, _ = step(state, provider(0), None)
    dead = RoundDraws(**{**provider(1).__dict__,
                         "mask": torch.zeros(n, device=cuda)})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, m = step(state, dead, None)
        live, _ = step(new, provider(2), None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(new.w, state.w) and torch.equal(new.ef, state.ef)
    assert torch.equal(new.alpha_hat, state.alpha_hat)
    assert float(m.n_participants) == 0.0 and int(new.step) == 2
    assert not torch.equal(live.w, new.w)


# ---------------------------------------------------------------------------
# Flash attention (B5) and the dense model it serves.
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, Sq, Sk, H, K, D, causal, window): tests/test_kernels.py's, then
    # ragged tiles, D = 128 / 256, windows across several kv tiles
    (1, 32, 32, 2, 2, 16, True, None),
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 100, 100, 8, 8, 64, True, 48),
    (2, 1, 96, 4, 2, 32, False, None),
    (1, 80, 80, 6, 3, 16, True, 16),
    (1, 33, 65, 2, 1, 8, False, None),
    (2, 257, 257, 8, 2, 128, True, None),
    (1, 300, 300, 4, 1, 128, True, 100),
    (1, 130, 130, 2, 2, 256, True, None),
    (1, 70, 70, 4, 4, 80, False, 20),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    _, got, want, tol = _flash_run(cuda, case, dtype, sum(case[:6]))
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    tol_max = 2e-5 if dtype == torch.float32 else 1e-2 * float(
        want.float().abs().max())
    assert err <= tol_max, err
    assert float((diff / tol).max()) <= 1.0


def _flash_run(cuda, case, dtype, seed):
    """One wrapper call on the card: (variant launched, output, plain
    version's output, its per-element tolerance), with exactly one launch
    checked."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_tolerance)
    from repro_torch.kernels.ref import flash_attention_ref
    b, sq, sk, h, kh, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))
    n0 = {c: getattr(flash_attention, f"{c}_launches")
          for c in ("hopper", "scalar")}
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran = [c for c in n0 if getattr(flash_attention, f"{c}_launches")
           - n0[c] == 1]
    assert len(ran) == 1, ran
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    ref_abs_v = flash_attention_ref(
        q.float(), k.float(), v.float().abs(), causal=causal,
        window=window) if ran[0] == "hopper" else None
    return ran[0], got, want, flash_tolerance(ran[0], want, ref_abs_v)


@pytest.mark.parametrize("variant, dtype, d", [
    ("scalar", torch.float32, 32), ("scalar", torch.bfloat16, 32),
    ("scalar", torch.float32, 128), ("hopper", torch.bfloat16, 64),
    ("hopper", torch.bfloat16, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_rows_without_keys_match_plain(cuda, variant, dtype,
                                                       d, causal):
    """With a window and Sq > Sk + window - 1, rows from Sk + window - 1 on
    see no key: both kernels give them the plain version's value, the mean
    of v over all Sk keys; every row is held to the plain version."""
    case = (1, 300, 100, 4, 2, d, causal, 64)
    ran, got, want, tol = _flash_run(cuda, case, dtype, 9)
    assert ran == variant
    assert float(((got.float() - want.float()).abs() / tol).max()) <= 1.0
    mean = want.float()[0, 100 + 64 - 1:]
    assert float((mean - mean[:1]).abs().max()) <= 1e-6   # one value a head


HOPPER_CASES = [
    # (B, Sq, Sk, H, K, D, causal, window), bf16: one tile first, then Sq /
    # Sk ragged and unequal, GQA groups 1 / 5 / 12, causal and not,
    # windows smaller and larger than a tile, B = 2, D = 64 and 128
    (1, 128, 128, 1, 1, 128, False, None),
    (1, 128, 128, 1, 1, 64, False, None),
    (1, 128, 128, 1, 1, 128, True, None),
    (1, 200, 333, 4, 4, 128, False, None),
    (2, 333, 200, 10, 2, 128, True, None),
    (1, 257, 257, 12, 1, 64, True, None),
    (2, 300, 300, 5, 1, 128, True, 50),
    (1, 700, 700, 4, 4, 128, True, 300),
    (1, 700, 650, 12, 1, 64, False, 300),
    (2, 1, 96, 4, 2, 128, False, None),
    (1, 1000, 1000, 10, 2, 128, True, 1000),
]


@pytest.mark.parametrize("case", HOPPER_CASES, ids=str)
def test_flash_attention_hopper_kernel_matches_plain(cuda, case):
    ran, got, want, tol = _flash_run(cuda, case, torch.bfloat16,
                                     sum(case[:6]))
    assert ran == "hopper"
    share = float(((got.float() - want.float()).abs() / tol).max())
    assert share <= 1.0, share


def test_flash_attention_hopper_kernel_at_16_byte_offsets(cuda):
    """TMA needs 16-byte aligned addresses, not the 128 bytes of the
    swizzle: q, k and v 16 bytes past a 128-byte boundary still go to the
    Hopper kernel and match the plain version."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_tolerance)
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device=cuda).manual_seed(11)
    shapes = ((1, 200, 4, 128), (1, 200, 2, 128), (1, 200, 2, 128))
    q, k, v = (torch.empty(int(np.prod(s)) + 64, device=cuda,
                           dtype=torch.bfloat16)[8:8 + int(np.prod(s))]
               .view(s) for s in shapes)
    for t in (q, k, v):
        t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
        assert t.data_ptr() % 128 == 16
    n0 = flash_attention.hopper_launches
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    tol = flash_tolerance("hopper", want, flash_attention_ref(
        q.float(), k.float(), v.float().abs(), causal=True))
    torch.cuda.synchronize()
    assert flash_attention.hopper_launches - n0 == 1
    assert float(((got.float() - want.float()).abs() / tol).max()) <= 1.0


def test_flash_attention_variant_counters(cuda):
    """bf16 at D = 64 / 128 goes to the Hopper kernel; f32, D = 32 and a
    misaligned address to the scalar one; ``launches`` is their sum."""
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=cuda).manual_seed(3)

    def qkv(d, dtype):
        return [torch.randn(1, 64, 2, d, generator=gen, device=cuda)
                .to(dtype) for _ in range(3)]

    calls = [(qkv(128, torch.bfloat16), "hopper"),
             (qkv(64, torch.bfloat16), "hopper"),
             (qkv(128, torch.float32), "scalar"),
             (qkv(32, torch.bfloat16), "scalar"),
             (qkv(32, torch.float32), "scalar")]
    q, k, v = qkv(128, torch.bfloat16)
    flat = torch.empty(q.numel() + 4, device=cuda, dtype=torch.bfloat16)
    q8 = flat[4:].view(q.shape)       # 8 bytes past a 16-byte boundary
    q8.copy_(q)
    calls.append(([q8, k, v], "scalar"))
    for (q, k, v), variant in calls:
        before = {c: getattr(flash_attention, c) for c in (
            "launches", "hopper_launches", "scalar_launches")}
        flash_attention(q, k, v)
        torch.cuda.synchronize()
        after = {c: getattr(flash_attention, c) - n
                 for c, n in before.items()}
        other = "scalar" if variant == "hopper" else "hopper"
        assert after == {"launches": 1, f"{variant}_launches": 1,
                         f"{other}_launches": 0}, (q.dtype, q.shape[-1])


def test_flash_attention_wrapper_refuses_on_the_card(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros(1, 8, 4, 16, device=cuda, requires_grad=True)
    kv = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention(q.detach(), kv.bfloat16(), kv)


@pytest.mark.parametrize("arch", ["qwen3-14b", "starcoder2-15b"])
def test_dense_model_on_the_card_matches_the_cpu(cuda, arch):
    """Prefill on the card launches the kernel once a layer, decode never;
    logits and greedy ids agree with the CPU's plain versions (f32)."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.core.slab import tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    s = 80 if cfg.window else 40
    toks = torch.randint(0, cfg.vocab, (2, s),
                         generator=torch.Generator().manual_seed(1))
    cpu = generate(model, params, toks, 8)
    params_c = tree_map(lambda t: t.to(cuda), params)
    n0 = flash_attention.launches
    card = generate(model, params_c, toks.to(cuda), 8)
    assert flash_attention.launches - n0 == cfg.n_layers   # prefill only
    _close(card["prefill_logits"].cpu(), cpu["prefill_logits"], 1e-4)
    assert torch.equal(card["ids"].cpu(), cpu["ids"])
