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
rounding to one step of x/s and to zero bias; and its int8 payload,
scales and residual (host rounding, RTN) and sign payload are bitwise
the plain quantizer applied to the accumulating transmit's no-carry sum
plus ef (the same f32 operations in the same order). The receive kernel
agrees to 1e-6 of the output's scale; its statistics, one launch, to
1e-5, the same bits from run to run. The accumulating transmit kernel agrees
to 1e-6 of scale with its plain version and, where its rows split
across blocks, bitwise with ``ota_transmit_split_model`` (the same f32
operations in the same order). The flash-attention kernels sum in
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
                                             ota_transmit_split_model,
                                             pack_sign_slab, receive_blocks,
                                             row_split, sm_count)
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


@pytest.mark.parametrize("d", [175104, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adaptive_update_kernel_at_the_round_slabs(cuda, d, dtype):
    """The resident round's slab and the million-client stream's, every
    mode and alpha, aligned and 3 elements off 16-byte alignment."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    for offset in (0, 3):
        def r(scale=1.0):
            return (torch.randn(d + offset, generator=gen, device=cuda)
                    * scale)[offset:]
        g, w = r().to(dtype), r().to(dtype)
        delta, nu = r(0.1), r(0.01).abs()
        nu_max = nu + r(0.01).abs()
        delta[::17] = 0.0
        for mode in MODES:
            for alpha in (1.2, 1.5, 2.0):
                kw = dict(lr=0.01, beta1=0.9, beta2=0.3, alpha=alpha,
                          eps=1e-8, mode=mode,
                          nu_max=nu_max if mode == "amsgrad" else None)
                got = adaptive_update_slab(g, delta, nu, w, **kw)
                want = adaptive_update_ref(g, delta, nu, w, **kw)
                torch.cuda.synchronize()
                for a, b in zip(got[:-1], want[:-1]):
                    _close(a, b)
                if dtype == torch.float32:
                    _close(got[-1], want[-1])
                else:
                    step = 2.0 ** -7 * want[-1].float().abs().clamp_min(
                        2.0 ** -126)
                    assert torch.all((got[-1].float() - want[-1].float())
                                     .abs() <= step)


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


@pytest.mark.parametrize("shape", [(1, 175104), (1, 4096), (2000, 4096),
                                   (37, 4097)])
@pytest.mark.parametrize("pilot_stats", [False, True])
def test_ota_channel_kernel_at_the_streamed_and_edge_shapes(cuda, shape,
                                                          pilot_stats):
    """The streamed finishes (one row, h = 1, n_total = 1), h in two
    chunks of the kernel's 1024 rows, and d % 4 != 0 (plain loads)."""
    n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    grads = torch.randn(n, d, generator=gen, device=cuda)
    h = (torch.ones(n, device=cuda) if n == 1 else
         0.5 + torch.rand(n, generator=gen, device=cuda))
    u = (2 * torch.rand(d, generator=gen, device=cuda) - 1) * CMS_U_BOUND
    e = -torch.log(torch.rand(d, generator=gen, device=cuda))
    grads[:, -38:], u[-38:], e[-38:] = 0.0, 0.0, 1.0
    kw = dict(alpha=1.5, scale=0.1, pilot_stats=pilot_stats,
              n_total=1 if n == 1 else None)
    n0 = ota_channel_slab.launches
    got = ota_channel_slab(grads, h, u, e, **kw)
    want = ota_channel_ref(grads, h, u, e, **kw)
    torch.cuda.synchronize()
    assert ota_channel_slab.launches == n0 + 1
    if pilot_stats:
        (got, gs), (want, ws) = got, want
        assert float(gs[0]) == float(ws[0]) == d - 38
        _close(gs, ws, 1e-5)
    _close(got, want)
    assert torch.all(got[-38:] == 0.0)


@pytest.mark.parametrize("n, d", [(50, 175104), (2000, 4096), (1, 4096)])
def test_ota_channel_kernel_with_scale_zero_is_the_transmit_sum(cuda, n, d):
    """Scale 0: the channel kernel's sum is the accumulating transmit's
    no-carry sum, bitwise (both walk the same ring in row order), and
    its bulk-copy ring and plain loads (G 4 bytes off a 16-byte
    boundary) agree bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(n * d)
    grads = torch.randn(n, d, generator=gen, device=cuda)
    h = 0.5 + torch.rand(n, generator=gen, device=cuda)
    u = (2 * torch.rand(d, generator=gen, device=cuda) - 1) * CMS_U_BOUND
    e = -torch.log(torch.rand(d, generator=gen, device=cuda))
    z, o = torch.zeros(d, device=cuda), torch.ones(d, device=cuda)
    for kw in (dict(), dict(n_total=n + 3)):
        assert torch.equal(ota_channel_slab(grads, h, z, o, alpha=1.5,
                                            scale=0.0, **kw),
                           ota_transmit_slab(grads, h, **kw))
    off = torch.empty(n * d + 1, device=cuda)[1:].view(n, d)
    off.copy_(grads)
    assert torch.equal(ota_channel_slab(grads, h, u, e, alpha=1.5, scale=0.1),
                       ota_channel_slab(off, h, u, e, alpha=1.5, scale=0.1))


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


@pytest.mark.parametrize("qmode,stochastic,zero_fold",
                         [("int8", True, False), ("int8", False, False),
                          ("sign", False, False), ("sign", False, True)])
@pytest.mark.parametrize("shape", [(50, 175104), (1, 175104), (7, 640)])
def test_transmit_kernel_is_the_plain_quantizer_on_the_no_carry_sum(
        cuda, shape, qmode, stochastic, zero_fold):
    """x = the accumulating transmit's no-carry call + ef; the kernel's
    int8 payload, scales and residual (host rounding, RTN) and its sign
    payload are bitwise ota_transmit_ref(x[None], 1, n_total=1); the sign
    scales and residuals within 1e-6 rel + 1e-6 of scale (the warp sums
    |x| in another order than torch.mean). At 1 x 175,104 as the
    streamed finish calls it (h = 1, n_total = 1); at 640 columns the
    last tile holds one quantization block."""
    n, d = shape
    grads, h, r, ef = _wire_inputs(cuda, n, d)
    n_total = None
    if n == 1:
        h, n_total = torch.ones_like(h), 1
    sr = qmode == "int8" and stochastic
    kw = dict(quantize=True, stochastic=stochastic, qmode=qmode,
              zero_fold=zero_fold, return_residual=True)
    got = ota_transmit_slab(grads, h, n_total=n_total, r=r if sr else None,
                            ef=ef, **kw)
    x = ota_transmit_slab(grads, h, n_total=n_total) + ef
    want = ota_transmit_ref(x[None], torch.ones(1, device=cuda), n_total=1,
                            r=r if sr else None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    if qmode == "int8":
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    else:
        _close(got[1], want[1])
        assert torch.allclose(got[2], want[2], rtol=1e-6,
                              atol=1e-6 * float(x.abs().max()))
    assert torch.all(got[0][d - 38:] == (1 if zero_fold else 0))


def test_transmit_kernel_refuses_what_the_ring_cannot_read(cuda):
    """G off a 16-byte boundary and d not a multiple of 128 are refused
    before any launch; so are an ef or r off a 16-byte boundary."""
    grads = torch.zeros(2 * 1024 + 1, device=cuda)
    h = torch.ones(2, device=cuda)
    n0 = ota_transmit_slab.launches
    with pytest.raises(ValueError, match="aligned"):
        ota_transmit_slab(grads[1:].view(2, 1024), h, quantize=True,
                          stochastic=False)
    with pytest.raises(ValueError, match="multiple"):
        ota_transmit_slab(torch.zeros(2, 1000, device=cuda), h,
                          quantize=True, stochastic=False)
    ef = torch.zeros(1024 + 1, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        ota_transmit_slab(torch.zeros(2, 1024, device=cuda), h,
                          quantize=True, stochastic=False, ef=ef)
    with pytest.raises(ValueError, match="aligned"):
        ota_transmit_slab(torch.zeros(2, 1024, device=cuda), h,
                          quantize=True, r=ef)
    assert ota_transmit_slab.launches == n0


@pytest.mark.parametrize("packed", [None, "fold"])
def test_receive_statistics_are_one_launch_and_the_same_bits(cuda, packed):
    """With pilot statistics the receive is one kernel launch (the last
    block folds the blocks' rows: no second launch), its statistics the
    same bits in two runs, within 1e-5 of the plain version with the
    count exact, and the ticket counter back at 0; the grid is resident
    on the card in one wave.

    The kernels are counted in the active step of a profiler schedule
    with one warm-up step, CPU and CUDA activities on: the warm-up step
    sets up CUPTI's activity tracing, whose first kernel records a
    capture of one step with CUDA activity alone could miss. Before it,
    ``device.warm_up_profiler`` runs one throwaway session in the
    process (as ``chip_smoke.py``'s profiler helper does): a process's
    first capture could drop the kernel even with the warm-up step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.device import warm_up_profiler
    from repro_torch.kernels.ota_channel import _PACKED, _TILE_COUNTERS
    d = 175104
    gen = torch.Generator(device=cuda).manual_seed(6)
    s = torch.rand(1, d // 128, generator=gen, device=cuda)
    u = (2 * torch.rand(d, generator=gen, device=cuda) - 1) * CMS_U_BOUND
    e = -torch.log(torch.rand(d, generator=gen, device=cuda))
    u[-38:], e[-38:] = 0.0, 1.0
    q = torch.randint(-127, 128, (1, d), generator=gen, device=cuda,
                      dtype=torch.int8)
    q[:, -38:] = 0
    payload = q if packed is None else pack_sign_slab(
        torch.where(q < 0, -1, 1).to(torch.int8))
    kw = dict(alpha=1.5, scale=0.1, packed=packed, pilot_stats=True)
    first = ota_receive_slab(payload, s, u, e, **kw)
    torch.cuda.synchronize()
    warm_up_profiler()
    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            again = ota_receive_slab(payload, s, u, e, **kw)
            torch.cuda.synchronize()
            prof.step()
    assert len(traces) == 1
    # the step's own annotation shows on the card's timeline too
    kernels = [ev.key for ev in traces[0]
               if ev.device_type == DeviceType.CUDA
               and not ev.key.startswith("ProfilerStep")
               for _ in range(ev.count)]
    assert len(kernels) == 1 and "ota_receive_kernel" in kernels[0], kernels
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    _, ws = ota_receive_ref(payload, s, u, e, **kw)
    assert float(first[1][0]) == float(ws[0]) == d - 38
    _close(first[1], ws, 1e-5)
    assert all(int(c.abs().sum()) == 0 for c in _TILE_COUNTERS.values())
    per_sm = build.load_library().repro_ota_receive_blocks_per_sm(
        _PACKED[packed], 1)
    assert per_sm * sm_count(cuda.index or 0) >= receive_blocks(d), per_sm


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
        s0 = ota_receive_slab.stats_launches
        got = ota_receive_slab(payload, s, u, e, **kw)
        assert ota_receive_slab.launches == n0 + 1
        assert ota_receive_slab.stats_launches == s0 + int(pilot_stats)
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


def test_update_kernel_with_device_alpha_makes_no_host_sync(cuda):
    """The kernel reads the tracked alpha where it lies: a launch under
    sync_debug_mode("error") at the main path's slab."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    g, w = (torch.randn(175104, generator=gen, device=cuda)
            for _ in range(2))
    delta = 0.1 * torch.randn(175104, generator=gen, device=cuda)
    nu = 0.01 * torch.rand(175104, generator=gen, device=cuda)
    kw = dict(lr=0.01, beta1=0.9, beta2=0.3, eps=1e-8, mode="adam",
              alpha=torch.tensor(1.5, device=cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = adaptive_update_slab(g, delta, nu, w, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = adaptive_update_ref(g, delta, nu, w, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        _close(x, y)


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
    """One chunk and no carry give the channel kernel's faded sum
    bitwise (u = 0, e = 1 synthesize no interference): the property the
    streamed round's chunk >= N parity rests on (it passes no carry).
    Also B3a's case. A zero carry splits the rows at this width, and is
    then bitwise its own summation order instead."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    grads = torch.randn(50, 4096, generator=gen, device=cuda)
    h = 0.5 + torch.rand(50, generator=gen, device=cuda)
    u, e = torch.zeros(4096, device=cuda), torch.ones(4096, device=cuda)
    chan = ota_channel_slab(grads, h, u, e, alpha=1.5, scale=0.0)
    for kw in (dict(), dict(row_chunk=50)):
        assert torch.equal(ota_transmit_slab(grads, h, **kw), chan)
    zeros = torch.zeros(4096, device=cuda)
    n_seg = row_split(50, 4096, None, True, sm_count(cuda.index or 0))
    assert n_seg > 1
    assert torch.equal(ota_transmit_slab(grads, h, acc=zeros),
                       ota_transmit_split_model(grads, h, acc=zeros,
                                                n_seg=n_seg))


def test_stream_transmit_no_carry_at_the_million_chunk_is_the_channel_sum(
        cuda):
    """2000 x 4096 (8 column tiles): without a carry the rows do not
    split, so the sum is the channel kernel's, bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    grads = torch.randn(2000, 4096, generator=gen, device=cuda)
    h = 0.5 + torch.rand(2000, generator=gen, device=cuda)
    u, e = torch.zeros(4096, device=cuda), torch.ones(4096, device=cuda)
    chan = ota_channel_slab(grads, h, u, e, alpha=1.5, scale=0.0)
    for kw in (dict(), dict(row_chunk=2000), dict(n_total=2003)):
        want = (chan if "n_total" not in kw else
                ota_channel_slab(grads, h, u, e, alpha=1.5, scale=0.0,
                                 n_total=2003))
        assert torch.equal(ota_transmit_slab(grads, h, **kw), want)


@pytest.mark.parametrize("n, d, rc", [(2000, 4096, None), (2000, 4096, 64),
                                      (2000, 4096, 1999), (2000, 4096, 2000),
                                      (2001, 4100, None), (2001, 4100, 64),
                                      (5, 4096, None), (37, 4097, 3)])
def test_stream_transmit_split_matches_plain_and_its_order(cuda, n, d, rc):
    """Rows split across blocks (a carry at fewer column tiles than 2 an
    SM): within the tier of the plain version, bitwise the summation
    order the kernel's header states (``ota_transmit_split_model``), the
    same run to run, one launch, and the tile counters back at 0. Row
    chunks of 7 or 1 at 2000 rows do not split (over 64 chunks): the
    existing cases above hold them."""
    from repro_torch.kernels.ota_channel import _TILE_COUNTERS
    gen = torch.Generator(device=cuda).manual_seed(n + d + (rc or 0))
    grads = torch.randn(n, d, generator=gen, device=cuda)
    h = 0.5 + torch.rand(n, generator=gen, device=cuda)
    acc = torch.randn(d, generator=gen, device=cuda)
    n_seg = row_split(n, d, rc, True, sm_count(cuda.index or 0))
    assert n_seg > 1
    kw = dict(n_total=n + 3, acc=acc, row_chunk=rc)
    n0 = ota_transmit_slab.stream_launches
    got = ota_transmit_slab(grads, h, **kw)
    torch.cuda.synchronize()
    assert ota_transmit_slab.stream_launches - n0 == 1
    _close(got, ota_transmit_ref(grads, h, **kw))
    assert torch.equal(got, ota_transmit_split_model(grads, h, n_seg=n_seg,
                                                     **kw))
    assert torch.equal(got, ota_transmit_slab(grads, h, **kw))
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in _TILE_COUNTERS.values())


@pytest.mark.parametrize("n, d", [(50, 4096), (2000, 4096), (50, 175104)])
def test_stream_transmit_load_paths_agree(cuda, n, d):
    """The kernel's two ways of reading G compute the same value,
    bitwise: the bulk-copy ring (16-byte aligned G) and plain 4-byte
    loads (the same rows 4 bytes off a 16-byte boundary)."""
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    grads = torch.randn(n, d, generator=gen, device=cuda)
    flat = torch.empty(n * d + 1, device=cuda)
    off = flat[1:].view(n, d)
    off.copy_(grads)
    assert grads.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 4
    h = 0.5 + torch.rand(n, generator=gen, device=cuda)
    for acc in (None, torch.randn(d, generator=gen, device=cuda)):
        kw = dict(n_total=n + 3, acc=acc)
        assert torch.equal(ota_transmit_slab(grads, h, **kw),
                           ota_transmit_slab(off, h, **kw))


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
    ("hopper", torch.bfloat16, 128), ("hopper", torch.bfloat16, 80),
    ("hopper", torch.bfloat16, 96), ("hopper", torch.bfloat16, 112)])
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
    # D 80, 96, 112: the 128-column instance over zero-padded tiles;
    # ragged, unequal Sq / Sk, GQA (Kimi-K2's 64 / 8 heads), a window
    *((2, 333, 200, 8, 2, d, True, None) for d in (80, 96, 112)),
    *((1, 200, 333, 64, 8, d, False, None) for d in (80, 96, 112)),
    *((1, 700, 650, 4, 1, d, True, 300) for d in (80, 96, 112)),
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
    """bf16 at D = 64 / 128, and at D = 80 / 112 (padded to 128), goes to
    the Hopper kernel; f32, D = 32, D = 72 (not a multiple of 16) and a
    misaligned address to the scalar one; ``launches`` is their sum."""
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=cuda).manual_seed(3)

    def qkv(d, dtype):
        return [torch.randn(1, 64, 2, d, generator=gen, device=cuda)
                .to(dtype) for _ in range(3)]

    calls = [(qkv(128, torch.bfloat16), "hopper"),
             (qkv(64, torch.bfloat16), "hopper"),
             (qkv(112, torch.bfloat16), "hopper"),
             (qkv(80, torch.bfloat16), "hopper"),
             (qkv(72, torch.bfloat16), "scalar"),
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


@pytest.mark.parametrize("d", [80, 96, 112])
def test_flash_attention_hopper_kernel_writes_only_its_output(cuda, d):
    """At a head dimension the Hopper kernel pads to 128 columns, through
    its C entry, with q, k, v and out 16 bytes past a 128-byte boundary:
    nothing is written past (or before) the output, a view into a larger
    buffer of a sentinel that stays whole around it, and the output
    holds the Hopper tier of the plain version, bitwise the wrapper's."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_tolerance)
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device=cuda).manual_seed(d)
    b, sq, sk, h, kh = 1, 200, 257, 4, 2
    shapes = ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d), (b, sq, h, d))
    sentinel = -768.0
    bufs = [torch.full((int(np.prod(sh)) + 64,), sentinel, device=cuda,
                       dtype=torch.bfloat16) for sh in shapes]
    q, k, v, out = (buf[8:8 + int(np.prod(sh))].view(sh)
                    for buf, sh in zip(bufs, shapes))
    for t in (q, k, v):
        t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
    assert all(t.data_ptr() % 128 == 16 for t in (q, k, v, out))
    lib = build.load_library()
    code = lib.repro_flash_attention_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, kh, d, 1, 0, 1.0 / float(np.sqrt(d)),
        torch.cuda.current_stream().cuda_stream)
    build.check(code, "flash_attention (hopper)")
    torch.cuda.synchronize()
    n = out.numel()
    assert bool((bufs[3][:8] == sentinel).all())
    assert bool((bufs[3][8 + n:] == sentinel).all())
    want = flash_attention_ref(q, k, v, causal=True)
    tol = flash_tolerance("hopper", want, flash_attention_ref(
        q.float(), k.float(), v.float().abs(), causal=True))
    assert float(((out.float() - want.float()).abs() / tol).max()) <= 1.0
    assert torch.equal(out, flash_attention(q, k, v, causal=True))


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


@pytest.mark.parametrize("arch", ["qwen3-14b", "starcoder2-15b"])
def test_lm_training_round_on_the_card_matches_the_cpu(cuda, arch):
    """The client step of LM training, vmap(grad_and_value(loss_fn)), on
    the card: no flash-attention launch (the loss takes the plain
    attention path, which has a backward), losses within 1e-5 and every
    gradient leaf within 1e-5 of its largest entry of the CPU's (f32)."""
    import dataclasses
    from torch.func import grad_and_value, vmap
    from repro_torch.configs import smoke_config
    from repro_torch.core.slab import tree_flatten, tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (3, 2, 80), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    step = vmap(grad_and_value(model.loss_fn), in_dims=(None, 0))
    g_cpu, l_cpu = step(params, {"tokens": toks})
    n0 = flash_attention.launches
    g_card, l_card = step(tree_map(lambda t: t.to(cuda), params),
                          {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert flash_attention.launches == n0
    np.testing.assert_allclose(l_card.cpu().numpy(), l_cpu.numpy(),
                               rtol=1e-5)
    for a, b in zip(tree_flatten(g_card)[0], tree_flatten(g_cpu)[0]):
        _close(a.cpu(), b, 1e-5)


SHARD_WIRES = [
    ("f32", dict(), 1.5),
    ("int8-ef-dl8-auto", dict(uplink=UplinkConfig(mode="int8",
                                                  error_feedback=True),
                              downlink="int8"), "auto"),
    ("sign-fold-ef", dict(uplink=UplinkConfig(mode="sign",
                                              error_feedback=True)), 1.5),
]


@pytest.mark.parametrize("name,chkw,alpha", SHARD_WIRES,
                         ids=[w[0] for w in SHARD_WIRES])
def test_one_rank_nccl_mesh_matches_the_resident_round(cuda, name, chkw,
                                                       alpha):
    """The sharded engine on the (1,)-mesh over NCCL (one rank in this
    process) against the resident round on the card, 3 rounds on the
    same draws: f32 within 1e-5 (B3a, a reduce-scatter and plain CMS
    against B2's one pass), the quantized state bitwise (the same
    transmit on the same draws); one B3a (or two B3c and two B4) and one
    B1 launch a round, no B2."""
    from repro_torch.core.fl import make_slab_round_runner
    from repro_torch.core.shard import gather_train_state, shard_train_state
    from repro_torch.launch.mesh import run_on_mesh

    d, c, n, b = 16, 4, 8, 6
    model = logistic_regression(d, c)
    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(0.1 * rng.normal(size=(d, c)).astype(
        np.float32)).to(cuda), "b": torch.zeros(c, device=cuda)}
    ch = OTAChannelConfig(**chkw)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=alpha)
    fl = FLConfig(n_clients=n)
    ef = ch.uplink.error_feedback
    state = init_train_state(ad, params, error_feedback=ef, device=cuda)
    batches = {"x": rng.normal(size=(3, n, b, d)).astype(np.float32),
               "y": rng.integers(0, c, (3, n, b)).astype(np.int64)}
    plain = TorchDraws(ch, state.spec, n, seed=2, device=cuda)
    mine = TorchDraws(ch, state.spec, n, seed=2, device=cuda, shard_index=0)
    want, _ = make_slab_round_runner(model.loss_fn, ch, ad, fl, device=cuda)(
        state, [plain(t) for t in range(3)], batches)

    def sharded(mesh):
        run = make_slab_round_runner(model.loss_fn, ch, ad, fl, device=cuda,
                                     backend="pallas_sharded", mesh=mesh)
        counts = (ota_channel_slab.launches, ota_transmit_slab.launches,
                  ota_receive_slab.launches,
                  ota_transmit_slab.nocarry_launches,
                  adaptive_update_slab.launches)
        got, _ = run(shard_train_state(state, mesh),
                     [mine(t) for t in range(3)], batches)
        got = gather_train_state(got, mesh)
        torch.cuda.synchronize()
        after = (ota_channel_slab.launches, ota_transmit_slab.launches,
                 ota_receive_slab.launches,
                 ota_transmit_slab.nocarry_launches,
                 adaptive_update_slab.launches)
        return got, tuple(a - b for a, b in zip(after, counts))

    got, launched = run_on_mesh(sharded, (1,), cuda)
    per_round = (0, 0, 0, 1, 1) if name == "f32" else (0, 2, 2, 0, 1)
    assert launched == tuple(3 * k for k in per_round)
    for x, y in zip([got.w, *got.opt, got.alpha_hat],
                    [want.w, *want.opt, want.alpha_hat]):
        if name == "f32":
            _close(x, y, 1e-5)
        else:
            assert torch.equal(x, y)
    if ef:
        assert torch.equal(got.ef, want.ef)


@pytest.mark.parametrize("shape", [(8, 40, 128, 96), (4, 1, 256, 64)])
def test_expert_product_takes_an_f32_output_on_the_card(cuda, shape):
    """The MoE expert product (``models.moe._expert_product``) of bf16
    operands on the card is cuBLAS with an f32 output; it agrees with the
    product of the operands cast to f32, the path of training and of the
    CPU, to 1e-5 of scale. An operand that requires grad takes that path."""
    from repro_torch.models.moe import _expert_product
    e, c, d, f = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(e, c, d, generator=gen, device=cuda).bfloat16()
    b = torch.randn(e, d, f, generator=gen, device=cuda).bfloat16()
    got = _expert_product(a, b)
    assert got.dtype == torch.float32 and got.shape == (e, c, f)
    _close(got, torch.bmm(a.float(), b.float()), 1e-5)
    grad = _expert_product(a, b.requires_grad_())
    assert grad.requires_grad
    _close(grad.detach(), got, 1e-5)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_recurrent_decode_step_on_the_card_matches_the_cpu(cuda, arch):
    """One RWKV / Hymba decode step on the card from the CPU's prefill
    cache: the logits and the cache it writes in place agree with the
    CPU's plain versions (f32, 1e-4 of scale); the card's prefill
    launches the flash kernel once a layer in Hymba, never in RWKV, and
    decode never."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.core.slab import tree_flatten, tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks}
    _, cache = model.prefill(params, batch, length=56)
    params_c = tree_map(lambda t: t.to(cuda), params)
    cache_c = tree_map(lambda t: t.to(cuda), cache)
    n0 = flash_attention.launches
    model.prefill(params_c, {"tokens": toks.to(cuda)}, length=56)
    torch.cuda.synchronize()
    assert flash_attention.launches - n0 == (
        cfg.n_layers if cfg.family == "hybrid" else 0)
    token = toks[:, -1:]
    want, cache = model.decode_step(params, cache, token, 40)
    n0 = flash_attention.launches
    got, cache_c = model.decode_step(params_c, cache_c, token.to(cuda), 40)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0
    _close(got.cpu(), want, 1e-4)
    for a, b in zip(tree_flatten(cache_c)[0], tree_flatten(cache)[0]):
        _close(a.cpu(), b, 1e-4)


# attend's non-causal calls without positions: cross-attention (Sq != Sk)
# and decode's one query row, at ragged key counts (1500 = 11 x 128 + 92,
# 1601 = 12 x 128 + 65), bf16 at D 64 / 128 (the Hopper variant) and f32
ATTEND_UNMASKED = [
    # (B, Sq, Sk, H, K, D)
    (2, 64, 1500, 16, 16, 64),        # Whisper's cross-attention
    (1, 1, 1500, 16, 16, 64),         # ... in decode
    (1, 300, 1500, 16, 16, 64),       # its encoder's size against fewer keys
    (2, 64, 1601, 32, 8, 128),        # Llama-3.2-Vision's over the image
    (4, 1, 1601, 32, 8, 128),         # ... in decode
    (1, 200, 70, 4, 2, 128),          # fewer keys than one tile
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ATTEND_UNMASKED, ids=str)
def test_attend_unmasked_without_positions_matches_plain(cuda, case, dtype):
    """``models.attention.attend`` with both positions None and neither a
    causal nor a window mask, Sq != Sk: one B5 launch, of the variant
    ``flash_variant`` picks (Hopper for bf16 at D 64 / 128), within its
    ``flash_tolerance`` of the plain version, every element."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_tolerance,
                                                     flash_variant)
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.attention import attend
    b, sq, sk, h, kh, d = case
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))
    n0 = flash_attention.launches
    s0 = flash_attention.shape_launches[(*case, False, None)]
    got = attend(q, k, v, None, None, False, None)
    torch.cuda.synchronize()
    assert flash_attention.launches - n0 == 1
    assert flash_attention.shape_launches[(*case, False, None)] - s0 == 1
    variant = flash_variant(dtype, d, sq, (q.data_ptr(), k.data_ptr(),
                                           v.data_ptr(), got.data_ptr()))
    assert variant == ("hopper" if dtype == torch.bfloat16 else "scalar")
    want = flash_attention_ref(q, k, v, causal=False)
    tol = flash_tolerance(variant, want, flash_attention_ref(
        q.float(), k.float(), v.float().abs(), causal=False)
        if variant == "hopper" else None)
    assert got.dtype == dtype and got.shape == q.shape
    assert float(((got.float() - want.float()).abs() / tol).max()) <= 1.0


def test_vlm_stack_init_on_the_card_is_drawn_in_place(cuda):
    """The vlm's nested stacks drawn on the card: n groups' inits in a row
    bitwise, and every random leaf of a group's dense layers drawn into
    the (n_groups, n_self, ...) stack's storage, none into a stack of its
    own."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.slab import tree_flatten
    from repro_torch.models import layers as tlayers
    from repro_torch.models import transformer as ttfm
    cfg = smoke_config("llama-3.2-vision-11b")
    init = ttfm.vlm_group(cfg)[0]
    drawn = []
    real = tlayers._drawn

    def spy(shape, dtype, gen, draw):
        drawn.append(real(shape, dtype, gen, draw))
        return drawn[-1]

    tlayers._drawn = spy
    try:
        stacked = ttfm.stack_init(
            init, torch.Generator(device=cuda).manual_seed(5), 3)
    finally:
        tlayers._drawn = real
    leaves = tree_flatten(stacked)[0]
    bases = {t.untyped_storage().data_ptr() for t in leaves}
    assert drawn and all(t.untyped_storage().data_ptr() in bases
                         for t in drawn)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for i in range(3):
        for a, b in zip(leaves, tree_flatten(init(gen))[0]):
            assert a.device.type == "cuda" and torch.equal(a[i], b)


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-11b"])
def test_cross_attention_model_on_the_card_matches_the_cpu(cuda, arch):
    """Whisper and Llama-3.2-Vision (smoke configs, f32) served on the
    card and on the CPU with the serve CLI's stub inputs: one B5 launch a
    prefill layer (the encoder's, the decoder's self- and cross-attention;
    the vlm's dense and cross layers) and one a cross-attention layer in
    each decode step; prefill logits within 1e-4 of scale, the greedy ids
    equal."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.core.slab import tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate, stub_inputs
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    inputs = stub_inputs(cfg, 2, "cpu")
    cpu = generate(model, params, toks, 8, inputs=inputs)
    params_c = tree_map(lambda t: t.to(cuda), params)
    n0 = flash_attention.launches
    card = generate(model, params_c, toks.to(cuda), 8,
                    inputs=tree_map(lambda t: t.to(cuda), inputs))
    torch.cuda.synchronize()
    if cfg.family == "encdec":
        prefill, cross = cfg.n_enc_layers + 2 * cfg.n_layers, cfg.n_layers
    else:
        prefill, cross = cfg.n_layers, cfg.n_layers // cfg.cross_attn_period
    assert flash_attention.launches - n0 == prefill + 7 * cross
    _close(card["prefill_logits"].cpu(), cpu["prefill_logits"], 1e-4)
    assert torch.equal(card["ids"].cpu(), cpu["ids"])


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen3-moe-235b-a22b"])
def test_remat_round_on_the_card_equals_the_plain_one(cuda, arch):
    """One resident f32 round of the tiny preset (4 clients x 2 x 32, f32
    parameters) on the card with remat on and off: one B2 and one B1
    launch each, no B5; the loss equal and the new weights within 1e-6
    of scale (Whisper's encoder output's gradient is summed over the
    decoder layers in another order under remat; the MoE dispatch's
    accumulating index_put runs in a batched recompute)."""
    import dataclasses
    from repro_torch.configs import preset_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import build_model
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.02, beta2=0.3)
    fl = FLConfig(n_clients=4)
    toks = torch.randint(0, 257, (4, 2, 32), generator=torch.Generator(
        ).manual_seed(5))
    batch = {"tokens": toks.to(cuda)}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(preset_config(arch, "tiny"),
                                  param_dtype="float32", remat=remat)
        if cfg.family == "encdec":
            batch["audio_embed"] = torch.randn(
                (4, 2, cfg.enc_seq, cfg.d_model),
                generator=torch.Generator().manual_seed(6)).to(cuda)
        model = build_model(cfg)
        state = init_train_state(ad, model.init(seed=0, device=cuda),
                                 device=cuda)
        draws = TorchDraws(ch, state.spec, 4, seed=1, device=cuda)(0)
        step = make_slab_round_step(model.loss_fn, ch, ad, fl, device=cuda)
        n = (ota_channel_slab.launches, adaptive_update_slab.launches,
             flash_attention.launches)
        state, metrics = step(state, draws, batch)
        torch.cuda.synchronize()
        assert (ota_channel_slab.launches - n[0],
                adaptive_update_slab.launches - n[1],
                flash_attention.launches - n[2]) == (1, 1, 0)
        out.append((state.w.cpu(), float(metrics.loss)))
    (w0, l0), (w1, l1) = out
    assert l0 == l1
    _close(w1, w0, 1e-6)


LEVER_CASES = [("qwen3-14b", dict(kv_chunk=8)),
               ("starcoder2-15b", dict(window=8, window_block=True)),
               ("hymba-1.5b", dict(window=8, window_block=True, kv_chunk=8,
                                   ssm_chunk=8))]


@pytest.mark.parametrize("arch,levers", LEVER_CASES,
                         ids=[a for a, _ in LEVER_CASES])
def test_levers_loss_on_the_card_matches_the_cpu(cuda, arch, levers):
    """The training forward with its levers and remat (smoke configs,
    f32), vmap(grad_and_value(loss_fn)) over 3 clients x 2 x 40 tokens on
    the card and on the CPU: no B5 launch, the losses within 1e-5 and
    every gradient leaf within 1e-5 of its largest entry."""
    import dataclasses
    from torch.func import grad_and_value, vmap
    from repro_torch.configs import smoke_config
    from repro_torch.core.slab import tree_flatten, tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32",
                              remat=True, **levers)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (3, 2, 40),
                         generator=torch.Generator().manual_seed(2))
    step = vmap(grad_and_value(model.loss_fn), in_dims=(None, 0))
    g_cpu, l_cpu = step(params, {"tokens": toks})
    n0 = flash_attention.launches
    g_card, l_card = step(tree_map(lambda t: t.to(cuda), params),
                          {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert flash_attention.launches == n0
    np.testing.assert_allclose(l_card.cpu().numpy(), l_cpu.numpy(),
                               rtol=1e-5)
    for a, b in zip(tree_flatten(g_card)[0], tree_flatten(g_cpu)[0]):
        _close(a.cpu(), b, 1e-5)


def test_remat_keeps_only_the_layer_inputs_on_the_card(cuda):
    """Under vmap(grad) on the card (the torch there runs a Function's
    forward with grad on under a transform) a stack of 16 layers, each
    with a (2, 4096, 1024) f32 intermediate, holds with remat less than
    half the memory it holds without: the forward keeps no activation,
    only each layer's input. The gradients are the same."""
    from torch.func import grad_and_value, vmap
    from repro_torch.core.slab import tree_map
    from repro_torch.models import transformer as ttfm
    g = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.to(cuda), {
        "w1": torch.randn(16, 256, 1024, generator=g) / 16,
        "w2": torch.randn(16, 1024, 256, generator=g) / 32})
    x = torch.randn(2, 2, 4096, 256, generator=g).to(cuda)

    def block(p, h):
        return h + torch.tanh(h @ p["w1"]) @ p["w2"], torch.zeros(
            (), device=h.device)

    def loss(p, xx, remat):
        y, _ = ttfm.stack_apply(block, p, xx, remat=remat)
        return (y ** 2).mean()

    held, grads = {}, {}
    for remat in (False, True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        grads[remat], _ = vmap(grad_and_value(lambda p, xx: loss(p, xx,
                                                                 remat)),
                               in_dims=(None, 0))(params, x)
        torch.cuda.synchronize()
        held[remat] = torch.cuda.max_memory_allocated(cuda) - base
    assert held[True] < 0.5 * held[False], held
    for k in params:
        _close(grads[True][k].cpu(), grads[False][k].cpu(), 1e-6)
