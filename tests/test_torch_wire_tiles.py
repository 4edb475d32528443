"""The quantized wire's kernels' host half (B3c transmit, B4 receive), on
the CPU.

The quantize transmit (``csrc/ota_transmit.cu``) gives each block a tile
of ``CHANNEL_TILE`` columns (``channel_blocks`` of them); its 4 walker
warps own 4 adjacent columns a thread, so walker warp w is exactly
quantization block w of the tile. Each walker sums its columns' rows in
row order and divides once (``ota_transmit_split_model`` with one
segment, the accumulating transmit's no-carry order), adds ef, and the
warp quantizes its block: max|x| (int8) or sum|x| (sign) by a butterfly
of shuffles, then the plain quantizer's per-entry operations.

The receive kernel (``csrc/ota_receive.cu``) runs one column a thread,
``RECEIVE_THREADS`` a block (``receive_blocks``): a warp's 32 columns
lie in one quantization block and in one word of a packed plane. Its
rows sum from 0 in row order, then + scale * xi. With pilot statistics
each block writes its row (a shuffle tree over its threads, then over
its warps), and the last block folds the rows in a fixed order: thread
t adds rows t, t + T, ... (T threads a block), then the same trees.

The kernels run only on a card, so here that geometry and that
arithmetic, written out in torch, are held against the port's plain versions and the JAX
package (the transmit's Pallas kernel in interpret mode and its oracle;
the receive's oracle, as ``tests/test_torch_wire.py`` holds it) at the
wire runs' shapes: 50 x 175,104, the streamed finish's 1 x 175,104
(h = 1, n_total = 1) and 1,100 x 4096 (more rows than the 1,024 of h a
block stages at once). The card holds the kernels to the same plain
versions in ``chip_smoke.py`` (phases 5 and 6) and
``tests/test_torch_cuda.py``.

Tiers: the kernel order's int8 payload, scales and residual, and its
sign payload, are bitwise the plain quantizer applied to its x (the
"plain composition"); its sign scales and residuals within 1e-6 rel +
1e-6 of scale (the shuffle sums |x| in another order than torch.mean).
Against the plain version and JAX, whose sums run in other orders, the
int8 payload is equal on 99.9 % of entries and within one step, scales
within 1e-6 rel + 1e-6 of the largest, residuals within 1e-6 rel + 1e-6
of the sum's scale (one step where an entry flipped). The sum's scale is
max_c sum_n |h[n] G[n, c]| / n_total + max|ef|, the magnitude an f32
sum's roundings follow: with 1,100 random rows max|x| is 8 times
smaller, and the row-order sum is 1.15e-6 of max|x| from torch.sum's. Receive:
1e-6 of scale against the plain version, 1e-5 against JAX; statistics
1e-5, the count exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, to_np
from repro.kernels import ota_channel as jkern
from repro.kernels import ref as jref
from repro_torch.core.channel import CMS_U_BOUND
from repro_torch.kernels import ota_channel as tkern
from repro_torch.kernels.ref import (INT8_MAX, LANE, log_moment_stats,
                                     ota_receive_ref, ota_transmit_ref,
                                     pack_sign_slab)

D_MAIN = 175104
WALKERS = tkern.CHANNEL_TILE // 4      # 4 columns a walker thread
WARP = 32
MODES = [("int8", True, False), ("int8", False, False),
         ("sign", False, False), ("sign", False, True)]
MODE_IDS = ["int8-sr", "int8-rtn", "sign", "sign-fold"]
SHAPES = [(50, D_MAIN), (1, D_MAIN), (1100, 4096)]


# ---- B3c: the quantize transmit ----------------------------------------

def _walker_warps(d):
    """(tile, warp, its columns) of every walker warp that is on: warp w
    of tile b owns the tile's columns 128 w .. 128 w + 127, 4 a thread."""
    out = []
    for b in range(tkern.channel_blocks(d)):
        tile0 = b * tkern.CHANNEL_TILE
        width = min(tkern.CHANNEL_TILE, d - tile0)
        for w in range(WALKERS // WARP):
            cols = [tile0 + 4 * t + j for t in range(w * WARP, (w + 1) * WARP)
                    for j in range(4)]
            if 4 * w * WARP < width:
                assert all(c < tile0 + width for c in cols)
                out.append((b, w, cols))
            else:
                assert all(c >= tile0 + width for c in cols)
    return out


@pytest.mark.parametrize("d, tiles", [(D_MAIN, 342), (4096, 8), (128, 1),
                                      (640, 2)])
def test_transmit_walker_warp_is_one_quantization_block(d, tiles):
    """Every walker warp that is on owns exactly one LANE block (so its
    max or sum is a warp shuffle, and lane 0 writes that block's scale),
    the warps cover every column once, and a warp is wholly inside the
    slab or wholly past it (d % 128 == 0): at 640 the last tile holds one
    block and one warp."""
    assert tkern.channel_blocks(d) == tiles
    warps = _walker_warps(d)
    assert sorted(c for _, _, cols in warps for c in cols) == list(range(d))
    for b, w, cols in warps:
        blk = (b * tkern.CHANNEL_TILE) // LANE + w
        assert cols == list(range(blk * LANE, (blk + 1) * LANE))
    assert len(warps) == d // LANE
    if d == 640:
        assert [w for b, w, _ in warps if b == 1] == [0]


def _butterfly(v, op):
    """A warp's __shfl_xor_sync reduction over its last axis (32 lanes):
    every lane ends with the same value."""
    lanes = torch.arange(WARP)
    for off in (16, 8, 4, 2, 1):
        v = op(v, v[..., lanes ^ off])
    return v


def _transmit_kernel_order(grads, h, *, n_total, r, qmode, stochastic,
                           zero_fold, ef):
    """The kernel's arithmetic, block by block: x from the one-segment
    row-order sum plus ef; each warp (a LANE block, 32 threads of 4
    columns) reduces its threads' 4-column max or left-to-right sum of
    |x| by a butterfly; then the per-entry quantizer."""
    x = tkern.ota_transmit_split_model(grads, h, n_total=n_total)
    if ef is not None:
        x = x + ef
    xb = x.reshape(-1, WARP, 4)                      # (blocks, lanes, 4)
    ax = xb.abs()
    if qmode == "sign":
        t = ((ax[..., 0] + ax[..., 1]) + ax[..., 2]) + ax[..., 3]
        mean = _butterfly(t, torch.add)[:, 0] / 128.0
        s = mean if zero_fold else torch.where(mean > 0, mean,
                                               torch.ones_like(mean))
        q = (torch.where(x < 0, -1.0, 1.0) if zero_fold
             else torch.sign(x))
    else:
        m = _butterfly(ax.amax(-1), torch.maximum)[:, 0]
        s = torch.where(m > 0, m / INT8_MAX, torch.ones_like(m))
        y = x / s.repeat_interleave(LANE)
        y = torch.floor(y + r) if stochastic else torch.round(y)
        q = torch.clamp(y, -INT8_MAX, INT8_MAX)
    resid = x - q * s.repeat_interleave(LANE)
    return x, (q.to(torch.int8), s, resid)


def _tx_inputs(n, d, seed, pad=38):
    rng = np.random.default_rng(seed)
    grads = rng.normal(0, 1, (n, d)).astype(np.float32)
    h = (np.ones(n) if n == 1 else 0.5 + rng.random(n)).astype(np.float32)
    r = rng.random(d).astype(np.float32)
    ef = (0.01 * rng.normal(0, 1, d)).astype(np.float32)
    grads[:, d - pad:], ef[d - pad:] = 0.0, 0.0
    grads[:, 128:256], ef[128:256] = 0.0, 0.0      # an all-zero block
    return grads, h, r, ef


def _sum_scale(grads, h, n_total, ef):
    """max_c sum_n |h[n] G[n, c]| / n_total + max|ef|."""
    n_total = grads.shape[0] if n_total is None else n_total
    terms = np.abs(h[:, None].astype(np.float64) * grads).sum(0) / n_total
    return float(terms.max() + np.abs(ef).max())


def _assert_wire(got, want, scale, *, exact):
    """The wire's tier: payload equal on >= 99.9 % (all, if exact) and
    within one step; scales within 1e-6 rel + 1e-6 of the largest;
    residual within 1e-6 rel + 1e-6 of the sum's scale where the payloads
    agree, within one step where one flipped."""
    q, qw = to_np(got[0]).astype(np.float32), to_np(want[0]).astype(np.float32)
    same = q == qw
    assert np.mean(same) >= (1.0 if exact else 0.999)
    assert np.all(np.abs(q - qw) <= 1.0)
    sw = to_np(want[1])
    assert_close(got[1], want[1], 1e-6, 1e-6 * float(np.max(np.abs(sw))), "s")
    a, b = to_np(got[2]), to_np(want[2])
    tol = 1e-6 * np.abs(b) + 1e-6 * scale
    assert np.all(np.abs(a - b)[same] <= tol[same])
    step = np.repeat(sw, LANE)
    assert np.all(np.abs(a - b)[~same] <= step[~same] * (1 + 1e-6))


@pytest.mark.parametrize("qmode,stochastic,zero_fold", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("n, d", SHAPES)
def test_transmit_kernel_order_matches_the_plain_composition_and_jax(
        n, d, qmode, stochastic, zero_fold):
    """The kernel's order is bitwise the plain quantizer on its own x
    (int8: payload, scales, residual; sign: the payload), and holds the
    wire's tier against the plain version, the JAX oracle and the JAX
    kernel in interpret mode; the padding tail and the all-zero block
    are exact."""
    grads, h, r, ef = _tx_inputs(n, d, seed=n + d)
    n_total = 1 if n == 1 else None
    sr = qmode == "int8" and stochastic
    kw = dict(quantize=True, stochastic=stochastic, qmode=qmode,
              zero_fold=zero_fold, return_residual=True)
    tg, th, tr, te = map(torch.from_numpy, (grads, h, r, ef))
    x, got = _transmit_kernel_order(tg, th, n_total=n_total, r=tr,
                                    qmode=qmode, stochastic=stochastic,
                                    zero_fold=zero_fold, ef=te)
    composed = ota_transmit_ref(x[None], torch.ones(1), n_total=1,
                                r=tr if sr else None, **kw)
    assert torch.equal(got[0], composed[0])
    if qmode == "int8":
        assert torch.equal(got[1], composed[1])
        assert torch.equal(got[2], composed[2])
    scale = _sum_scale(grads, h, n_total, ef)
    _assert_wire(got, composed, scale, exact=True)
    plain = ota_transmit_ref(tg, th, n_total=n_total, r=tr if sr else None,
                             ef=te, **kw)
    _assert_wire(got, plain, scale, exact=False)
    jkw = dict(n_total=n_total, r=jnp.asarray(r) if sr else None,
               ef=jnp.asarray(ef), **kw)
    jg, jh = jnp.asarray(grads), jnp.asarray(h)
    for j_out in (jref.ota_transmit_ref(jg, jh, **jkw),
                  jkern.ota_transmit_slab(jg, jh, interpret=True, **jkw)):
        _assert_wire(got, j_out, scale, exact=False)
    q, s = to_np(got[0]), to_np(got[1])
    assert np.all(q[d - 38:] == (1 if zero_fold else 0))
    assert s[1] == (0.0 if zero_fold else 1.0)


def test_transmit_kernel_order_without_ef_is_the_no_carry_sum_quantized():
    """Without ef, x is the accumulating transmit's no-carry output as it
    is (the composition chip_smoke.py checks on the card)."""
    grads, h, r, _ = _tx_inputs(50, 4096, seed=9)
    tg, th, tr = map(torch.from_numpy, (grads, h, r))
    x, got = _transmit_kernel_order(tg, th, n_total=None, r=tr, qmode="int8",
                                    stochastic=True, zero_fold=False, ef=None)
    assert torch.equal(x, tkern.ota_transmit_split_model(tg, th))
    composed = ota_transmit_ref(x[None], torch.ones(1), n_total=1, r=tr,
                                quantize=True, return_residual=True)
    for a, b in zip(got, composed):
        assert torch.equal(a, b)


# ---- B4: the receive -----------------------------------------------------

@pytest.mark.parametrize("d", [D_MAIN, 4096, 640, 128])
def test_receive_warps_lie_in_one_scale_block_and_whole_words(d):
    """receive_blocks(d) blocks of RECEIVE_THREADS, one column a thread,
    cover every column once (684 blocks at the main path's slab); a
    warp's 32 columns share one scale (one quantization block) and are
    one word of a packed plane; a warp is wholly inside the slab or past
    it (d % 128 == 0)."""
    blocks = tkern.receive_blocks(d)
    assert tkern.receive_blocks(D_MAIN) == 684
    assert (blocks - 1) * tkern.RECEIVE_THREADS < d
    assert blocks * tkern.RECEIVE_THREADS >= d
    warps = [range(w0, w0 + WARP)
             for w0 in range(0, blocks * tkern.RECEIVE_THREADS, WARP)
             if w0 < d]
    assert sorted(c for w in warps for c in w) == list(range(d))
    for w in warps:
        assert w[-1] < d
        assert len({c // LANE for c in w}) == 1
        assert len({c // 32 for c in w}) == 1


def _rx_inputs(rows, d, seed, pad=38):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (rows, d)).astype(np.int8)
    q3 = rng.choice(np.array([-1, 0, 1], np.int8), (rows, d))
    s = rng.random((rows, d // LANE)).astype(np.float32)
    u = rng.uniform(-CMS_U_BOUND, CMS_U_BOUND, d).astype(np.float32)
    e = (-np.log(rng.random(d))).astype(np.float32)
    q[:, d - pad:], q3[:, d - pad:] = 0, 0
    u[d - pad:], e[d - pad:] = 0.0, 1.0
    return q, q3, s, u, e


def _interference(u, e, *, alpha, scale):
    """scale * xi, the plain version's transform (its out with a zero
    payload is 0 + scale * xi), computed once a test: on the CPU two
    evaluations of the transform can differ at a few angles next to the
    clip bound (1.2e-4 relative seen), so each test holds one."""
    d = u.numel()
    return ota_receive_ref(torch.zeros((1, d), dtype=torch.int8),
                           torch.ones((1, d // LANE)), u, e, alpha=alpha,
                           scale=scale)


def _receive_kernel_order(q, s, rx):
    """The kernel's sum: from 0, rows in order, + q * s, then + rx
    (= scale * xi)."""
    rows, d = q.shape
    acc = torch.zeros(d)
    for r in range(rows):
        acc = acc + q[r].float() * s[r].repeat_interleave(LANE)
    return acc + rx


@pytest.mark.parametrize("packed", [None, "fold", "planes"])
@pytest.mark.parametrize("rows", [1, 3])
def test_receive_kernel_order_matches_the_plain_version_and_jax(rows, packed):
    """The kernel's order against the plain version (its dequantized sum
    with u = 0, e = 1, where xi = 0, plus the same scale * xi) and the
    JAX oracle's dequantized sum; padding exactly 0 but under fold."""
    q, q3, s, u, e = _rx_inputs(rows, D_MAIN, seed=rows)
    if packed is not None:
        q = np.where(q3 < 0, -1, 1).astype(np.int8) if packed == "fold" else q3
    tq, ts, tu, te = map(torch.from_numpy, (q, s, u, e))
    rx = _interference(tu, te, alpha=1.5, scale=0.1)
    got = _receive_kernel_order(tq, ts, rx)
    if packed is None:
        tp, jp = tq, jnp.asarray(q)
    else:
        tp = pack_sign_slab(tq, planes=packed == "planes")
        jp = jkern.pack_sign_slab(jnp.asarray(q), planes=packed == "planes")
    zero_u, one_e = torch.zeros(D_MAIN), torch.ones(D_MAIN)
    kw = dict(alpha=1.5, scale=0.1, packed=packed)
    want = ota_receive_ref(tp, ts, zero_u, one_e, **kw) + rx
    scale = float(want.abs().max())
    assert_close(got, want, 1e-6, 1e-6 * scale, "plain version")
    if rows == 1:
        assert torch.equal(got, want)
    j_sum = jref.ota_receive_ref(jp, jnp.asarray(s), jnp.zeros(D_MAIN),
                                 jnp.ones(D_MAIN), **kw)
    assert_close(got - rx, j_sum, 1e-5, 1e-5 * scale, "JAX oracle")
    if packed != "fold":
        assert np.all(to_np(got)[D_MAIN - 38:] == 0.0)


def _shfl_down_tree(v):
    """A warp's __shfl_down_sync sum over its last axis (32 lanes), as
    lane 0 ends with it: lane i adds lane i + off for off = 16 .. 1."""
    for off in (16, 8, 4, 2, 1):
        v = torch.cat([v[..., :WARP - off] + v[..., off:],
                       2 * v[..., WARP - off:]], dim=-1)
    return v[..., 0]


def _block_sum(v):
    """ota_common.cuh's stats_block_sum over (..., threads, 3): each
    warp's tree, then the warps' sums by the same tree in warp 0."""
    n_warps = v.shape[-2] // WARP
    v = v.transpose(-1, -2).reshape(*v.shape[:-2], 3, n_warps, WARP)
    warps = _shfl_down_tree(v)                      # (..., 3, warps)
    lanes = torch.zeros((*warps.shape[:-1], WARP))
    lanes[..., :n_warps] = warps
    return _shfl_down_tree(lanes)                   # (..., 3)


def _receive_stats_in_block_order(r):
    """The kernel's statistics of r = scale * xi: each thread's [count,
    log|r|, log^2|r|] of its column, each block's row by _block_sum, then
    the last block's fold: thread t adds rows t, t + T, ... in order (T
    threads a block), then _block_sum."""
    threads = tkern.RECEIVE_THREADS
    blocks = tkern.receive_blocks(r.numel())
    cols = torch.zeros(blocks * threads)
    cols[:r.numel()] = r
    a = cols.abs().reshape(blocks, threads)
    m = a > 0
    lr = torch.where(m, torch.log(torch.clamp_min(a, torch.finfo().tiny)),
                     torch.zeros_like(a))
    per = torch.stack([m.float(), lr, lr * lr], dim=-1)
    rows = _block_sum(per)                          # (blocks, 3)
    acc = torch.zeros(threads, 3)
    for k in range(0, blocks, threads):
        part = rows[k:k + threads]
        acc[:part.shape[0]] = acc[:part.shape[0]] + part
    return rows, _block_sum(acc)


@pytest.mark.parametrize("d", [D_MAIN, 4096, 640])
def test_receive_statistics_fold_matches_the_plain_statistics(d):
    """The blocks' rows folded in the kernel's fixed order are the plain
    version's statistics and the JAX oracle's, the count exact (padding
    not counted); the rows alone sum to them too."""
    q, _, s, u, e = _rx_inputs(1, d, seed=d)
    tu, te = torch.from_numpy(u), torch.from_numpy(e)
    rx = _interference(tu, te, alpha=1.5, scale=0.1)
    rows, got = _receive_stats_in_block_order(rx)
    assert rows.shape == (tkern.receive_blocks(d), 3)
    want = log_moment_stats(rx)
    _, j_stats = jref.ota_receive_ref(jnp.asarray(q), jnp.asarray(s),
                                      jnp.asarray(u), jnp.asarray(e),
                                      alpha=1.5, scale=0.1, pilot_stats=True)
    for other in (want, j_stats):
        other = to_np(other)
        assert float(got[0]) == float(other[0]) == d - 38
        assert_close(got, other, 1e-5, 1e-5 * float(np.max(np.abs(other))))
    assert_close(rows.sum(0), want, 1e-5, 1e-5 * float(want.abs().max()))
