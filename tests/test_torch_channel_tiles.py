"""The channel kernel's (B2) host half, on the CPU.

The CUDA kernel (``csrc/ota_channel.cu``) gives each block a tile of
``CHANNEL_TILE`` columns (``channel_blocks``: its grid, and the rows of
its (blocks, 3) statistics buffer, which the wrapper sums). Each block
sums a column's rows in row order and divides once, as the accumulating
transmit's no-carry call does (``ota_transmit_split_model`` with one
segment), then adds the CMS term scale * xi. This machine has no card,
so that geometry and that arithmetic, written out in torch, are held
against the port's plain version and the JAX package's Pallas kernel in
interpret mode, at the main path's shapes and at the edges: one row (the
streamed finish), d % 4 != 0 (the kernel's plain-load path), d below
one tile, and more rows than the kernel stages of h at a time (1024).
The card holds the kernel itself to the same plain version in
``chip_smoke.py`` (phase 4) and ``tests/test_torch_cuda.py``.

Tiers: the output to 1e-6 of each entry plus 1e-6 of its scale (an f32
sum in another order than the plain ``einsum`` and the JAX kernel's);
the statistics to 1e-5 (sums over the blocks' rows), their count exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, to_np
from repro.kernels.ota_channel import ota_channel_slab as j_channel
from repro_torch.core.channel import CMS_U_BOUND
from repro_torch.kernels import ota_channel as tkern
from repro_torch.kernels.ref import log_moment_stats, ota_channel_ref

D_MAIN, D_MILLION = 175104, 4096


def _inputs(n, d, seed, pad=38):
    rng = np.random.default_rng(seed)
    grads = rng.normal(0, 1, (n, d)).astype(np.float32)
    h = (np.ones(n) if n == 1 else 0.5 + rng.random(n)).astype(np.float32)
    u = ((2 * rng.random(d) - 1) * CMS_U_BOUND).astype(np.float32)
    e = rng.exponential(1.0, d).astype(np.float32)
    pad = min(pad, d // 2)
    grads[:, d - pad:], u[d - pad:], e[d - pad:] = 0.0, 0.0, 1.0
    return grads, h, u, e, pad


def _kernel_order(grads, h, u, e, *, alpha, scale, n_total):
    """The kernel's arithmetic: the row-order faded sum divided once
    (the transmit's one-segment order), plus scale * xi (the plain
    version's transform, which the kernel's CMS warps compute op for
    op; with a zero gradient row the plain version is 0 + scale * xi)."""
    s = tkern.ota_transmit_split_model(grads, h, n_total=n_total)
    r = ota_channel_ref(torch.zeros((1, grads.shape[1])), torch.ones(1), u,
                        e, alpha=alpha, scale=scale)
    return s + r, r


@pytest.mark.parametrize("d, blocks", [(D_MAIN, 342), (D_MILLION, 8),
                                       (4097, 9), (512, 1), (513, 2),
                                       (100, 1), (1, 1)])
def test_channel_blocks_cover_every_column_once(d, blocks):
    """One block a column tile, the last one ragged: 342 at the main
    path's slab, 8 at the million-client stream's, one below a tile."""
    assert tkern.channel_blocks(d) == blocks
    cols = [range(b * tkern.CHANNEL_TILE, min(d, (b + 1) * tkern.CHANNEL_TILE))
            for b in range(blocks)]
    assert sorted(c for tile in cols for c in tile) == list(range(d))
    assert all(len(tile) > 0 for tile in cols)


@pytest.mark.parametrize("n, d", [(1, D_MILLION), (7, 1001), (5, 100),
                                  (1030, 256), (3, 513)])
def test_kernel_order_matches_the_plain_version_and_jax(n, d):
    """The kernel's order at the edges, against the plain version and
    the JAX kernel (interpret mode); with scale 0 it is the transmit's
    no-carry sum, bitwise (the streamed round's chunk >= N parity)."""
    grads, h, u, e, pad = _inputs(n, d, seed=n + d)
    n_total = 1 if n == 1 else None
    kw = dict(alpha=1.5, scale=0.1, n_total=n_total)
    tg, th, tu, te = map(torch.from_numpy, (grads, h, u, e))
    got, _ = _kernel_order(tg, th, tu, te, **kw)
    want = ota_channel_ref(tg, th, tu, te, **kw)
    scale = float(want.abs().max())
    assert_close(got, want, 1e-6, 1e-6 * scale, "plain version")
    j_out = j_channel(*map(jnp.asarray, (grads, h, u, e)), interpret=True,
                      **kw)
    assert_close(got, j_out, 1e-6, 1e-6 * scale, "JAX kernel")
    assert np.all(to_np(got)[d - pad:] == 0.0)
    zero, _ = _kernel_order(tg, th, tu, te, alpha=1.5, scale=0.0,
                            n_total=n_total)
    assert torch.equal(zero, tkern.ota_transmit_split_model(
        tg, th, n_total=n_total))


def test_kernel_order_matches_the_plain_version_at_the_main_slab():
    """50 x 175,104, the resident round's call, and its one-row streamed
    finish (h = 1, n_total = 1)."""
    grads, h, u, e, _ = _inputs(50, D_MAIN, seed=3)
    tg, th, tu, te = map(torch.from_numpy, (grads, h, u, e))
    for g, hh, n_total in ((tg, th, None), (tg[:1], th[:1] * 0 + 1, 1)):
        kw = dict(alpha=1.5, scale=0.1, n_total=n_total)
        got, _ = _kernel_order(g, hh, tu, te, **kw)
        want = ota_channel_ref(g, hh, tu, te, **kw)
        assert_close(got, want, 1e-6, 1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("d", [D_MAIN, 4097, 100])
def test_block_statistics_rows_sum_to_the_plain_statistics(d):
    """Each block's [count, sum log|r|, sum log^2|r|] over its tile's
    residuals, summed over the channel_blocks rows as the wrapper sums
    them, is the plain version's statistics; padding is not counted."""
    grads, h, u, e, pad = _inputs(2, d, seed=d)
    tg, th, tu, te = map(torch.from_numpy, (grads, h, u, e))
    _, want = ota_channel_ref(tg, th, tu, te, alpha=1.5, scale=0.1,
                              pilot_stats=True)
    _, r = _kernel_order(tg, th, tu, te, alpha=1.5, scale=0.1, n_total=None)
    tile = tkern.CHANNEL_TILE
    rows = torch.stack([log_moment_stats(r[b * tile:(b + 1) * tile])
                        for b in range(tkern.channel_blocks(d))])
    got = rows.sum(0)
    assert float(got[0]) == float(want[0]) == d - pad
    assert_close(got, want, 1e-5, 1e-5 * float(want.abs().max()))
