"""The accumulating transmit's row split, on the CPU.

The CUDA kernel (``csrc/ota_transmit_stream.cu``) splits a call's rows
into ``row_split`` segments across blocks and folds their partials in
segment order. This machine has no card, so its host half is tested
here: the split itself (``row_split``, ``segment_rows``), and
``ota_transmit_split_model``, the kernel's summation order written out
one f32 operation at a time, against the port's plain version and the
JAX package's oracle (and its Pallas kernel in interpret mode at small
shapes). The card holds the kernel against the same model in
``chip_smoke.py`` (phase 10) and ``tests/test_torch_cuda.py``.

Tier: 1e-6 of each entry plus 1e-6 of the output's scale (an f32 sum in
another order), the kernel's own tier.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ota_channel import ota_transmit_slab as j_transmit_slab
from repro.kernels.ref import ota_transmit_ref as j_transmit_ref
from repro_torch.convert import params_from_numpy
from repro_torch.core import stream as tstream
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import FLConfig, make_slab_round_step
from repro_torch.core.slab_state import init_train_state
from repro_torch.kernels import ota_channel as tkern
from repro_torch.kernels.ref import ota_transmit_ref
from repro_torch.models import vision as tvision

SMS = 132                     # an H100's streaming multiprocessors
N_MILLION, D_MILLION = 2000, 4096


def _scale_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    tol = 1e-6 * np.abs(want) + 1e-6 * float(np.abs(want).max())
    err = np.abs(got - want)
    assert np.all(err <= tol), f"{what}: max err {err.max()}"


# ---------------------------------------------------------------------------
# row_split / segment_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, d", [(N_MILLION, D_MILLION), (50, 175104),
                                  (2001, 4100), (5, 4096)])
def test_no_carry_takes_one_segment(n, d):
    """No carry: one segment, so the rows sum in the channel kernel's
    order (B3a's bitwise contract with B2)."""
    for rc in (None, 1, 7, n):
        assert tkern.row_split(n, d, rc, False, SMS) == 1


def test_full_column_grid_takes_one_segment():
    """50 x 175,104: 342 column tiles, over 2 blocks an SM already."""
    assert -(-175104 // tkern.TRANSMIT_TILE) >= 2 * SMS
    for rc in (None, 1, 7, 50):
        assert tkern.row_split(50, 175104, rc, True, SMS) == 1


@pytest.mark.parametrize("rc", [None, 64, 1999, N_MILLION])
def test_million_chunk_with_carry_splits(rc):
    s = tkern.row_split(N_MILLION, D_MILLION, rc, True, SMS)
    tiles = -(-D_MILLION // tkern.TRANSMIT_TILE)
    assert s > 1
    assert tiles * s <= tkern.SPLIT_BLOCKS_PER_SM * SMS + tiles
    if rc == 1999:     # two row chunks: at most two segments
        assert s == 2


@pytest.mark.parametrize("rc", [1, 7, 31])
def test_more_than_64_row_chunks_keep_one_segment(rc):
    assert -(-N_MILLION // rc) > tkern.MAX_SPLIT_CHUNKS
    assert tkern.row_split(N_MILLION, D_MILLION, rc, True, SMS) == 1


@pytest.mark.parametrize("rc", [1, 3, 7, 64, 1999])
@pytest.mark.parametrize("n, d", [(N_MILLION, D_MILLION), (2001, 4100),
                                  (37, 4097), (300, 512)])
def test_segments_fall_on_row_chunk_boundaries(n, d, rc):
    s = tkern.row_split(n, d, rc, True, SMS)
    seg = tkern.segment_rows(n, rc, s)
    if rc < n:
        assert seg % rc == 0
    # S segments of seg rows cover the rows, none of them empty
    assert (s - 1) * seg < n <= s * seg


@pytest.mark.parametrize("sms", [1, 4, 16, SMS])
@pytest.mark.parametrize("rc", [None, 1, 2, 5])
def test_never_more_segments_than_rows(sms, rc):
    for n in range(0, 41):
        for d in (1, 300, 4096):
            s = tkern.row_split(n, d, rc, True, sms)
            assert 1 <= s <= max(n, 1)
            if n:
                seg = tkern.segment_rows(n, rc, s)
                assert (s - 1) * seg < n <= s * seg


# ---------------------------------------------------------------------------
# The kernel's summation order (ota_transmit_split_model)
# ---------------------------------------------------------------------------

def _million_rows():
    """Rows shaped like the million-client path's first chunk: gradients
    of mean((w - sin(1e-3 idx))^2) at a random w (each column keeps one
    sign down the rows, so its sum adds up)."""
    rng = np.random.default_rng(10)
    w = rng.standard_normal(D_MILLION).astype(np.float32)
    idx = np.arange(N_MILLION, dtype=np.float32)
    g = 2.0 * (w[None, :] - np.sin(1e-3 * idx)[:, None]) / D_MILLION
    h = rng.uniform(0.2, 2.0, N_MILLION).astype(np.float32)
    return g.astype(np.float32), h


def _mixed_rows():
    """Zero-mean rows of both signs: the column sums cancel to ~1/45 of
    the summed magnitudes."""
    rng = np.random.default_rng(11)
    g = rng.standard_normal((N_MILLION, D_MILLION)).astype(np.float32)
    h = rng.uniform(0.5, 1.5, N_MILLION).astype(np.float32)
    return g, h


@pytest.mark.parametrize("rows, rc", [("million", None), ("million", 64),
                                      ("million", 1999), ("mixed", None),
                                      ("mixed", 64)])
def test_split_model_matches_both_oracles_at_the_million_chunk(rows, rc):
    g, h = _million_rows() if rows == "million" else _mixed_rows()
    acc = np.random.default_rng(12).normal(
        size=(D_MILLION,)).astype(np.float32) * 1e-3
    n_total = N_MILLION + 3
    s = tkern.row_split(N_MILLION, D_MILLION, rc, True, SMS)
    assert s > 1
    got = tkern.ota_transmit_split_model(
        torch.from_numpy(g), torch.from_numpy(h), n_total=n_total,
        acc=torch.from_numpy(acc), row_chunk=rc, n_seg=s)
    assert got.dtype == torch.float32 and got.shape == (D_MILLION,)
    plain = ota_transmit_ref(torch.from_numpy(g), torch.from_numpy(h),
                             n_total=n_total, acc=torch.from_numpy(acc),
                             row_chunk=rc)
    jax_want = j_transmit_ref(jnp.asarray(g), jnp.asarray(h),
                              n_total=n_total, acc=jnp.asarray(acc),
                              row_chunk=rc)
    _scale_close(got.numpy(), plain.numpy(), f"{rows} S={s} vs the port's")
    _scale_close(got.numpy(), jax_want, f"{rows} S={s} vs JAX's")


def test_many_small_chunks_keep_the_plain_versions_chain():
    """2000 row chunks of 1 row, with a carry, on rows whose chunk sums
    keep one sign: the plain version adds each chunk onto the carry and
    its 2000 roundings there drift; a split (the carry added once) lands
    nearer the f64 sum but off the plain version by more than the tier.
    So the call keeps one segment, whose order is the plain version's
    chain: it agrees to well within the tier."""
    g, h = _million_rows()
    acc = np.random.default_rng(9).normal(size=(D_MILLION,)).astype(
        np.float32)
    kw = dict(n_total=N_MILLION + 3, acc=torch.from_numpy(acc), row_chunk=1)
    g, h = torch.from_numpy(g), torch.from_numpy(h)
    plain = ota_transmit_ref(g, h, **kw).numpy()
    chain = tkern.ota_transmit_split_model(g, h, n_seg=1, **kw).numpy()
    split = tkern.ota_transmit_split_model(g, h, n_seg=33, **kw).numpy()
    exact = acc.astype(np.float64) + (h.double()[:, None] * g.double()).sum(
        0).numpy() / (N_MILLION + 3)
    tol = 1e-6 * np.abs(plain) + 1e-6 * np.abs(plain).max()
    assert np.all(np.abs(chain - plain) <= tol)
    assert np.abs(split - plain).max() > np.max(tol)
    assert np.abs(split - exact).max() < np.abs(plain - exact).max()
    assert tkern.row_split(N_MILLION, D_MILLION, 1, True, SMS) == 1


@pytest.mark.parametrize("d", [301, 256])
@pytest.mark.parametrize("rc", [None, 1, 3, 5])
def test_split_model_matches_the_interpret_kernel(d, rc):
    """Small shapes: the S the split gives 12 rows on cards of 1, 2, 3
    and 6 SMs, against the JAX Pallas kernel in interpret mode and the
    JAX oracle."""
    n, n_total = 12, 5
    rng = np.random.default_rng(d + (rc or 0))
    g = rng.normal(size=(n, d)).astype(np.float32)
    h = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    acc = rng.normal(size=(d,)).astype(np.float32)
    jkw = dict(n_total=n_total, acc=jnp.asarray(acc), row_chunk=rc)
    kern = j_transmit_slab(jnp.asarray(g), jnp.asarray(h), interpret=True,
                           **jkw)
    want = j_transmit_ref(jnp.asarray(g), jnp.asarray(h), **jkw)
    splits = {tkern.row_split(n, d, rc, True, sms) for sms in (1, 2, 3, 6)}
    assert max(splits) > 1
    for s in sorted(splits):
        got = tkern.ota_transmit_split_model(
            torch.from_numpy(g), torch.from_numpy(h), n_total=n_total,
            acc=torch.from_numpy(acc), row_chunk=rc, n_seg=s)
        _scale_close(got.numpy(), kern, f"S={s} vs the interpret kernel")
        _scale_close(got.numpy(), want, f"S={s} vs JAX's oracle")


def test_split_model_with_one_segment_is_the_row_order_sum():
    """S = 1, one chunk, no carry: 0 + (0 + s / n_total), s summed row by
    row: the channel kernel's faded sum."""
    rng = np.random.default_rng(13)
    g = torch.from_numpy(rng.normal(size=(9, 70)).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.5, 1.5, 9).astype(np.float32))
    s = torch.zeros(70)
    for r in range(9):
        s = s + h[r] * g[r]
    got = tkern.ota_transmit_split_model(g, h, n_total=11)
    assert torch.equal(got, s / torch.full((70,), 11.0))


def test_wrapper_on_the_cpu_runs_the_plain_version():
    """On a CPU tensor the split is never taken: the wrapper runs
    ``ota_transmit_ref`` and counts no launch."""
    g, h = _mixed_rows()
    g, h = torch.from_numpy(g[:64, :300]), torch.from_numpy(h[:64])
    acc = torch.ones(300)
    before = tkern.ota_transmit_slab.stream_launches
    got = tkern.ota_transmit_slab(g, h, acc=acc, row_chunk=7)
    assert tkern.ota_transmit_slab.stream_launches == before
    assert torch.equal(got, ota_transmit_ref(g, h, acc=acc, row_chunk=7))


# ---------------------------------------------------------------------------
# The one-chunk branch of streamed_round_parts passes no carry
# ---------------------------------------------------------------------------

def test_one_chunk_round_passes_no_carry_and_keeps_its_state(monkeypatch):
    """chunk = N: the transmit is called with acc=None, and three rounds
    leave the same state, bitwise, as with the acc=zeros call it
    replaced (0 + x == x)."""
    n, d, c, b = 8, 8, 4, 5
    rng = np.random.default_rng(0)
    params = {"w": (0.1 * rng.normal(size=(d, c))).astype(np.float32),
              "b": (0.1 * rng.normal(size=(c,))).astype(np.float32)}
    batches = [{"x": torch.from_numpy(
                    rng.normal(size=(n, b, d)).astype(np.float32)),
                "y": torch.from_numpy(rng.integers(0, c, (n, b)))}
               for _ in range(3)]
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=1.5)
    fl = FLConfig(n_clients=n, client_chunk=n)
    model = tvision.logistic_regression(d, c)
    transmit = tstream.ota_transmit_slab

    def run(with_zero_carry):
        calls = []

        def recorded(g, h, **kw):
            calls.append(kw)
            if with_zero_carry:
                kw = dict(kw, acc=torch.zeros(g.shape[1]))
            return transmit(g, h, **kw)

        monkeypatch.setattr(tstream, "ota_transmit_slab", recorded)
        state = init_train_state(ad, params_from_numpy(params, "cpu"),
                                 device="cpu")
        step = make_slab_round_step(model.loss_fn, ch, ad, fl, device="cpu")
        draws = TorchDraws(ch, state.spec, n, seed=4, device="cpu")
        for t in range(3):
            state, _ = step(state, draws(t), batches[t])
        return state, calls

    new, calls = run(False)
    old, _ = run(True)
    assert len(calls) == 3
    assert all(kw.get("acc") is None and "row_chunk" not in kw
               for kw in calls)
    assert torch.equal(new.w, old.w)
    assert torch.equal(new.alpha_hat, old.alpha_hat)
    assert all(torch.equal(a, b) for a, b in zip(new.opt, old.opt))
