"""The streamed uplink's clean sum carried by the accumulating transmit.

The serial chunk loop (``core/stream.py:fold_chunks``, which the
single-device streamed round and the sharded engine both run) folds each
chunk's unfaded masked sum ``clean + sum(m[:, None] * G, 0)`` into the
same launch as the faded one (``ota_transmit_slab(..., clean=,
mask=)``), from one read of the chunk's gradient stack.

On the CPU: ``ota_transmit_split_model(clean=, mask=)``, the kernel's
clean order written out one f32 operation at a time, against the plain
sum (the tier below), and bit for bit at 2 rows and one segment; the
wrapper's CPU route bit for bit the plain version, counting no launch;
a streamed serial round at chunk 2 whose ``StreamParts`` (and a round
of the sharded engine on the (1,)-mesh, over gloo) are bit for bit
those of the unfused formula.

Marked ``cuda`` (each test skips from a fixture where there is no CUDA
device or no nvcc): the fused launch bit for bit its split model on
every schedule (the few-row walk, the bulk-copy ring with and without
a row split, plain loads), its faded sum bit for bit a launch without
the clean carry, its clean sum at 2 rows bit for bit torch's on the
card, and the launches a streamed round counts, on one card and on the
(1,)-mesh over NCCL. This file imports
neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_stream_clean.py

Tier: 1e-6 of each entry plus 1e-6 of the output's scale (an f32 sum in
another order), the kernel's own tier.
"""

import numpy as np
import pytest
import torch
from torch.func import vmap

from repro_torch.convert import params_from_numpy
from repro_torch.core import shard
from repro_torch.core import stream as tstream
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import FLConfig, make_slab_round_step
from repro_torch.core.round import client_update
from repro_torch.core.slab import make_slab_spec
from repro_torch.core.slab_state import init_train_state
from repro_torch.kernels import build
from repro_torch.kernels import ota_channel as tkern
from repro_torch.kernels.ref import ota_transmit_ref
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import vision as tvision

SMS = 132                     # an H100's streaming multiprocessors
N_MILLION, D_MILLION = 2000, 4096


def _scale_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    tol = 1e-6 * np.abs(want) + 1e-6 * float(np.abs(want).max())
    err = np.abs(got - want)
    assert np.all(err <= tol), f"{what}: max err {err.max()}"


def _plain_clean(g, clean, mask):
    """The unfused formula of the serial loop."""
    return clean + torch.sum(mask[:, None] * g, dim=0)


def _rows(n, d, seed, zeros=False, law="mixed"):
    """(g, h, acc, clean, mask): rows, a carry of each kind and a 0/1
    mask, all ones unless ``zeros`` (then about half zero). ``law``
    "mixed": zero-mean rows of both signs; "million": rows shaped like
    the million-client path's, gradients of mean((w - sin(1e-3 idx))^2)
    at a random w (each column keeps one sign down the rows, so its sum
    adds up), as in tests/test_torch_stream_split.py."""
    rng = np.random.default_rng(seed)
    if law == "million":
        w = rng.standard_normal(d).astype(np.float32)
        idx = np.arange(n, dtype=np.float32)
        g = torch.from_numpy((2.0 * (w[None, :] - np.sin(1e-3 * idx)[:, None])
                              / d).astype(np.float32))
    else:
        g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    acc = torch.from_numpy(1e-3 * rng.standard_normal(d).astype(np.float32))
    clean = torch.from_numpy(1e-3 * rng.standard_normal(d).astype(np.float32))
    mask = (torch.from_numpy((rng.uniform(size=n) < 0.5).astype(np.float32))
            if zeros else torch.ones(n))
    return g, h, acc, clean, mask


# ---------------------------------------------------------------------------
# The split model's clean order, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, d, rc, zeros, law", [
    (2, 175104, None, False, "mixed"),         # the cell's chunk: S = 1
    (N_MILLION, D_MILLION, None, False, "million"),  # S > 1
    (N_MILLION, D_MILLION, 64, False, "million"),
    (N_MILLION, D_MILLION, 1999, False, "million"),
    (N_MILLION, D_MILLION, None, False, "mixed"),
    (N_MILLION, D_MILLION, 64, False, "mixed"),
    (37, 4097, 3, False, "mixed"),             # a ragged d
    (N_MILLION, D_MILLION, None, True, "million"),  # a 0/1 mask with zeros
], ids=["two-rows", "million", "million-rc64", "million-rc1999", "mixed",
        "mixed-rc64", "ragged-d", "mask-zeros"])
def test_split_model_clean_matches_the_plain_sum(n, d, rc, zeros, law):
    """As for the faded sum (tests/test_torch_stream_split.py), a
    segment of 1000 rows or more sums the million path's rows within the
    tier; zero-mean rows take the splits of 32 segments."""
    g, h, acc, clean, mask = _rows(n, d, seed=n + d + (rc or 0), zeros=zeros,
                                   law=law)
    n_seg = tkern.row_split(n, d, rc, True, SMS)
    assert (n_seg == 1) == (n == 2)
    kw = dict(n_total=n + 3, acc=acc, row_chunk=rc, n_seg=n_seg)
    out, clean_out = tkern.ota_transmit_split_model(g, h, clean=clean,
                                                    mask=mask, **kw)
    assert clean_out.dtype == torch.float32 and clean_out.shape == (d,)
    # the clean carry leaves the faded order alone
    assert torch.equal(out, tkern.ota_transmit_split_model(g, h, **kw))
    _scale_close(clean_out.numpy(), _plain_clean(g, clean, mask).numpy(),
                 f"{n}x{d} rc={rc} S={n_seg}")


@pytest.mark.parametrize("m", [(1, 1), (1, 0), (0, 1), (0, 0)])
def test_split_model_clean_at_two_rows_is_bitwise_the_plain_sum(m):
    """2 rows, S = 1, a 0/1 mask: clean + (m0 g0 + m1 g1), the value of
    the unfused formula, so the streamed cell's clean_slab is kept."""
    g, h, acc, clean, _ = _rows(2, 175104, seed=5)
    mask = torch.tensor(m, dtype=torch.float32)
    assert tkern.row_split(2, 175104, None, True, SMS) == 1
    _, clean_out = tkern.ota_transmit_split_model(g, h, acc=acc, clean=clean,
                                                  mask=mask)
    assert torch.equal(clean_out, _plain_clean(g, clean, mask))


@pytest.mark.parametrize("rc", [None, 7])
def test_wrapper_cpu_route_is_the_plain_version(rc):
    """On a CPU tensor the fused call runs ``ota_transmit_ref`` and the
    unfused formula, op for op, and counts no launch."""
    g, h, acc, clean, mask = _rows(64, 300, seed=6, zeros=True)
    counts = (tkern.ota_transmit_slab.stream_launches,
              tkern.ota_transmit_slab.clean_launches)
    out, clean_out = tkern.ota_transmit_slab(g, h, acc=acc, row_chunk=rc,
                                             clean=clean, mask=mask)
    assert counts == (tkern.ota_transmit_slab.stream_launches,
                      tkern.ota_transmit_slab.clean_launches)
    assert torch.equal(out, ota_transmit_ref(g, h, acc=acc, row_chunk=rc))
    assert torch.equal(clean_out, _plain_clean(g, clean, mask))


@pytest.mark.parametrize("kw, match", [
    (dict(clean="c"), "together"),
    (dict(mask="m"), "together"),
    (dict(clean="c", mask="m", quantize=True), "f32 only"),
    (dict(clean="c", mask="m2"), "mask"),
])
def test_wrapper_refuses_a_bad_clean_carry(kw, match):
    g, h, _, clean, mask = _rows(4, 256, seed=7)
    ops = {"c": clean, "m": mask, "m2": torch.ones(3)}
    kw = {k: ops.get(v, v) for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        tkern.ota_transmit_slab(g, h, **kw)


# ---------------------------------------------------------------------------
# A streamed serial round keeps its clean sum
# ---------------------------------------------------------------------------

def _logreg(n, d=8, c=4, b=5, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (0.1 * rng.normal(size=(d, c))).astype(np.float32),
              "b": (0.1 * rng.normal(size=(c,))).astype(np.float32)}
    batch = {"x": torch.from_numpy(rng.normal(size=(n, b, d)).astype(
                 np.float32)),
             "y": torch.from_numpy(rng.integers(0, c, (n, b)))}
    return tvision.logistic_regression(d, c), params, batch


def _shard_step(model, ch, fl, params, device):
    """The sharded engine's step and a fresh state of the rank's slices,
    on the (1,)-mesh given as the first argument."""
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=1.5)

    def build(mesh):
        state = shard.shard_train_state(
            init_train_state(ad, params, device=device), mesh)
        return state, make_slab_round_step(
            model.loss_fn, ch, ad, fl, device=device,
            backend="pallas_sharded", mesh=mesh)
    return build


@pytest.mark.parametrize("engine, n, flkw", [
    ("single", 8, {}), ("single", 8, dict(sample_rate=0.5)),
    ("single", 7, {}),
    ("shard", 8, {}), ("shard", 8, dict(sample_rate=0.5)), ("shard", 7, {}),
], ids=["full", "sampled", "ragged", "shard-full", "shard-sampled",
        "shard-ragged"])
def test_serial_round_at_chunk_2_keeps_clean_slab_bitwise(monkeypatch,
                                                          engine, n, flkw):
    """The single-device streamed uplink's ``StreamParts``, or the
    sharded engine's round on the (1,)-mesh (its state and metrics), bit
    for bit those of the unfused formula: both walk the chunks in
    ``core.stream.fold_chunks``."""
    model, params, batch = _logreg(n)
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    fl = FLConfig(n_clients=n, client_chunk=2, **flkw)
    p = params_from_numpy(params, "cpu")
    spec = make_slab_spec(p)
    draws = TorchDraws(ch, spec, n, seed=3, device="cpu",
                       sample_rate=fl.sample_rate)(0)
    client = vmap(client_update(model.loss_fn, fl), in_dims=(None, 0))
    transmit = tstream.ota_transmit_slab
    calls = []

    def recorded(g, h, **kw):
        calls.append(kw)
        return transmit(g, h, **kw)

    def unfused(g, h, *, n_total, acc, clean, mask):
        out = transmit(g, h, n_total=n_total, acc=acc)
        return out, clean + torch.sum(mask[:, None] * g, dim=0)

    def single(_):
        parts = tstream.streamed_round_parts(draws, ch, fl, spec, client, p,
                                             client_batches=batch)
        return {f: getattr(parts, f) for f in (
            "g_slab", "h", "mask", "n_participants", "norm", "loss_sum",
            "clean_slab")}

    def sharded(mesh):
        state, step = _shard_step(model, ch, fl, p, "cpu")(mesh)
        new, metrics = step(state, draws, batch)
        return {"w": new.w, "opt": torch.stack(new.opt),
                "step": new.step, **metrics._asdict()}

    def run():
        if engine == "single":
            return single(None)
        return run_on_mesh(sharded, (1,), "cpu")

    monkeypatch.setattr(tstream, "ota_transmit_slab", recorded)
    fused = run()
    chunks = -(-n // 2)
    assert len(calls) == chunks
    assert all(kw["clean"] is not None and kw["mask"].shape == (2,)
               for kw in calls)
    monkeypatch.setattr(tstream, "ota_transmit_slab", unfused)
    parent = run()
    assert fused.keys() == parent.keys()
    for f in fused:
        assert torch.equal(fused[f], parent[f]), f
    if flkw:
        assert float(fused["n_participants"]) < n      # the mask has zeros


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    return torch.device("cuda")


def _card_rows(cuda, n, d, seed, zeros=True):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    g = torch.randn(n, d, generator=gen, device=cuda)
    h = 0.5 + torch.rand(n, generator=gen, device=cuda)
    acc = 1e-3 * torch.randn(d, generator=gen, device=cuda)
    clean = torch.randn(d, generator=gen, device=cuda)
    mask = ((torch.rand(n, generator=gen, device=cuda) < 0.5).float()
            if zeros else torch.ones(n, device=cuda))
    if zeros:
        mask[0] = 1.0
    return g, h, acc, clean, mask


@pytest.mark.cuda
@pytest.mark.parametrize("n, d, rc, offset", [
    (2, 175104, None, 0),            # the few-row walk, S = 1
    (4, 175104, 3, 0),               # the few-row walk, two pieces
    (2, 175104, None, 1),            # G 4 bytes off: plain loads, S = 1
    (8, 175104, None, 0),            # the ring, S = 1
    (2, 4096, None, 0),              # few rows, split: the ring's fold
    (N_MILLION, D_MILLION, None, 0),  # the million chunk, S > 1
    (N_MILLION, D_MILLION, 64, 0),
    (37, 4097, 3, 0),                # plain loads, split
])
def test_fused_launch_is_bitwise_its_split_model(cuda, n, d, rc, offset):
    from repro_torch.kernels.ota_channel import _TILE_COUNTERS
    g, h, acc, clean, mask = _card_rows(cuda, n, d, seed=n + d + offset)
    if offset:
        flat = torch.empty(n * d + offset, device=cuda)
        g = flat[offset:].view(n, d).copy_(g)
    n_seg = tkern.row_split(n, d, rc, True, tkern.sm_count(cuda.index or 0))
    kw = dict(n_total=n + 3, acc=acc, row_chunk=rc)
    counts = (tkern.ota_transmit_slab.stream_launches,
              tkern.ota_transmit_slab.clean_launches)
    out, clean_out = tkern.ota_transmit_slab(g, h, clean=clean, mask=mask,
                                             **kw)
    assert (tkern.ota_transmit_slab.stream_launches - counts[0],
            tkern.ota_transmit_slab.clean_launches - counts[1]) == (1, 1)
    want_out, want_clean = tkern.ota_transmit_split_model(
        g, h, clean=clean, mask=mask, n_seg=n_seg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out), f"S={n_seg}"
    assert torch.equal(clean_out, want_clean), f"S={n_seg}"
    assert torch.equal(out, tkern.ota_transmit_slab(g, h, **kw))
    again = tkern.ota_transmit_slab(g, h, clean=clean, mask=mask, **kw)
    assert torch.equal(again[0], out) and torch.equal(again[1], clean_out)
    _scale_close(clean_out.cpu(), _plain_clean(g, clean, mask).cpu(),
                 f"{n}x{d} S={n_seg}")
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in _TILE_COUNTERS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [175104, 50_000_000])
def test_two_row_clean_is_torchs_sum_on_the_card(cuda, d):
    """The streamed cell's shape: the fused clean sum equals the unfused
    formula run by torch on the card, bit for bit, for each 0/1 mask."""
    g, h, acc, clean, _ = _card_rows(cuda, 2, d, seed=d)
    for m in ((1.0, 1.0), (1.0, 0.0), (0.0, 1.0), (0.0, 0.0)):
        mask = torch.tensor(m, device=cuda)
        out, clean_out = tkern.ota_transmit_slab(g, h, n_total=32, acc=acc,
                                                 clean=clean, mask=mask)
        torch.cuda.synchronize()
        assert torch.equal(clean_out, _plain_clean(g, clean, mask)), m
        assert torch.equal(out, tkern.ota_transmit_slab(g, h, n_total=32,
                                                        acc=acc))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["single", "shard"])
def test_a_streamed_round_counts_its_clean_launches(cuda, engine):
    """32 clients at chunk 2: 16 transmit launches a round, each with the
    clean carry, on one card and on the (1,)-mesh over NCCL."""
    n = 32
    model, params, batch = _logreg(n)
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=1.5)
    fl = FLConfig(n_clients=n, client_chunk=2)
    p = params_from_numpy(params, "cuda")
    batch = {k: v.to(cuda) for k, v in batch.items()}

    def counted(state, step):
        draws = TorchDraws(ch, state.spec, n, seed=4, device="cuda")
        counts = (tkern.ota_transmit_slab.stream_launches,
                  tkern.ota_transmit_slab.clean_launches)
        step(state, draws(0), batch)
        torch.cuda.synchronize()
        return (tkern.ota_transmit_slab.stream_launches - counts[0],
                tkern.ota_transmit_slab.clean_launches - counts[1])

    if engine == "single":
        launched = counted(init_train_state(ad, p, device="cuda"),
                           make_slab_round_step(model.loss_fn, ch, ad, fl,
                                                device="cuda"))
    else:
        launched = run_on_mesh(
            lambda mesh: counted(*_shard_step(model, ch, fl, p,
                                              "cuda")(mesh)), (1,), cuda)
    assert launched == (16, 16)
