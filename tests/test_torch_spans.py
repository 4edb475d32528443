"""The round's profiler spans and the host-sync counter
(``repro_torch.spans``), on a tiny logistic-regression round, resident
and streamed two clients a chunk.

Without a profiler ``span`` is one shared no-op and never reaches
``record_function``; under a CPU profiler the spans nest as the round
runs them; the round's state and metrics are the same bits with the
profiler on and off; ``host_syncs`` counts the five read backs a chunk
and, on a card only, one copy a batch leaf that comes from the host, on
the slab runner and on the per-round API.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import (FLConfig, init_server, make_round_step,
                                 make_slab_round_runner, run_rounds,
                                 run_rounds_slab)
from repro_torch.core.slab import slab_to_tree
from repro_torch.core.slab_state import init_train_state
from repro_torch.models import vision as tvision

N, D, C, B = 4, 8, 3, 5
ROUNDS = 4
CHUNKS = {"resident": None, "streamed": 2}     # FLConfig.client_chunk


def _setup(case, device="cpu", leaf=lambda x: x):
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=1.5, beta2=0.3)
    fl = FLConfig(n_clients=N, client_chunk=CHUNKS[case])
    model = tvision.logistic_regression(D, C)
    run = make_slab_round_runner(model.loss_fn, ch, ad, fl, device=device)
    rng = np.random.default_rng(0)
    params = {"w": torch.as_tensor(
        (0.1 * rng.normal(size=(D, C))).astype(np.float32), device=device),
        "b": torch.zeros((C,), device=device)}
    state = init_train_state(ad, params, device=device)
    draws = TorchDraws(ch, state.spec, N, seed=3, device=device)
    batches = [{"x": leaf(rng.normal(size=(N, B, D)).astype(np.float32)),
                "y": leaf(rng.integers(0, C, (N, B)))}
               for _ in range(ROUNDS)]
    return run, state, draws, batches.__getitem__


def _run(case, n_rounds=2, chunk=1, **kw):
    run, state, draws, batch_fn = _setup(case, **kw)
    return run_rounds_slab(run, state, draws, batch_fn, n_rounds,
                           chunk=chunk)


def _state_tensors(st):
    return [st.w, *st.opt, st.alpha_hat]


def test_span_is_one_shared_noop_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(spans, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("round") is spans.span("mac")
    for case in CHUNKS:
        _, hist = _run(case)
        assert len(hist) == 2


def _span_events(prof):
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(),
            e.name()[len(spans.PREFIX):])
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU
           and e.name().startswith(spans.PREFIX)]
    return sorted(out, key=lambda x: (x[0], -x[1]))


def _parents(events):
    """(name, name of the innermost span that holds it) of each span."""
    out = []
    for i, (s, e, name) in enumerate(events):
        holders = [x for j, x in enumerate(events)
                   if j != i and x[0] <= s and e <= x[1]]
        out.append((name, max(holders)[2] if holders else None))
    return out


# (span, the span that holds it): in each round, the runner's metric
# stack after the rounds of a chunk, the read back after it
RESIDENT = [("feed", None), ("draws", "feed"), ("round", None),
            ("h2d", "round"), ("broadcast", "round"), ("clients", "round"),
            ("mac", "round"), ("metrics", "round"), ("server", "round"),
            ("metrics", "round"), ("metrics", None), ("readback", None)]
# streamed: each chunk's clients inside the MAC's pass over the chunks
STREAMED = [("feed", None), ("draws", "feed"), ("round", None),
            ("h2d", "round"), ("broadcast", "round"), ("mac", "round"),
            *[("clients", "mac")] * (N // CHUNKS["streamed"]),
            ("server", "round"), ("metrics", "round"), ("metrics", None),
            ("readback", None)]


@pytest.mark.parametrize("case", list(CHUNKS))
def test_spans_nest_as_the_round_runs_them(case):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(case, n_rounds=2, chunk=1)
    want = {"resident": RESIDENT, "streamed": STREAMED}[case]
    assert _parents(_span_events(prof)) == want * 2


@pytest.mark.parametrize("case", list(CHUNKS))
def test_the_round_is_the_same_bits_under_the_profiler(case):
    plain, hist = _run(case, n_rounds=3, chunk=2)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, thist = _run(case, n_rounds=3, chunk=2)
    assert thist == hist
    for a, b in zip(_state_tensors(plain), _state_tensors(traced)):
        assert torch.equal(a, b)
    # the runner's stacked RoundMetrics, every field
    run, state, draws, batch_fn = _setup(case)
    batches = {k: np.stack([batch_fn(t)[k] for t in range(2)])
               for k in ("x", "y")}
    _, m = run(state, [draws(t) for t in range(2)], batches)
    run, state, draws, batch_fn = _setup(case)
    with profile(activities=[ProfilerActivity.CPU]):
        _, tm = run(state, [draws(t) for t in range(2)], batches)
    for a, b in zip(m, tm):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(CHUNKS))
def test_host_syncs_counts_the_read_backs_and_no_cpu_copy(case):
    before = spans.host_syncs
    _run(case, n_rounds=3, chunk=1)
    assert spans.host_syncs - before == 3 * 5
    before = spans.host_syncs
    _run(case, n_rounds=4, chunk=2)
    assert spans.host_syncs - before == 2 * 5


def _run_round_api(device, leaf, n_rounds=2):
    """The per-round pytree API (``make_round_step`` + ``run_rounds``)
    on the resident case's inputs."""
    _, state, draws, batch_fn = _setup("resident", device=device, leaf=leaf)
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha=1.5, beta2=0.3)
    fl = FLConfig(n_clients=N)
    step = make_round_step(tvision.logistic_regression(D, C).loss_fn, ch, ad,
                           fl, device=device)
    params = slab_to_tree(state.spec, state.w)
    return run_rounds(step, params, init_server(params, ad), draws, batch_fn,
                      n_rounds)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["slab", "round_step"])
@pytest.mark.parametrize("leaf", ["numpy", "cpu", "pinned", "cuda"])
def test_host_syncs_counts_each_batch_leaf_from_the_host(leaf, entry):
    """On the card: one count a batch leaf a round that is not already
    on the card (two leaves), on the slab runner plus its five read
    backs, and on the per-round API."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    make = {"numpy": lambda x: x,
            "cpu": torch.as_tensor,
            "pinned": lambda x: torch.as_tensor(x).pin_memory(),
            "cuda": lambda x: torch.as_tensor(x, device="cuda")}[leaf]
    copies = 0 if leaf == "cuda" else 2
    if entry == "round_step":
        before = spans.host_syncs
        _run_round_api("cuda", make)
        assert spans.host_syncs - before == 2 * copies
        return
    for case in CHUNKS:
        before = spans.host_syncs
        _run(case, n_rounds=2, chunk=1, device="cuda", leaf=make)
        assert spans.host_syncs - before == 2 * (5 + copies)
