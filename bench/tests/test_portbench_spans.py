"""The span table (``portbench/spans.py``) and its report
(``bench/span_report.py``), on the CPU.

On synthetic kineto events: the program's ``repro.*`` annotations, which
kineto records with correlation ids of their own, leave every field of
``trace.summarize``'s summary and its breakdown as they were; a device
operation is charged to the innermost span that held its launch call,
also where another thread made the call; the idle stretches split
across the spans the host was in, the window's idle time in all. On a
real CPU trace of a tiny round there is no device operation to read.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import pytest
from torch.autograd import DeviceType

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import spans as pspans  # noqa: E402
from portbench import trace  # noqa: E402
from test_portbench_cpu import tree  # noqa: E402,F401

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


class Ev:
    """The part of a ``_KinetoEvent`` that the reductions read."""

    def __init__(self, name, dtype, start, dur, corr=0, linked=0,
                 user=False, thread=1):
        self._v = (name, dtype, start, dur, corr, linked, user, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def start_thread_id(self):
        return self._v[7]


def _ops():
    """A window of 1000 ns over one round: a host op launching a kernel
    from the main thread, a launch from a second thread (the autograd
    engine's), a copy, and a kernel launched from no host op."""
    return [
        Ev(trace.WINDOW, CPU, 0, 1000, corr=1, user=True),
        # host ops (their ids link the device ops to them) and launches
        Ev("aten::mul", CPU, 100, 50, corr=10),
        Ev("cudaLaunchKernel", CPU, 110, 20, corr=501),
        Ev("aten::mm", CPU, 300, 40, corr=11, thread=2),
        Ev("cudaLaunchKernel", CPU, 310, 10, corr=502, thread=2),
        Ev("aten::copy_", CPU, 600, 100, corr=12),
        Ev("cudaMemcpyAsync", CPU, 610, 10, corr=503),
        Ev("cudaLaunchKernel", CPU, 800, 10, corr=504),
        # the device's work
        Ev("void mul_kernel<float>(Args)", CUDA, 200, 100, corr=501,
           linked=10),
        Ev("gemm", CUDA, 350, 150, corr=502, linked=11),
        Ev("Memcpy HtoD (Pageable -> Device)", CUDA, 650, 20, corr=503,
           linked=12),
        Ev("ota_channel_kernel", CUDA, 820, 80, corr=504),
    ]


def _spans():
    """The program's annotations over ``_ops``, host and device side:
    a round holding the clients (the mul; the second thread's launch
    falls in it by time) and the h2d copy; the last kernel's launch in
    the MAC; the read back from 905 to 990."""
    spans = [("round", 50, 850), ("clients", 90, 400), ("h2d", 590, 720),
             ("mac", 790, 850), ("readback", 905, 990)]
    out = []
    for i, (name, s, e) in enumerate(spans):
        out.append(Ev("repro." + name, CPU, s, e - s, corr=20 + i,
                      user=True))
        out.append(Ev("repro." + name, CUDA, s + 10, e - s, corr=20 + i,
                      user=True))
    return out


def _fields(t):
    return {k: v for k, v in vars(t).items() if k != "ctx"}, t.breakdown()


def test_annotations_leave_the_summary_as_it_was():
    plain = trace.summarize(_ops(), rounds=1)
    with_spans = trace.summarize(_ops() + _spans(), rounds=1)
    assert _fields(with_spans) == _fields(plain)
    # and the window's sums are what the events say
    assert plain.busy_s == pytest.approx((100 + 150 + 20 + 80) * 1e-9)
    assert plain.launch_calls == 3


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    table = pspans.reduce_spans(_ops() + _spans(), rounds=1, host_syncs=6)
    assert table.device_s == pytest.approx({
        "clients": 250e-9,       # the mul, and the second thread's gemm
        "h2d": 20e-9, "mac": 80e-9})
    assert table.n_ops == 4 and table.unmatched == 0
    m = table.metrics()
    assert m["clients_ms_per_round"] == pytest.approx(250e-6)
    assert m["mac_ms_per_round"] == pytest.approx(80e-6)
    assert m["draws_ms_per_round"] == 0.0
    assert m["host_syncs_per_round"] == 6.0


def test_idle_time_splits_by_the_span_the_host_was_in():
    events = _ops() + _spans()
    table = pspans.reduce_spans(events, rounds=1)
    # idle: [0, 200) none 0-50, round 50-90, clients 90-200; [300, 350)
    # clients; [500, 650) round 500-590, h2d 590-650; [670, 820) h2d
    # 670-720, round 720-790, mac 790-820; [900, 1000) none 900-905 and
    # 990-1000, readback 905-990
    assert table.idle_s == pytest.approx({
        "none": 65e-9, "round": 200e-9, "clients": 160e-9, "h2d": 110e-9,
        "mac": 30e-9, "readback": 85e-9})
    m = table.metrics()
    summary = trace.summarize(events, rounds=1)
    idle_ms = sum(m[k] for k in pspans.IDLE)
    assert idle_ms == pytest.approx(
        1e3 * (summary.window_s - summary.busy_s))
    assert m["idle_feed_ms_per_round"] == pytest.approx(110e-6)
    assert m["idle_between_ms_per_round"] == pytest.approx(150e-6)


def test_host_time_splits_the_window_by_the_innermost_span():
    table = pspans.reduce_spans(_ops() + _spans(), rounds=1)
    # none 0-50, 850-905, 990-1000; round 50-90, 400-590, 720-790;
    # clients 90-400; h2d 590-720; mac 790-850; readback 905-990
    assert table.host_s == pytest.approx({
        "none": 115e-9, "round": 300e-9, "clients": 310e-9, "h2d": 130e-9,
        "mac": 60e-9, "readback": 85e-9})
    assert sum(table.host_s.values()) == pytest.approx(table.window_s)


def test_a_launch_the_trace_lacks_is_charged_to_none():
    events = [e for e in _ops() + _spans()
              if e.correlation_id() != 504 or e.device_type() == CUDA]
    table = pspans.reduce_spans(events, rounds=1)
    assert table.unmatched == 1
    assert table.device_s["none"] == pytest.approx(80e-9)


def test_a_window_without_device_work_reads_nothing():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.spans import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            with span("round"):
                torch.ones(4).sum()
    table = pspans.reduce_spans(prof.profiler.kineto_results.events(), 1, 0)
    assert table.device_s == {} and table.n_ops == 0
    assert sum(table.idle_s.values()) == pytest.approx(table.window_s)
    assert table.idle_s["round"] > 0
    assert set(table.metrics().values()) == {None}


def test_the_report_runs_a_tiny_cell_on_the_cpu(tree, monkeypatch, capsys):  # noqa: F811
    import torch

    # what the report's import and main() set for their own process,
    # put back for the tests after this one
    for key in ("PYTORCH_CUDA_ALLOC_CONF", "TORCH_EXTENSIONS_DIR",
                "TRITON_CACHE_DIR", "OMP_NUM_THREADS"):
        monkeypatch.setenv(key, "")
    monkeypatch.setattr(sys, "path", list(sys.path))
    threads = torch.get_num_threads()
    report = importlib.import_module("span_report")
    monkeypatch.setattr(report, "ROOT", tree)
    saved = trace.traced_window
    try:
        assert report.main(["--workload", "tiny.f32", "--seed",
                            str(2**33 + 5), "--seconds", "0.3",
                            "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    assert trace.traced_window is saved
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["correct"] and rec["attempted"] >= 1
    assert set(rec["spans"]) == {*pspans.DEVICE, *pspans.IDLE,
                                 "host_syncs_per_round"}
    assert set(rec["spans"].values()) == {None}
    assert rec["round_ms"] > 0
    assert rec["sums"]["idle_ms"] == pytest.approx(
        rec["sums"]["window_idle_ms"])
    assert rec["sums"]["host_ms"] == pytest.approx(rec["sums"]["window_ms"])
    assert rec["idle_ms"]["feed"] > 0 and rec["idle_ms"]["clients"] > 0
