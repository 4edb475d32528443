"""The harness end to end on the CPU, at a tiny size, through the same
code a card run takes: a cell added from files alone (a configuration,
a traffic mix, limits and ``BENCHMARK.json`` entries) runs and its check
passes; with the timed path broken underneath (a round that returns its
state unchanged; half of each client's rows left out) or the control
(the reference one precision down) in the program's place, ``correct``
comes out false. And ``bench/run.py`` refuses to run without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from portbench import harness  # noqa: E402

TINY_MODEL = {"arch": "tiny", "family": "dense", "n_layers": 2,
              "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
              "vocab": 257, "norm": "layernorm", "mlp": "gelu",
              "qkv_bias": True, "rope_theta": 10000.0, "window": 16,
              "remat": True, "param_dtype": "bfloat16"}
# set from CPU readings of this tiny cell: the program 1e-4 to 2e-3,
# the control and the faults 3e-3 to 1
TINY_LIMITS = {"loss_gap": 0.003, "grad_gap": 0.01, "first_grad_gap": 0.0015,
               "change_gap": 0.008}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A checkout holding the benchmark plus one cell made of new files."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-dense", "source": "a test",
                            "file": "bench/configs/tiny-dense.json",
                            "reduced": [], "why": "a cell from files"})
    spec["workloads"].append({"name": "tiny.f32", "config": "tiny-dense",
                              "traffic": "tiny", "chips": 1,
                              "why": "a cell from files"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "bench/configs/tiny-dense.json").write_text(
        json.dumps({"name": "tiny-dense", "model": TINY_MODEL}))
    traffic = json.loads((BENCH / "traffic/c4x2x128.f32.json").read_text())
    traffic.update(clients=2, batch=2, seq=32, corpus_tokens=20000)
    (root / "bench/traffic/tiny.json").write_text(json.dumps(traffic))
    (root / "bench/limits/tiny.f32.json").write_text(
        json.dumps({"compared": TINY_LIMITS, "shown": []}))
    return root


def _run(root, **kw):
    return harness.run(root, "tiny.f32", 2**33 + 7, 0.3, False,
                       time.perf_counter(), device_name="cpu",
                       log=lambda s: None, **kw)


def test_a_cell_from_files_runs_and_is_correct(tree):
    out = _run(tree)
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"round_ms", "peak_mem_gb", "setup_s"}


def test_the_traced_run_reads_its_window(tree):
    """``--trace 1`` on the CPU: the profiler's window is found and the
    per-layer metrics replace the end-to-end ones; with no device
    operation there is nothing for the device readers to read."""
    out = harness.run(tree, "tiny.f32", 5, 0.3, True, time.perf_counter(),
                      device_name="cpu", log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert set(out["metrics"]) == {"device_idle_pct"}
    assert out["metrics"]["device_idle_pct"]["value"] == pytest.approx(100)
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_round_that_returns_its_state_unchanged_is_caught(tree,
                                                             monkeypatch):
    from repro_torch.core import fl

    monkeypatch.setattr(fl, "slab_update_slabs",
                        lambda cfg, g, state, w, alpha=None: (state, w))
    out = _run(tree)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_rows_left_out_is_caught(tree):
    def half(loss_fn):
        def loss(params, batch, weights=None):
            toks = batch["tokens"]
            return loss_fn(params, {**batch,
                                    "tokens": toks[:toks.shape[0] // 2]})
        return loss

    out = _run(tree, wrap_loss=half)
    assert not out["correct"]
    assert out["checks"]["grad_gap"]["value"] > TINY_LIMITS["grad_gap"]


def test_the_control_in_the_programs_place_is_caught(tree, monkeypatch):
    def control(self):
        return harness.reference(self.cell, self.seeds, self.device,
                                 "control")

    monkeypatch.setattr(harness.Program, "first_rounds", control)
    out = _run(tree)
    assert not out["correct"]


def test_run_refuses_without_a_card():
    """No result line and a non-zero exit where no card is present (the
    check is inside the test: on a card this is the wrong test)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "sc2-d1.f32", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env=env, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card_launches_what_its_wire_says(tree):
    """On the card: the tiny cell through the port's kernels, one B2 and
    one B1 a round and no B5."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run(tree, "tiny.f32", 11, 1.0, False, time.perf_counter(),
                      device_name="cuda", log=lambda s: None)
    assert out["launches_a_round"] == {"B1": 1.0, "B2": 1.0, "B3b": 0.0,
                                       "B3c": 0.0, "B4": 0.0, "B5": 0.0}
