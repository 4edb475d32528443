"""The mla_moe family (DeepSeek-V2-Lite's layers, one expert share)
through the harness on the CPU at a tiny size, as
``test_portbench_cpu.py`` runs the dense family: a cell made of files
runs and its check passes; a round that returns its state unchanged,
half of each client's rows left out and the control (the reference one
precision down) in the program's place come out not correct. And the
FLOP count of the cell ``dsv2l-d9.ep8.s512.f32`` gives the numbers it
was sized by."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from portbench import harness  # noqa: E402

TINY_MODEL = {"arch": "tiny", "family": "mla_moe", "n_layers": 3,
              "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 128,
              "vocab": 257, "q_lora_rank": None, "kv_lora_rank": 32,
              "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
              "v_head_dim": 16, "norm": "rmsnorm", "mlp": "swiglu",
              "rope_theta": 10000.0, "remat": True,
              "param_dtype": "bfloat16", "n_experts": 8, "top_k": 2,
              "n_shared_experts": 2, "capacity_factor": 1.25,
              "expert_d_ff": 32, "n_dense_layers": 1, "experts_held": 4,
              "first_expert": 0, "normalize_topk": False,
              "aux_loss_weight": 0.001, "seq_aux": True,
              "yarn_factor": 40.0, "yarn_original_len": 64,
              "yarn_beta_fast": 32.0, "yarn_beta_slow": 1.0,
              "yarn_mscale": 0.707, "yarn_mscale_all_dim": 0.707}
TINY_LIMITS = {"loss_gap": 0.003, "grad_gap": 0.01, "first_grad_gap": 0.0015,
               "change_gap": 0.008}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A checkout holding the benchmark plus one mla_moe cell of files."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-mla-moe", "source": "a test",
                            "file": "bench/configs/tiny-mla-moe.json",
                            "reduced": [], "why": "a cell from files"})
    spec["workloads"].append({"name": "tiny.moe", "config": "tiny-mla-moe",
                              "traffic": "tiny", "chips": 1,
                              "why": "a cell from files"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "bench/configs/tiny-mla-moe.json").write_text(
        json.dumps({"name": "tiny-mla-moe", "model": TINY_MODEL}))
    traffic = json.loads((BENCH / "traffic/c4x4x512.f32.json").read_text())
    traffic.update(clients=2, batch=2, seq=32, corpus_tokens=20000)
    (root / "bench/traffic/tiny.json").write_text(json.dumps(traffic))
    (root / "bench/limits/tiny.moe.json").write_text(
        json.dumps({"compared": TINY_LIMITS, "shown": []}))
    return root


def _run(root, **kw):
    return harness.run(root, "tiny.moe", 2**33 + 7, 0.3, False,
                       time.perf_counter(), device_name="cpu",
                       log=lambda s: None, **kw)


def test_an_mla_moe_cell_from_files_runs_and_is_correct(tree):
    out = _run(tree)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


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


def test_flops_per_round_match_the_sizing():
    cell = harness.Cell(ROOT, "dsv2l-d9.ep8.s512.f32")
    counts = cell.counts("mla_moe")
    assert counts.matmul_params(cell.model) == 408_682_496
    assert counts.flops_per_round(cell.model, cell.traffic) == \
        pytest.approx(2.0669e13, rel=1e-4)
    assert sum(lf.size for lf in cell.leaves()) == 936_684_032
