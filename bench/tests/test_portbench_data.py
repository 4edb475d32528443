"""The benchmark's data: every name in BENCHMARK.json resolves to its
files, names and units keep to their characters, the configurations
agree with their published keys, and the FLOP and byte counts give the
numbers the cells were sized by."""

from __future__ import annotations

import json
import math
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from portbench import harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
H100_BW = 3.35e12
D_SC2 = 987_833_344


class _Ctx:
    def __init__(self, traffic, padded):
        self.traffic = traffic
        self.padded = padded


def _traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_just_their_keys(section, keys):
    for e in SPEC[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                assert "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_names_are_unique_and_cells_reference_known_names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names)), section
    configs = {c["name"] for c in SPEC["configs"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1


def test_metric_sources_bounds_and_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in CELLS
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_every_file_by_name(cell):
    c = harness.Cell(ROOT, cell)
    assert c.traffic["clients"] >= 1 and c.limits["compared"]
    assert c.ref().layout(c.model)
    assert c.counts(c.model["family"]).flops_per_round(c.model, c.traffic)
    e2e = [m["name"] for m in c.metrics("end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = c.metrics("per_layer")
    assert layers
    for m in layers:
        assert callable(c.reader(m["name"]).read)
    assert set(c.traffic["launches"]) <= set(harness.COUNTERS)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_file_agrees_with_its_published_keys(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    m = cfg["model"]
    assert cfg["source"] == entry["source"]
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert m["n_layers"] == cfg["num_hidden_layers"]
    assert m["d_model"] == cfg["hidden_size"]
    assert m["n_heads"] == cfg["num_attention_heads"]
    assert m["n_kv_heads"] == cfg["num_key_value_heads"]
    assert m["d_ff"] == cfg["intermediate_size"]
    assert m["vocab"] == cfg["vocab_size"]
    for k in ("q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim"):
        if k in cfg:
            assert m[k] == cfg[k]
    for k in cfg["reduced"]:
        assert cfg["published"][k] != cfg[k]
    c = harness.Cell(ROOT, next(w["name"] for w in SPEC["workloads"]
                                if w["config"] == entry["name"]))
    assert sum(lf.size for lf in c.leaves()) == cfg["n_params"]


def test_the_port_builds_the_layout_the_reference_draws():
    """The program's parameter tree (shapes and types, from FakeTensor
    init) is the reference layout, leaf for leaf in slab order."""
    from repro_torch.core.slab import make_slab_spec
    from repro_torch.models.model import ModelConfig, build_model
    from torch._subclasses.fake_tensor import FakeTensorMode

    for entry in SPEC["configs"]:
        cell = harness.Cell(ROOT, next(w["name"] for w in SPEC["workloads"]
                                       if w["config"] == entry["name"]))
        with FakeTensorMode():
            params = build_model(ModelConfig(**cell.model)).init(
                seed=0, device="cpu")
            spec = make_slab_spec(params)
        leaves = cell.leaves()
        assert [tuple(s) for s in spec.shapes] == [lf.shape for lf in leaves]
        assert list(spec.dtypes) == [lf.dtype for lf in leaves]


def test_flops_per_round_match_the_sizing():
    sc2 = harness.Cell(ROOT, "sc2-d1.f32")
    dense = sc2.counts("dense")
    assert dense.matmul_params(sc2.model) == 685_768_704
    assert dense.flops_per_round(sc2.model, sc2.traffic) == pytest.approx(
        4.21e12, rel=2e-3)
    mc = harness.Cell(ROOT, "mcpm3-d8.s512.f32")
    mla = mc.counts("mla")
    assert mla.matmul_params(mc.model) == pytest.approx(689.4e6, rel=1e-4)
    at_2x512 = dict(mc.traffic, batch=2)
    assert mla.flops_per_round(mc.model, at_2x512) == pytest.approx(
        17.27e12, rel=2e-3)
    assert mla.flops_per_round(mc.model, mc.traffic) == pytest.approx(
        2 * 17.27e12, rel=2e-3)


@pytest.mark.parametrize("kernel,traffic,ms", [
    ("b1", "c4x2x128.f32", 8.2565), ("b2", "c4x2x128.f32", 8.2565),
    ("b3c", "c4x2x128.int8ef", 8.5606), ("b4", "c4x2x128.int8ef", 3.8426)])
def test_byte_bounds_at_the_width_slab(kernel, traffic, ms):
    cell = harness.Cell(ROOT, "sc2-d1.f32")
    ctx = _Ctx(_traffic(traffic), D_SC2)
    got = 1e3 * cell.counts(kernel).bytes_per_launch(ctx) / H100_BW
    assert got == pytest.approx(ms, abs=1e-4)


@pytest.mark.parametrize("kernel,traffic", [
    ("b1", "c4x2x128.f32"), ("b2", "c4x2x128.f32"),
    ("b2", "c32k2x2x128.f32"), ("b3b", "c32k2x2x128.f32"),
    ("b3c", "c4x2x128.int8ef"), ("b4", "c4x2x128.int8ef")])
def test_bytes_are_each_operand_once(kernel, traffic):
    """A launch's count is the bytes of its operands and results at the
    call's shapes, each once: no kernel that moves them can beat it, so
    a share over 100 % means a wrong count or a clipped time."""
    import torch

    d = 1024
    tr = _traffic(traffic)
    rows = {"b1": 0, "b2": 1 if tr.get("client_chunk") else tr["clients"],
            "b3b": tr.get("client_chunk") or 0, "b3c": tr["clients"],
            "b4": 0}[kernel]
    f32 = torch.zeros(d).element_size()
    slab = d * f32
    ops = {
        "b1": 4 * slab + 3 * slab,                  # g, delta, nu, w in; 3 out
        "b2": rows * slab + rows * f32 + 2 * slab + slab,
        "b3b": rows * slab + rows * f32 + slab + slab,
        "b3c": (rows * slab + rows * f32 + slab + 2 * slab
                + d + (d // 128) * f32),            # + r, ef; payload, scales
        "b4": d + (d // 128) * f32 + 2 * slab + slab,
    }[kernel]
    cell = harness.Cell(ROOT, "sc2-d1.f32")
    assert cell.counts(kernel).bytes_per_launch(_Ctx(tr, d)) == ops


def test_pair_tail_and_roofline_readers():
    from portbench.trace import TraceSummary

    spans = [0.25] * 40
    for i in (3, 13, 23, 33):          # a stall in four of the 20 pairs
        spans[i] = 0.75
    stamps = [sum(spans[:i]) for i in range(41)]
    assert harness._p90_of_pairs(stamps) == pytest.approx(500.0)
    cell = harness.Cell(ROOT, "sc2-d1.f32")
    cell.kind, cell.padded = "NVIDIA H100 80GB HBM3", D_SC2
    t = TraceSummary(10, 1.5, 1.2, {"ota_channel_kernel": 0.1407,
                                    "adaptive_update_kernel": 0.0965,
                                    "at::native::mm": 0.5},
                     {"ota_channel_kernel": 10, "adaptive_update_kernel": 10,
                      "at::native::mm": 20}, 5760, {}, cell)
    b2 = cell.reader("b2_roofline").read(t)
    assert b2 == pytest.approx(100 * 10 * 8.2565e-3 / 0.1407, rel=1e-4)
    assert cell.reader("b3b_roofline").read(t) is None
    assert cell.reader("host_launch_calls_per_round").read(t) == 576
    assert cell.reader("device_idle_pct").read(t) == pytest.approx(20.0)
    assert cell.reader("torch_kernels_ms_per_round").read(t) == \
        pytest.approx(50.0)
    assert 0 < cell.reader("mfu_pct").read(t) < 100
    cell.kind = "some other card"
    assert cell.reader("mfu_pct").read(t) is None
    assert not math.isnan(b2)


def test_the_corpus_copy_gives_the_training_clis_batches():
    """The frozen copy of the CLI's corpus law (its bigram pass written
    over runs) gives the CLI's token windows, round for round."""
    import numpy as np
    from repro_torch.launch import train

    from portbench import corpus

    traffic = dict(_traffic("c4x2x128.f32"), seq=16, corpus_tokens=5000)
    vocab, seed = 97, 12345
    ours = corpus.make_batch_fn(traffic, vocab, seed)
    saved = train.CORPUS_TOKENS
    try:
        train.CORPUS_TOKENS = 5000
        cli = train.make_batch_fn(
            *train.client_corpus(vocab, 16, 4, 2, 0.5, seed), batch=2,
            seq=16, seed=seed)
    finally:
        train.CORPUS_TOKENS = saved
    for t in (0, 1, 7):
        got = ours(t)["tokens"]
        np.testing.assert_array_equal(got, cli(t)["tokens"].numpy())
        rows = got.reshape(-1, got.shape[-1])
        assert len({r.tobytes() for r in rows}) == len(rows)
