"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py`` and the
example twins import neither jax nor anything of the JAX package
``repro`` or of its ``benchmarks``, in any import order, and importing
them builds and launches nothing. The port's contract checks
(``python -m repro_torch.analysis``) cover every module of the package
and find nothing."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (SRC / "repro_torch").rglob("*.py"))

CHECK = """
import importlib, sys
sys.path[:0] = [{src!r}, {root!r}]
for name in {names!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
assert not bad, bad
from repro_torch.kernels.adaptive_update import adaptive_update_slab
from repro_torch.kernels.ota_channel import ota_channel_slab
from repro_torch.kernels import build
from repro_torch.kernels.ota_channel import (ota_receive_slab,
                                             ota_transmit_slab)
assert adaptive_update_slab.launches == ota_channel_slab.launches == 0
assert ota_transmit_slab.launches == ota_receive_slab.launches == 0
assert ota_transmit_slab.stream_launches == 0
assert ota_transmit_slab.nocarry_launches == 0
assert ota_receive_slab.stats_launches == 0
from repro_torch.kernels.flash_attention import flash_attention
assert flash_attention.launches == 0
assert flash_attention.hopper_launches == flash_attention.scalar_launches == 0
assert not flash_attention.shape_launches
assert build.load_library.cache_info().currsize == 0
print("ok", len(sys.modules))
"""


def test_module_list_covers_the_package():
    assert "repro_torch.core.fl" in MODULES
    assert "repro_torch.core.stream" in MODULES
    assert "repro_torch.kernels.build" in MODULES
    for name in ("kernels.flash_attention", "kernels.ops", "configs",
                 "configs.qwen3_14b", "configs.starcoder2_15b",
                 "models.layers", "models.attention", "models.transformer",
                 "models.model", "launch.serve", "launch.train",
                 "core.shard", "launch.mesh", "launch.shard_check",
                 "models.moe", "models.mla", "optim", "models.rwkv",
                 "models.ssm", "experiments", "experiments.paper_figs"):
        assert f"repro_torch.{name}" in MODULES
    assert len(MODULES) >= 40


@pytest.mark.parametrize("order", ["forward", "reverse", "kernels_first"])
def test_port_and_chip_smoke_import_no_jax(order):
    names = MODULES + ["chip_smoke"]
    if order == "reverse":
        names = names[::-1]
    elif order == "kernels_first":
        names = ["repro_torch.kernels.ota_channel"] + names
    code = CHECK.format(src=str(SRC), root=str(ROOT), names=names)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


EXAMPLE_CHECK = """
import importlib.util, sys
sys.path[:0] = [{src!r}]
for path in {paths!r}:
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
assert not bad, bad
print("ok")
"""


def test_example_twins_import_no_jax():
    paths = sorted(str(p) for p in (ROOT / "examples").glob("*_torch.py"))
    assert any(p.endswith("train_lm_federated_torch.py") for p in paths)
    assert any(p.endswith("alpha_mismatch_torch.py") for p in paths)
    assert any(p.endswith("serve_decode_torch.py") for p in paths)
    assert any(p.endswith("paper_experiment_torch.py") for p in paths)
    code = EXAMPLE_CHECK.format(src=str(SRC), paths=paths)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_analysis_covers_the_package_and_finds_nothing():
    """``python -m repro_torch.analysis`` reads every module of the
    package, the experiments among them, and reports 0 findings."""
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert SRC / "repro_torch" / "experiments" / "paper_figs.py" in files
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(ROOT), env={**os.environ,
                                           "PYTHONPATH": str(SRC)})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new finding(s), 0 baselined (0 total)" in r.stderr
