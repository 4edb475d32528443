"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py``
import neither jax nor anything of the JAX package ``repro``, in any
import order, and importing them builds and launches nothing."""

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
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
from repro_torch.kernels.adaptive_update import adaptive_update_slab
from repro_torch.kernels.ota_channel import ota_channel_slab
from repro_torch.kernels import build
assert adaptive_update_slab.launches == ota_channel_slab.launches == 0
assert build.load_library.cache_info().currsize == 0
print("ok", len(sys.modules))
"""


def test_module_list_covers_the_package():
    assert "repro_torch.core.fl" in MODULES
    assert "repro_torch.kernels.build" in MODULES
    assert len(MODULES) >= 20


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
