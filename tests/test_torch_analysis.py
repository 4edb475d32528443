"""The port's contract checks (``repro_torch.analysis``): each rule fires
on its should-flag fixture and stays silent on the should-pass twin, the
live port tree is clean against its committed (empty) baseline, and the
dispatch tier's ledgers pass on the tiny round and fire on fixtures
that draw or narrow inside it.

The AST tests feed in-memory sources through
``analyze_sources({relpath: source})`` with repo-relative paths chosen
to land in each rule's scope, as ``tests/test_analysis.py`` does for the
JAX package's rules. The dispatch tier's draw ledger is held for both
draws providers: the port's ``TorchDraws`` and the reference provider
that draws with the JAX package's own functions (``tests/_torch_ref.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_ref import ref_draws
from repro.core.slab import make_slab_spec as j_make_slab_spec
from repro_torch.analysis import (DEFAULT_BASELINE, Finding, load_baseline,
                                  new_findings, write_baseline)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import dispatch_checks as dc
from repro_torch.analysis.ast_rules import analyze_repo, analyze_sources

ROOT = Path(__file__).resolve().parents[1]

# Fixture paths chosen to land in each rule's scope.
OTA = "src/repro_torch/core/ota.py"
FL = "src/repro_torch/core/fl.py"
ROUND = "src/repro_torch/core/round.py"
KERNEL = "src/repro_torch/kernels/ota_channel.py"
REF = "src/repro_torch/kernels/ref.py"
BUILD = "src/repro_torch/kernels/build.py"
DRAWS = "src/repro_torch/core/draws.py"
OTHER = "src/repro_torch/launch/train.py"


def rules_of(findings, rule):
    return [f for f in findings if f.rule == rule]


def analyze_one(path, source):
    return analyze_sources({path: source})


# ---------------------------------------------------------------------------
# kernel-mirror


KERNEL_SRC = ("from repro_torch.kernels import build\n"
              "def foo_slab(x, y, *, alpha, sr_seed=None, bq=64):\n"
              "    return build.load_library().foo(x, y)\n"
              "def bar(x):\n"
              "    return _launch(x)\n"
              "def _launch(x):\n"
              "    return _inner(x)\n"
              "def _inner(x):\n"
              "    return build.load_library().bar(x)\n"
              "def blocks(d):\n"
              "    return d // 128\n")
REF_OK = ("def foo_ref(x, y, *, alpha):\n    pass\n"
          "def bar_ref(x):\n    pass\n")


def test_kernel_mirror_passes_modulo_launch_params():
    assert not rules_of(analyze_sources({KERNEL: KERNEL_SRC, REF: REF_OK}),
                        "kernel-mirror")


def test_kernel_mirror_fires_on_a_missing_plain_version():
    """``bar`` reaches the loader through two private helpers; ``blocks``
    does not reach it and needs no plain version."""
    ref = "def foo_ref(x, y, *, alpha):\n    pass\n"
    hits = rules_of(analyze_sources({KERNEL: KERNEL_SRC, REF: ref}),
                    "kernel-mirror")
    assert len(hits) == 1 and hits[0].line == 4
    assert "bar_ref" in hits[0].message and hits[0].severity == "error"


def test_kernel_mirror_fires_without_ref_py():
    hits = rules_of(analyze_one(KERNEL, KERNEL_SRC), "kernel-mirror")
    assert sorted(f.line for f in hits) == [2, 4]


def test_kernel_mirror_fires_on_a_signature_mismatch():
    ref = REF_OK.replace("*, alpha)", "*, beta)")
    hits = rules_of(analyze_sources({KERNEL: KERNEL_SRC, REF: ref}),
                    "kernel-mirror")
    assert len(hits) == 1
    assert "missing ['alpha']" in hits[0].message
    assert "extra ['beta']" in hits[0].message


def test_kernel_mirror_fires_on_swapped_operands():
    ref = REF_OK.replace("foo_ref(x, y,", "foo_ref(y, x,")
    hits = rules_of(analyze_sources({KERNEL: KERNEL_SRC, REF: ref}),
                    "kernel-mirror")
    assert len(hits) == 1 and "positional" in hits[0].message


def test_kernel_mirror_scope_and_waiver():
    """The loader module and the plain versions are no wrappers; a
    wrapper can be waived in place."""
    loader = "def check(code):\n    return load_library().err(code)\n"
    assert not rules_of(analyze_sources({BUILD: loader, REF: REF_OK}),
                        "kernel-mirror")
    waived = KERNEL_SRC.replace(
        "def bar(x):", "def bar(x):  # repro-lint: allow[kernel-mirror]")
    ref = "def foo_ref(x, y, *, alpha):\n    pass\n"
    assert not rules_of(analyze_sources({KERNEL: waived, REF: ref}),
                        "kernel-mirror")


# ---------------------------------------------------------------------------
# zero-tail-restore


STRIPPED = ("def aggregate(payload, scales, u, e, up):\n"
            "    y = ota_receive_slab(payload, scales, u, e,\n"
            "                         alpha=1.5, scale=0.1,\n"
            "                         packed='fold' if up.zero_fold else None)\n"
            "    return y\n")


def test_zero_tail_fires_on_a_stripped_restore():
    hits = rules_of(analyze_one(OTA, STRIPPED), "zero-tail-restore")
    assert len(hits) == 1
    assert hits[0].line == 2 and hits[0].severity == "error"
    assert "restore_zero_tail" in hits[0].message


def test_zero_tail_passes_when_restored_or_not_reachable():
    restored = STRIPPED.replace(
        "    return y\n",
        "    if up.zero_fold:\n        y = restore_zero_tail(y, spec)\n"
        "    return y\n")
    assert not rules_of(analyze_one(OTA, restored), "zero-tail-restore")
    plain = ("def aggregate(payload, scales, u, e):\n"
             "    return ota_receive_slab(payload, scales, u, e,\n"
             "                            alpha=1.5, scale=0.1)\n")
    assert not rules_of(analyze_one(OTA, plain), "zero-tail-restore")
    # out of scope: the kernels define the receive, core modules call it
    assert not rules_of(analyze_one(KERNEL, STRIPPED), "zero-tail-restore")


# ---------------------------------------------------------------------------
# draw-in-round


DRAW_SRC = ("import torch\n"
            "GEN = torch.Generator()\n"
            "def round_body(x, seed):\n"
            "    gen = torch.Generator(device=x.device)\n"
            "    gen.manual_seed(seed)\n"
            "    u = torch.rand(x.shape, generator=gen)\n"
            "    x.uniform_()\n"
            "    return x + u + torch.zeros_like(x)\n")


def test_draw_in_round_fires_inside_round_bodies():
    for path in (OTA, FL, ROUND, KERNEL):
        hits = rules_of(analyze_one(path, DRAW_SRC), "draw-in-round")
        assert [f.line for f in hits] == [4, 5, 6, 7], path
        assert all(f.severity == "error" for f in hits)
        assert "RoundDraws" in hits[0].message


def test_draw_in_round_is_scoped_and_waivable():
    """The provider (core/draws.py) and modules outside the round draw
    freely; module-level code is not a round body; a waiver holds."""
    for path in (DRAWS, OTHER):
        assert not rules_of(analyze_one(path, DRAW_SRC), "draw-in-round")
    waived = DRAW_SRC.replace(
        "generator=gen)\n",
        "generator=gen)  # repro-lint: allow[draw-in-round]\n")
    hits = rules_of(analyze_one(OTA, waived), "draw-in-round")
    assert [f.line for f in hits] == [4, 5, 7]


# ---------------------------------------------------------------------------
# local-import, syntax errors


def test_local_import_fires_without_a_waiver():
    src = "def f():\n    import math\n    return math.pi\n"
    hits = rules_of(analyze_one(OTHER, src), "local-import")
    assert len(hits) == 1 and hits[0].line == 2


def test_local_import_honours_waivers_and_guards():
    src = ("from typing import TYPE_CHECKING\n"
           "if TYPE_CHECKING:\n"
           "    from foo import Bar\n"
           "try:\n"
           "    import triton\n"
           "except ImportError:\n"
           "    triton = None\n"
           "def f():\n"
           "    # repro-lint: lazy-import (cycle: test fixture)\n"
           "    from repro_torch.core import fl\n"
           "    return fl\n")
    assert not rules_of(analyze_one(OTHER, src), "local-import")


def test_a_syntax_error_is_a_finding_not_a_crash():
    hits = rules_of(analyze_one(OTHER, "def f(:\n"), "syntax-error")
    assert len(hits) == 1 and hits[0].severity == "error"


# ---------------------------------------------------------------------------
# findings and the baseline


def test_finding_render_format():
    f = Finding(OTA, 12, "draw-in-round", "error", "boom",
                snippet="u = torch.rand(3)")
    assert f.render() == ("src/repro_torch/core/ota.py:12 draw-in-round "
                          "[error] boom")
    with pytest.raises(ValueError, match="severity"):
        Finding(OTA, 1, "x", "fatal", "m")


def test_baseline_absorbs_by_snippet_not_line(tmp_path):
    snip = "u = torch.rand(3)"
    path = str(tmp_path / "base.json")
    write_baseline(path, [Finding(OTA, 10, "draw-in-round", "error", "m",
                                  snippet=snip)])
    drifted = [Finding(OTA, 99, "draw-in-round", "error", "m", snippet=snip)]
    assert new_findings(drifted, load_baseline(path)) == []
    two = drifted + [Finding(OTA, 120, "draw-in-round", "error", "m",
                             snippet=snip)]
    assert len(new_findings(two, load_baseline(path))) == 1


def test_baseline_version_mismatch_rejected(tmp_path):
    path = tmp_path / "base.json"
    path.write_text(json.dumps({"version": 99, "findings": {}}))
    with pytest.raises(ValueError, match="version"):
        load_baseline(str(path))


# ---------------------------------------------------------------------------
# the live tree and the CLI


def test_live_port_tree_is_clean():
    """No finding at all: the committed baseline accepts none."""
    findings = analyze_repo(ROOT)
    assert findings == [], "\n".join(f.render() for f in findings)
    assert load_baseline(str(ROOT / DEFAULT_BASELINE)) == {}


def test_cli_exit_codes(tmp_path, capsys):
    """``python -m repro_torch.analysis``: 0 on the live tree; on a tree
    with a finding 1, then 0 once ``--write-baseline`` accepts it; 2 on
    a baseline of another version."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--root", str(ROOT)], capture_output=True, text=True,
                       cwd=ROOT, env={**os.environ,
                                      "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stdout + r.stderr
    bad = tmp_path / "src" / "repro_torch" / "core"
    bad.mkdir(parents=True)
    (bad / "ota.py").write_text(DRAW_SRC)
    root = ["--root", str(tmp_path)]
    assert cli.main(root) == 1
    assert "draw-in-round" in capsys.readouterr().out
    assert cli.main(root + ["--write-baseline"]) == 0
    assert cli.main(root) == 0
    assert cli.main(root + ["--no-baseline"]) == 1
    (tmp_path / DEFAULT_BASELINE).write_text(
        json.dumps({"version": 99, "findings": {}}))
    assert cli.main(root) == 2
    capsys.readouterr()
    assert cli.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rule in ("kernel-mirror", "draw-in-round", "round-draws",
                 "draw-ledger", "wire-downcast"):
        assert rule in listed


# ---------------------------------------------------------------------------
# the dispatch tier


def _reference_provider():
    """The reference draws (the JAX package's functions and key splits),
    keyed per round as the parity tests key them."""
    jspec = j_make_slab_spec({k: jnp.asarray(v.numpy()) for k, v in
                              dc.tiny_params().items()})

    def provider(ch, spec, n, rate, t):
        assert spec.padded == jspec.padded
        key = jax.random.fold_in(jax.random.key(7), t)
        return ref_draws(key, ch, jspec, n, rate)

    return provider


def test_op_ledger_counts_draws_and_narrowing():
    x = torch.ones(4)
    ledger, _ = dc.op_ledger(lambda: (torch.rand(3), x.to(torch.bfloat16),
                                      x.to(torch.float64),
                                      torch.empty(2).normal_()))
    assert ledger.random == {"rand": 1, "normal_": 1}
    assert ledger.downcasts == {"bfloat16": 1}
    ledger, _ = dc.op_ledger(lambda: torch.zeros(2, dtype=torch.int8).copy_(x[:2]))
    assert ledger.downcasts == {"int8": 1}


def test_dispatch_checks_pass_on_the_tiny_round():
    """Every wire's round dispatches no random op, the all-f32 wires
    narrow nothing, and both providers give the round's draws on every
    wire (so the same number of draws a round)."""
    assert dc.check_round_draws() == []
    assert dc.check_wire_downcast() == []
    assert dc.check_draw_ledgers({dc.PORT_PROVIDER: dc.torch_draws,
                                  "reference": _reference_provider()}) == []
    assert dc.run_dispatch_checks() == []


def test_round_draws_fires_on_a_round_that_draws():
    cell = dc.tiny_cell("f32")
    real = cell.step

    def drawing(state, draws, batches):
        torch.rand(3)
        return real(state, draws, batches)

    cell.step = drawing
    hits = dc.check_round_draws({"f32": cell})
    assert [f.rule for f in hits] == ["round-draws"]
    assert "rand x1" in hits[0].message and hits[0].snippet == "f32"
    assert hits[0].render().startswith("src/repro_torch/core/fl.py:1 ")


def test_wire_downcast_fires_on_a_narrowing_round():
    cell = dc.tiny_cell("f32")
    real = cell.step

    def narrowing(state, draws, batches):
        state, metrics = real(state, draws, batches)
        state.w.to(torch.bfloat16)
        return state, metrics

    cell.step = narrowing
    hits = dc.check_wire_downcast({"f32": cell})
    assert [f.rule for f in hits] == ["wire-downcast"]
    assert "bfloat16 x1" in hits[0].message


def test_draw_ledger_fires_on_a_provider_that_forks():
    """A provider that drops the int8 wire's rounding uniforms, one whose
    mask has the slab's shape, and a port provider that draws h twice."""
    def no_r_up(ch, spec, n, rate, t):
        d = dc.torch_draws(ch, spec, n, rate, t)
        return dc.RoundDraws(d.h, d.u, d.e, None, d.r_dl, mask=d.mask)

    def wide_mask(ch, spec, n, rate, t):
        d = dc.torch_draws(ch, spec, n, rate, t)
        mask = None if d.mask is None else torch.ones(spec.padded)
        return dc.RoundDraws(d.h, d.u, d.e, d.r_up, d.r_dl, mask=mask)

    def twice(ch, spec, n, rate, t):
        torch.rand(n)
        return dc.torch_draws(ch, spec, n, rate, t)

    hits = dc.check_draw_ledgers({"no-r_up": no_r_up}, wires=("int8-ef",))
    assert len(hits) == 1 and "r_up" in hits[0].message
    hits = dc.check_draw_ledgers({"wide": wide_mask}, wires=("f32-sampled",))
    assert len(hits) == 1 and "mask" in hits[0].message
    hits = dc.check_draw_ledgers({dc.PORT_PROVIDER: twice}, wires=("f32",))
    assert len(hits) == 1 and "3 drawn fields with 4 random ops" in \
        hits[0].message


def test_a_crashing_check_is_a_finding(monkeypatch):
    def boom():
        raise RuntimeError("api drift")

    monkeypatch.setattr(dc, "check_wire_downcast", boom)
    monkeypatch.setattr(dc, "check_round_draws", lambda: [])
    monkeypatch.setattr(dc, "check_draw_ledgers", lambda: [])
    hits = dc.run_dispatch_checks()
    assert [f.rule for f in hits] == ["dispatch-internal-error"]
    assert "api drift" in hits[0].message
