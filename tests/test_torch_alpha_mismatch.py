"""The twin of ``examples/alpha_mismatch.py`` (paper Remark 3) on the CPU:
``examples/alpha_mismatch_torch.py`` prints the JAX script's lines (the
numbers differ: the port draws from its own Philox generator); on the
JAX script's own draws (its ``run_rounds_slab`` key chain through
``ref_draws``) each of its three trainings ends where the JAX script's
does (final loss, accuracy and alpha_hat at 1e-5) and the two print the
same lines, verdict included, to their printed digits; and at the
script's 80 rounds its tracked ``alpha_hat`` comes within 0.1 of the
true 1.2 (the port's tier, ``PERF.md`` §2) and its verdict line says OK.
"""

import importlib.util
import pathlib
import re
import sys

import jax
import numpy as np
import pytest

from _torch_ref import ref_draws, round_key_chain
from repro.core.slab import make_slab_spec as j_make_slab_spec

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_ex_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _template(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "#", line)


def _number(token: str):
    try:
        return float(token.rstrip(")|,"))
    except ValueError:
        return None


def _on_jax_draws(mod, monkeypatch, rounds):
    """Replace the twin's ``TorchDraws`` with the draws the JAX script's
    ``run_rounds_slab(..., jax.random.key(1), ...)`` makes each round."""
    keys = round_key_chain(jax.random.key(1), rounds)
    jspec = j_make_slab_spec({"w": np.zeros((32, 10), np.float32),
                              "b": np.zeros((10,), np.float32)})

    def draws(channel, spec, n, seed, device):
        assert spec.padded == jspec.padded and seed == 1
        return lambda t: ref_draws(keys[t], channel, jspec, n)

    monkeypatch.setattr(mod, "TorchDraws", draws)


ROUNDS = 10           # a chunk of 8 and a chunk of 2


@pytest.mark.parametrize("alpha_opt", [1.2, 2.0, "auto"])
def test_training_on_the_jax_draws_ends_where_the_jax_scripts_does(
        alpha_opt, monkeypatch):
    twin = _load("alpha_mismatch_torch")
    _on_jax_draws(twin, monkeypatch, ROUNDS)
    got = twin.train(alpha_opt, ROUNDS, "cpu")
    want = _load("alpha_mismatch").train(alpha_opt, ROUNDS)
    np.testing.assert_allclose(got, [float(x) for x in want], rtol=1e-5,
                               atol=1e-5)


def test_main_on_the_jax_draws_prints_the_jax_scripts_lines(monkeypatch,
                                                            capsys):
    twin = _load("alpha_mismatch_torch")
    _on_jax_draws(twin, monkeypatch, ROUNDS)
    twin.main(["--rounds", str(ROUNDS), "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["alpha_mismatch", "--rounds",
                                      str(ROUNDS)])
    _load("alpha_mismatch").main()
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _template(g) == _template(w)
        for a, b in zip(g.split(), w.split()):
            x, y = _number(a), _number(b)
            # printed to 4 decimals: one step of the last digit apart at most
            assert a == b or (x is not None and abs(x - y) <= 1.5e-4), (g, w)


def test_short_run_prints_the_jax_scripts_lines(monkeypatch, capsys):
    out = _load("alpha_mismatch_torch").main(["--rounds", "8",
                                               "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["alpha_mismatch", "--rounds", "8"])
    _load("alpha_mismatch").main()
    want = capsys.readouterr().out.splitlines()
    verdict = "tracking recovers the matched trajectory: "
    assert [_template(l) for l in got if not l.startswith(verdict)] == \
        [_template(l) for l in want if not l.startswith(verdict)]
    assert any(l.startswith(verdict) and l.split()[-1] in ("OK", "VIOLATED")
               for l in got)
    assert all(np.isfinite(out[k]) for k in ("matched", "mismatched",
                                             "tracked", "alpha_hat"))


def test_eighty_rounds_track_alpha_within_a_tenth(capsys):
    out = _load("alpha_mismatch_torch").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert abs(out["alpha_hat"] - 1.2) <= 0.1, out
    assert out["recovered"] and text.rstrip().endswith(
        "tracking recovers the matched trajectory: OK")

