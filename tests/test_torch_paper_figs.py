"""The paper's figure experiments on the port against the JAX package's,
on the CPU: ``repro_torch.experiments.paper_figs`` against
``benchmarks/paper_figs.py`` and ``examples/paper_experiment_torch.py``
against ``examples/paper_experiment.py``.

``_run`` is held to the JAX ``_run`` at 3 rounds on the JAX round's own
inputs. The JAX script calls ``make_round_step`` with no backend, which
resolves to "jnp" (the interference drawn leaf by leaf); the port's
per-round round is the "pallas" one (drawn over the slab). So the JAX
module's ``make_round_step`` is forced to ``backend="pallas"`` here (on
the test side only), the port is fed the draws that round makes from
its ``run_rounds`` key chain (``tests/_torch_ref.py:ref_draws``), and it
starts from the JAX model's ``init(key(seed))``. The losses agree within
1e-5 (the trajectory tier); the accuracy to one example of the set (a
logit near-tie).

The figures make the JAX module's calls of ``_run``, in order, with its
arguments (a recorder swapped in for ``_run``). ``ROUNDS`` is a known-bad
reference cell: the JAX ``_run`` binds it at import, so setting it moves
nothing there; the port reads it at the call. The example twin prints
the JAX script's lines (canned figure records and Remark-3 trainings in
both scripts) and raises its ``AssertionError``.
"""

import functools
import importlib.util
import inspect
import pathlib
import re
import sys

import jax
import numpy as np
import pytest

from _torch_ref import ref_draws, round_key_chain
from repro.core import fl as jfl
from repro.core.slab import make_slab_spec as j_make_slab_spec
from repro.models import vision as jvision
from repro_torch.convert import params_from_numpy
from repro_torch.experiments import paper_figs as tpf
from repro_torch.models import vision as tvision

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import paper_figs as jpf  # noqa: E402

TOL = 1e-5
ROUNDS = 3
CONFIG = ("optimizer", "task", "alpha", "scale", "n_clients", "dir_alpha",
          "beta2")
CASES = [("logreg", "adam_ota"), ("logreg", "fedavgm"),
         ("logreg", "yogi_ota"), ("mlp", "adagrad_ota"), ("cnn", "adam_ota")]
# each task's model, as both packages' _run build it: constructor, args
MODELS = {"logreg": ("logistic_regression", (32, 10), {}),
          "mlp": ("mlp", (32, 10), {"hidden": 64}),
          "cnn": ("resnet_tiny", (10,), {"channels": (8, 16),
                                         "blocks_per_stage": 1})}
N_EXAMPLES = {"logreg": 6000, "mlp": 6000, "cnn": 3000}


def _with_history(mp, mod, out):
    """Wrap ``mod.run_rounds`` to keep each run's raw history in ``out``
    (the record's ``loss_curve`` is rounded to 4 decimals)."""
    real = mod.run_rounds

    def run_rounds(*args, **kw):
        res = real(*args, **kw)
        out.append([h["loss"] for h in res[2]])
        return res

    mp.setattr(mod, "run_rounds", run_rounds)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX ``_run`` of each case on the pallas round, computed once,
    with its raw losses."""
    runs, hist = {}, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpf, "make_round_step",
                   functools.partial(jfl.make_round_step, backend="pallas"))
        _with_history(mp, jpf, hist)
        for task, opt in CASES:
            runs[task, opt] = (jpf._run(opt, task=task, rounds=ROUNDS),
                               hist[-1])
    return runs


def _port_on_jax_inputs(task, opt, mp, seed=0):
    """The port's ``_run`` fed the JAX round's draws (its ``run_rounds``
    chain from ``key(seed + 1)``) and started from the JAX model's
    parameters; returns the record and the raw losses."""
    name, args, kw = MODELS[task]
    jmodel = getattr(jvision, name)(*args, **kw)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))
    jspec = j_make_slab_spec(jparams)
    keys = round_key_chain(jax.random.key(seed + 1), ROUNDS)

    def draws(channel, spec, n, seed, device):
        assert spec.padded == jspec.padded and seed == 1
        return lambda t: ref_draws(keys[t], channel, jspec, n)

    def model_fn(*args, **kw):
        model = getattr(tvision, name)(*args, **kw)
        return model._replace(
            init=lambda seed=0, device=None: params_from_numpy(jparams,
                                                               device))

    mp.setattr(tpf, "TorchDraws", draws)
    mp.setattr(tpf, name, model_fn)
    hist = []
    _with_history(mp, tpf, hist)
    return tpf._run(opt, task=task, rounds=ROUNDS, device="cpu"), hist[0]


@pytest.mark.parametrize("task,opt", CASES)
def test_run_matches_jaxs_run_on_its_draws(task, opt, jax_runs, monkeypatch):
    want, want_raw = jax_runs[task, opt]
    got, got_raw = _port_on_jax_inputs(task, opt, monkeypatch)
    assert list(got) == list(want)
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}
    assert {k: got[k] for k in CONFIG} == {k: want[k] for k in CONFIG}
    np.testing.assert_allclose(got_raw, want_raw, rtol=TOL, atol=TOL)
    for k in ("loss_curve", "final_loss", "speed_loss", "first_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert len(got["loss_curve"]) == ROUNDS
    assert abs(got["accuracy"] - want["accuracy"]) * N_EXAMPLES[task] \
        <= 1 + 1e-9


# ---------------------------------------------------------------------------
# The figures' calls of _run
# ---------------------------------------------------------------------------

FIGURES = [("fig2", {}), ("fig2", {"task": "cnn"}), ("fig3", {}),
           ("fig4", {}), ("fig5", {}), ("fig6", {}), ("fig7", {}),
           ("beyond_yogi", {})]


def _recorded(mod, name, kwargs, monkeypatch):
    calls = []
    monkeypatch.setattr(mod, "_run",
                        lambda *a, **kw: calls.append((a, kw)) or {})
    getattr(mod, name)(**kwargs)
    return calls


@pytest.mark.parametrize("name,kwargs", FIGURES,
                         ids=[f"{n}{'-' + k['task'] if k else ''}"
                              for n, k in FIGURES])
def test_figure_makes_jaxs_calls(name, kwargs, monkeypatch):
    want = _recorded(jpf, name, kwargs, monkeypatch)
    got = _recorded(tpf, name, dict(kwargs, device="cpu"), monkeypatch)
    assert want and len(got) == len(want)
    for (ga, gkw), (wa, wkw) in zip(got, want):
        assert ga == wa
        assert gkw == dict(wkw, device="cpu")
    # with no device the figures pass None: the run's default, the card
    assert all(kw["device"] is None
               for _, kw in _recorded(tpf, name, kwargs, monkeypatch))


def test_module_docstrings_carry_the_jax_ones():
    for name in ("fig2", "fig3", "fig4", "fig5", "fig6", "fig7",
                 "beyond_yogi"):
        assert getattr(tpf, name).__doc__ == getattr(jpf, name).__doc__
    assert tpf.ROUNDS == jpf.ROUNDS == 80


# ---------------------------------------------------------------------------
# ROUNDS: read at the call in the port, bound at import in JAX
# ---------------------------------------------------------------------------

def test_rounds_reaches_the_ports_figures_and_not_jaxs(monkeypatch):
    """After ``ROUNDS = 7`` the port's fig 4 trains 7 rounds a run. The
    JAX ``_run``'s default stays 80, and its fig 4 asks ``run_rounds``
    for 80 (a stand-in that trains nothing records the count)."""
    monkeypatch.setattr(tpf, "ROUNDS", 7)
    recs = tpf.fig4(device="cpu")
    assert [len(r["loss_curve"]) for r in recs] == [7] * 4
    assert all(np.isfinite(r["final_loss"]) for r in recs)

    monkeypatch.setattr(jpf, "ROUNDS", 7)
    assert inspect.signature(jpf._run).parameters["rounds"].default == 80
    asked = []

    def run_rounds(rs, params, state, key, batch_fn, n_rounds):
        asked.append(n_rounds)
        return params, state, [{"loss": 2.0}] * n_rounds

    monkeypatch.setattr(jpf, "run_rounds", run_rounds)
    jrecs = jpf.fig4()
    assert asked == [80] * 4
    assert [len(r["loss_curve"]) for r in jrecs] == [80] * 4


# ---------------------------------------------------------------------------
# The example twin
# ---------------------------------------------------------------------------

def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_ex_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(opt, alpha, final_loss, acc):
    return dict(optimizer=opt, task="logreg", alpha=alpha, scale=0.3,
                n_clients=50, dir_alpha=0.1, beta2=0.3,
                final_loss=final_loss, speed_loss=final_loss + 0.1,
                first_loss=2.3026, accuracy=acc, seconds=0.1,
                us_per_round=1000.0, loss_curve=[2.3026, final_loss])


def _canned(monkeypatch, adam_acc, fig5_losses, mismatch):
    """Canned fig2 / fig5 records and Remark-3 trainings in both
    scripts; returns the trainings' calls, JAX's and the port's."""
    fig2 = [_record("adam_ota", 1.5, 0.3127, adam_acc),
            _record("adagrad_ota", 1.5, 0.3381, 0.9012),
            _record("fedavgm", 1.5, 0.6874, 0.8523)]
    fig5 = [_record("adagrad_ota", a, l, 0.9)
            for a, l in zip((1.2, 1.5, 1.8, 2.0), fig5_losses)]
    for mod in (jpf, tpf):
        monkeypatch.setattr(mod, "fig2", lambda *a, **kw: fig2)
        monkeypatch.setattr(mod, "fig5", lambda *a, **kw: fig5)
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    import alpha_mismatch
    twin = _load("paper_experiment_torch")
    calls = {"jax": [], "port": []}

    def train(who):
        def fn(alpha_opt, rounds, *device):
            calls[who].append((alpha_opt, rounds, *device))
            return mismatch[alpha_opt]
        return fn

    monkeypatch.setattr(alpha_mismatch, "train", train("jax"))
    monkeypatch.setattr(twin.alpha_mismatch, "train", train("port"))
    return twin, calls


MISMATCH_OK = {1.2: (0.41, 0.9, 1.2), 2.0: (0.47, 0.88, 2.0),
               "auto": (0.42, 0.9, 1.24)}
MISMATCH_BAD = {1.2: (0.41, 0.9, 1.2), 2.0: (0.47, 0.88, 2.0),
                "auto": (0.42, 0.9, 1.41)}


def _both(monkeypatch, capsys, twin, argv):
    out = twin.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["paper_experiment"] + argv)
    _load("paper_experiment").main()
    want = capsys.readouterr().out.splitlines()
    return out, got, want


@pytest.mark.parametrize("fig5_losses,mismatch,verdicts", [
    ((0.52, 0.47, 0.44, 0.41), MISMATCH_OK, ("OK", "OK")),
    ((0.41, 0.47, 0.44, 0.52), MISMATCH_BAD, ("VIOLATED", "VIOLATED")),
], ids=["ok", "violated"])
def test_example_prints_the_jax_scripts_lines(fig5_losses, mismatch,
                                              verdicts, monkeypatch, capsys):
    twin, calls = _canned(monkeypatch, 0.9231, fig5_losses, mismatch)
    out, got, want = _both(monkeypatch, capsys, twin, ["--rounds", "12"])
    assert got == want
    assert [l.split()[-1] for l in got if l.startswith("  (expected")] == \
        list(verdicts)
    assert calls["jax"] == [(1.2, 12), (2.0, 12), ("auto", 12)]
    assert calls["port"] == [(1.2, 12, "cpu"), (2.0, 12, "cpu"),
                             ("auto", 12, "cpu")]
    assert out["fig5_ok"] == (verdicts[0] == "OK")
    assert out["mismatch"]["ok"] == (verdicts[1] == "OK")
    assert out["mismatch"]["alpha_hat"] == mismatch["auto"][2]
    assert tpf.ROUNDS == 80          # main restores the module's ROUNDS


def test_example_skip_mismatch_prints_the_jax_scripts_lines(monkeypatch,
                                                            capsys):
    twin, calls = _canned(monkeypatch, 0.9231, (0.52, 0.47, 0.44, 0.41),
                          MISMATCH_OK)
    out, got, want = _both(monkeypatch, capsys, twin, ["--skip-mismatch"])
    assert got == want and len(got) == 10
    assert calls == {"jax": [], "port": []} and out["mismatch"] is None


def test_example_raises_the_jax_scripts_assertion(monkeypatch, capsys):
    twin, _ = _canned(monkeypatch, 0.8123, (0.52, 0.47, 0.44, 0.41),
                      MISMATCH_OK)
    with pytest.raises(AssertionError) as got:
        twin.main(["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["paper_experiment"])
    with pytest.raises(AssertionError) as want:
        _load("paper_experiment").main()
    assert str(got.value) == str(want.value) == \
        "paper claim violated: Adam-OTA should beat FedAvgM"
    assert tpf.ROUNDS == 80


def _template(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "#", line).replace("VIOLATED", "OK")


def test_short_run_prints_the_jax_scripts_templates(monkeypatch, capsys):
    """A real 3-round run of fig 2 and fig 5 on the CPU prints the JAX
    script's lines up to the numbers (and the verdict)."""
    twin = _load("paper_experiment_torch")
    out = twin.main(["--rounds", "3", "--skip-mismatch", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    _canned(monkeypatch, 0.9231, (0.52, 0.47, 0.44, 0.41), MISMATCH_OK)
    monkeypatch.setattr(sys, "argv", ["paper_experiment", "--skip-mismatch"])
    _load("paper_experiment").main()
    want = capsys.readouterr().out.splitlines()
    assert [_template(l) for l in got] == [_template(l) for l in want]
    recs = out["fig2"] + out["fig5"]
    assert [len(r["loss_curve"]) for r in recs] == [3] * 7
    assert all(np.isfinite(r["final_loss"]) and 0 <= r["accuracy"] <= 1
               for r in recs)
