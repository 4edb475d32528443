"""The port's training CLI (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``), on the CPU.

The JAX CLI builds its parser and its batch function inside ``main``;
the tests reach them by stopping its ``main`` at ``parse_args`` and at
``run_rounds_slab``. Held: the flags, defaults, choices and help texts
(all but ``--device``, which the port adds, and ``--backend``, whose
default is ``pallas``, the port's single-device engine); each refusal
and its reason; the printed lines of a tiny run (the same lines, the
numbers aside: the two packages draw other random weights); the token
batches, bitwise; ``n_params`` of every dense arch at each preset; a
checkpointed run resumed at round 2 bitwise the uninterrupted one; and
the example twin.
"""

import argparse
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.launch.train as j_train
from repro.configs import get_config as j_get_config
from repro_torch.configs import get_config, preset_config
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--preset", "tiny", "--clients", "4", "--seq", "32"]
DENSE = ["qwen3-14b", "qwen2.5-14b", "starcoder2-15b"]


@pytest.fixture(autouse=True)
def _one_thread():
    """The CLI's tiny model runs many small ops a round; with a thread
    pool per test worker they oversubscribe the cores (a 60-round run
    took minutes beside other workers, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    pass


def _jax_parser(monkeypatch):
    """The JAX CLI's parser, as its ``main`` builds it."""
    def stop(self, args=None, namespace=None):
        raise _Stop(self)

    monkeypatch.setattr(sys, "argv", ["train"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Stop) as e:
        j_train.main()
    return e.value.args[0]


def _flags(ap):
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.default,
                     None if a.choices is None else tuple(a.choices),
                     a.type, a.help, a.nargs, a.const)
            for a in ap._actions}


def test_flags_defaults_and_choices_are_the_jax_clis(monkeypatch):
    want = _flags(_jax_parser(monkeypatch))
    got = _flags(train.build_parser())
    # the one help text the port words otherwise: the JAX text dates the
    # int8 sign container by the change that brought it
    sign_pack = list(want["sign_pack"])
    sign_pack[5] = re.sub(r"'int8' is the .*?byte-per-coord",
                          "'int8' is the byte-per-coord", sign_pack[5])
    want["sign_pack"] = tuple(sign_pack)
    assert set(got) - set(want) == {"device"}
    assert set(want) - set(got) == set()
    for dest in want:
        if dest == "backend":
            continue
        assert got[dest] == want[dest], dest
    # --backend: the same flag, choices and help; the default is the one
    # backend the port takes
    backend = list(want["backend"])
    backend[2] = "pallas"
    assert got["backend"] == tuple(backend)


REFUSALS = {
    "no-interpret": (["--no-interpret"], "no Pallas interpret mode"),
    "no-donate": (["--no-donate"], "no XLA buffer donation"),
    "donation-report": (["--donation-report"], "no XLA buffer donation"),
    "backend jnp": (["--backend", "jnp"], "no backend switch"),
    # the default mesh (2) on the card: one rank a card, and this
    # machine has fewer
    "backend pallas_sharded": (["--backend", "pallas_sharded"],
                               r"needs 2 cards.*--mesh 1"),
    # the JAX CLI's own refusals, kept
    "mesh": (["--mesh", "2"], "only applies to --backend pallas_sharded"),
    "comm-buckets": (["--comm-buckets", "2"],
                     "needs --backend pallas_sharded"),
    "resume": (["--resume"], "--resume needs --ckpt-dir"),
    "scan-rounds": (["--scan-rounds", "0"], "must be >= 1"),
    "comm-buckets 0": (["--comm-buckets", "0"], "must be >= 1"),
    "alpha-opt": (["--alpha-opt", "x"], "must be a float or 'auto'"),
    "track-alpha": (["--track-alpha", "--alpha-opt", "1.3"], "conflicts"),
    "error-feedback": (["--error-feedback"], "needs a quantized uplink"),
    "sr-inkernel": (["--sr-inkernel"], "int8 uplink only"),
    "double-buffer": (["--double-buffer"], "needs --client-chunk"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_name_their_reason(name, capsys):
    argv, match = REFUSALS[name]
    with pytest.raises(SystemExit) as e:
        train.main(argv)
    assert e.value.code == 2
    assert re.search(match, capsys.readouterr().err), name


@pytest.mark.parametrize("arch,key", [("whisper-medium", "audio_embed"),
                                      ("llama-3.2-vision-11b",
                                       "image_embed")])
def test_other_families_name_their_roadmap_item(arch, key, capsys):
    """The encdec and vlm archs are refused by name, as REFUSALS are: the
    CLI's batches hold tokens only (the JAX CLI's too, on which these
    models fail), and the message names the batch entry they need and
    the round API that trains them."""
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", arch, "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert re.search(rf"--arch {arch}: .*batch\['{key}'\]", err), err
    assert "make_slab_round_runner" in err


def _template(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?(e[+-]\d+)?", "#", line)


def test_tiny_run_prints_the_jax_clis_lines(monkeypatch, capsys):
    argv = TINY + ["--rounds", "3", "--log-every", "1"]
    out = train.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--backend", "pallas"])
    j_train.main()
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 5
    assert got[0] == want[0]            # arch, params, vocab, clients, alpha
    assert [_template(x) for x in got] == [_template(x) for x in want]
    losses = [h["loss"] for h in out["history"]]
    assert [h["round"] for h in out["history"]] == [0, 1, 2]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert got[-1] == (f"done: final loss {losses[-1]:.4f} "
                       f"(started {losses[0]:.4f})")


def test_batches_are_the_jax_clis_bitwise(monkeypatch):
    args = TINY + ["--batch", "3", "--dir", "0.3", "--seed", "2"]

    def stop(run_chunk, state, draws, batch_fn, *a, **kw):
        raise _Stop(batch_fn)

    monkeypatch.setattr(sys, "argv", ["train", *args])
    monkeypatch.setattr(j_train, "run_rounds_slab", stop)
    with pytest.raises(_Stop) as e:
        j_train.main()
    j_batch_fn = e.value.args[0]
    corpus = train.client_corpus(257, 32, 4, 3, 0.3, 2)
    batch_fn = train.make_batch_fn(*corpus, batch=3, seq=32, seed=2)
    for t in (0, 1, 7, 123):
        got = batch_fn(t)["tokens"]
        assert got.dtype == torch.int32 and tuple(got.shape) == (4, 3, 32)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j_batch_fn(t, None)["tokens"]))


@pytest.mark.parametrize("preset", ["tiny", "100m", "full"])
@pytest.mark.parametrize("arch", DENSE)
def test_n_params_is_the_jax_packages(arch, preset):
    cfg = preset_config(arch, preset)
    jcfg = j_train.preset_config(arch, preset)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()


def test_n_params_of_the_width_run():
    """StarCoder2-15B's width at depth 1 (the card's width run)."""
    cfg = dataclasses.replace(get_config("starcoder2-15b"), n_layers=1)
    jcfg = dataclasses.replace(j_get_config("starcoder2-15b"), n_layers=1)
    assert cfg.n_params() == jcfg.n_params() == 987_833_344


@pytest.mark.parametrize("ckpt_async", [False, True])
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, ckpt_async):
    base = TINY + ["--log-every", "1", "--device", "cpu", "--uplink", "int8",
                   "--error-feedback", "--track-alpha"]
    full = train.main(base + ["--rounds", "4", "--history-out",
                              str(tmp_path / "full.json")])
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    ck += ["--ckpt-async"] if ckpt_async else []
    first = train.main(base + ["--rounds", "2", *ck])
    assert len(first["history"]) == 2
    resumed = train.main(base + ["--rounds", "4", *ck, "--resume",
                                 "--history-out",
                                 str(tmp_path / "resumed.json")])
    want = json.loads((tmp_path / "full.json").read_text())
    assert json.loads((tmp_path / "resumed.json").read_text()) == want[2:]
    a, b = resumed["state"], full["state"]
    assert int(a.step) == int(b.step) == 4
    for x, y in [(a.w, b.w), (a.ef, b.ef), (a.alpha_hat, b.alpha_hat),
                 *zip(a.opt, b.opt)]:
        assert torch.equal(x, y)


def test_resume_reconciles_error_feedback(tmp_path, capsys):
    base = TINY + ["--device", "cpu", "--uplink", "int8"]
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    train.main(base + ["--rounds", "2", *ck])
    capsys.readouterr()
    out = train.main(base + ["--rounds", "3", "--error-feedback", *ck,
                             "--resume"])
    assert "starting the EF loop from zeros" in capsys.readouterr().out
    assert out["state"].ef is not None and int(out["state"].step) == 3
    out = train.main(base + ["--rounds", "4", *ck, "--resume"])
    assert "--error-feedback is off; dropping it" in capsys.readouterr().out
    assert out["state"].ef is None and int(out["state"].step) == 4


def _example():
    path = ROOT / "examples" / "train_lm_federated_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_twin_argv():
    ex = _example()
    jax_default = ["--preset", "tiny", "--rounds", "60", "--clients", "8",
                   "--seq", "64"]
    assert ex.DEFAULT_ARGV == jax_default
    assert ex.launcher_argv([]) == jax_default
    assert ex.launcher_argv(["--device", "cpu"]) == jax_default + [
        "--device", "cpu"]
    assert ex.launcher_argv(["--", "--preset", "100m"]) == ["--preset",
                                                            "100m"]
    assert ex.launcher_argv(["--rounds", "5"]) == ["--rounds", "5"]


def test_example_twin_runs_its_default_on_the_cpu(capsys):
    ex = _example()
    out = ex.main(ex.launcher_argv(["--device", "cpu"]))
    hist = out["history"]
    assert len(hist) == 60 and hist[-1]["loss"] < hist[0]["loss"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=qwen3-14b params=0.4M vocab=257 "
                               "clients=8")
    assert len(lines) == 1 + 6 + 1          # log every 10 rounds
