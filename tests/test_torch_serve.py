"""The port's serve CLI (``repro_torch.launch.serve``) on the CPU.

* its flags and defaults are the JAX CLI's, plus ``--device``;
* ``--preset tiny --device cpu`` prints the JAX CLI's two lines, then
  the decode rate and the peak device memory (not measured on the CPU);
* greedy ``generate`` gives the JAX serve loop's ids for the same
  weights and prompt (f32 smoke configs; starcoder2 across its window);
* temperature sampling is keyed by the seed and the step.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.launch import serve as jserve
from repro.models.model import build_model as j_build_model
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.model import build_model


class _Parsed(Exception):
    pass


def _defaults(main, monkeypatch):
    """The option defaults of a CLI's parser, read when it parses."""
    seen = {}

    def grab(self, *args, **kwargs):
        seen.update({a.dest: a.default for a in self._actions
                     if a.dest != "help"})
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main()
    return seen


def test_flags_and_defaults_are_the_jax_clis(monkeypatch):
    ours = _defaults(serve.main, monkeypatch)
    theirs = _defaults(jserve.main, monkeypatch)
    assert ours.pop("device") is None
    assert ours == theirs
    assert theirs["arch"] == "qwen3-14b" and theirs["preset"] == "tiny"


@pytest.mark.parametrize("arch", ["qwen3-14b", "starcoder2-15b"])
def test_cli_prints_its_lines(arch, capsys):
    r = serve.main(["--arch", arch, "--preset", "tiny", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "70", "--gen", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith(f"arch={arch} prefill 70 toks x2: ")
    assert "decode 5 toks: " in lines[0] and lines[0].endswith(" ms/tok)")
    ids = r["ids"]
    assert lines[1] == f"generated ids[0,:16]: {ids[0, :16].tolist()}"
    assert tuple(ids.shape) == (2, 5)
    assert int(ids.min()) >= 0 and int(ids.max()) < 257
    assert lines[2].startswith("device cpu: decode ")
    assert lines[2].endswith("tokens/s (batch 2); peak device memory not "
                             "measured (cpu)")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--preset", "tiny"])


def _jax_serve_ids(jm, jp, toks, gen, length):
    """The JAX CLI's prefill + greedy decode loop."""
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                               length=length)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        logits, cache = decode(jp, cache, tok, jnp.asarray(toks.shape[1] + i))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch,s", [("qwen3-14b", 20), ("qwen2.5-14b", 20),
                                    ("starcoder2-15b", 70)])
def test_greedy_generate_gives_the_jax_ids(arch, s):
    jcfg = dataclasses.replace(j_smoke_config(arch), param_dtype="float32")
    tcfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(4))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    gen = 9
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (2, s))
    length = min(s + gen, tcfg.window) if tcfg.window else s + gen
    want = _jax_serve_ids(jm, jp, toks, gen, length)
    r = serve.generate(tm, tp, torch.from_numpy(toks), gen)
    np.testing.assert_array_equal(r["ids"].numpy(), want)
    assert r["t_prefill"] > 0 and r["t_decode"] > 0


def test_temperature_sampling_is_keyed_by_seed_and_step():
    tm = build_model(dataclasses.replace(smoke_config("qwen3-14b"),
                                         vocab=257))
    tp = tm.init(seed=0, device="cpu")
    toks = torch.randint(0, 257, (3, 12),
                         generator=torch.Generator().manual_seed(1))

    def ids(seed, temperature=1.5):
        return serve.generate(tm, tp, toks, 10, temperature=temperature,
                              seed=seed)["ids"]

    a, b, c = ids(0), ids(0), ids(1)
    assert torch.equal(a, b)
    assert not torch.equal(a[:, 1:], c[:, 1:])
    assert torch.equal(a[:, 0], c[:, 0])     # the first id is the prefill's
    greedy = ids(0, temperature=0.0)
    assert not torch.equal(a, greedy)
    assert int(a.min()) >= 0 and int(a.max()) < 257
