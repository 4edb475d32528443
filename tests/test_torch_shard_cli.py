"""The training CLI on the sharded engine (``--backend pallas_sharded``),
on the CPU: ``--mesh 2 --device cpu`` runs two gloo worker processes,
``--mesh 1`` runs in this process.

Held: the printed lines are the JAX CLI's on the same mesh (run in a
subprocess on 2 forced host devices, as it forces them itself), the
numbers aside; on the f32 wire the losses of a mesh-2 run agree with the
port's own ``--backend pallas`` run on the same seed within 1e-4
relative (the draws are the same on every real entry; the bf16 leaves
turn summation-order differences into that drift, as between the JAX
package's backends); the (1,)-mesh's quantized state is the resident
CLI's, bitwise; a resume from a mesh-2 checkpoint is bitwise the
uninterrupted mesh-2 run.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--preset", "tiny", "--clients", "4", "--seq", "32",
        "--device", "cpu", "--log-every", "1"]
SHARDED = ["--backend", "pallas_sharded"]
INT8 = ["--uplink", "int8", "--error-feedback", "--track-alpha"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _template(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?(e[+-]\d+)?", "#", line)


def _state_slabs(s):
    return [s.w, *s.opt, s.alpha_hat] + ([s.ef] if s.ef is not None else [])


def test_mesh_run_prints_the_jax_clis_lines(capfd):
    argv = ["--preset", "tiny", "--clients", "4", "--seq", "32",
            "--rounds", "2", "--log-every", "1", *SHARDED, "--mesh", "2"]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    jax_cli = subprocess.Popen([sys.executable, "-m", "repro.launch.train",
                                *argv], stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, env=env,
                               cwd=str(ROOT))
    try:
        out = train.main(argv + ["--device", "cpu"])
        got = [x for x in capfd.readouterr().out.splitlines() if x]
        stdout, stderr = jax_cli.communicate(timeout=300)
    finally:
        jax_cli.kill()
    assert jax_cli.returncode == 0, stderr
    want = stdout.splitlines()
    assert len(got) == len(want) == 5
    assert got[:2] == want[:2]      # arch line; "client mesh {'data': 2} ..."
    assert want[1] == "client mesh {'data': 2} (2 devices visible)"
    assert [_template(x) for x in got] == [_template(x) for x in want]
    losses = [h["loss"] for h in out["history"]]
    assert got[-1] == (f"done: final loss {losses[-1]:.4f} "
                       f"(started {losses[0]:.4f})")


def test_f32_mesh_losses_agree_with_the_resident_cli():
    base = TINY + ["--rounds", "3"]
    resident = train.main(base)
    one = train.main(base + SHARDED + ["--mesh", "1"])
    two = train.main(base + SHARDED + ["--mesh", "2"])
    want = np.array([h["loss"] for h in resident["history"]])
    for run in (one, two):
        got = np.array([h["loss"] for h in run["history"]])
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert int(run["state"].step) == 3
    # the gathered state has the mesh's layout (256-entry padding quantum)
    assert two["state"].spec.shards == 2
    assert two["state"].w.shape[0] % 256 == 0


def test_one_rank_mesh_quantized_state_is_the_resident_clis_bitwise():
    base = TINY + INT8 + ["--rounds", "3"]
    a = train.main(base)["state"]
    b = train.main(base + SHARDED + ["--mesh", "1"])["state"]
    for x, y in zip(_state_slabs(a), _state_slabs(b), strict=True):
        assert torch.equal(x, y)


def test_resume_from_a_mesh_checkpoint_is_bitwise(tmp_path):
    base = TINY + INT8 + SHARDED + ["--mesh", "2"]
    full = train.main(base + ["--rounds", "4", "--history-out",
                              str(tmp_path / "full.json")])
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    first = train.main(base + ["--rounds", "2", *ck])
    assert len(first["history"]) == 2
    assert (tmp_path / "ck" / "round_2.npz").exists()
    resumed = train.main(base + ["--rounds", "4", *ck, "--resume",
                                 "--history-out",
                                 str(tmp_path / "resumed.json")])
    want = json.loads((tmp_path / "full.json").read_text())
    assert json.loads((tmp_path / "resumed.json").read_text()) == want[2:]
    a, b = resumed["state"], full["state"]
    assert int(a.step) == int(b.step) == 4
    assert a.ef.shape == (2, a.spec.padded)
    for x, y in zip(_state_slabs(a), _state_slabs(b), strict=True):
        assert torch.equal(x, y)


def test_mesh_flag_errors():
    with pytest.raises(SystemExit) as e:
        train.main(TINY + SHARDED + ["--mesh", "2,x"])
    assert e.value.code == 2
    with pytest.raises(RuntimeError, match="n_clients=4 must be divisible "
                                           "by the mesh's client-shard "
                                           "count 3"):
        train.main(TINY + SHARDED + ["--mesh", "3", "--rounds", "1"])
