"""The port's sharded engine at P > 1 against the JAX package's, on the
CPU, on the same draws.

One JAX subprocess (``tests/_torch_shard_jax.py``, 4 forced host
devices, as ``tests/test_shard_roundstep.py`` runs its meshes) runs every
case of ``tests/_torch_shard_cases.py`` and writes its trajectories and
the draws each rank takes: the full round's fields and each
transmitter's rounding rows (``uplink_sr_slab_inputs(key, spec, p)``).
The port's ranks (``repro_torch.launch.shard_check.run_cases``, one
gloo worker process a rank, one start a mesh shape) run the same rounds
on those draws.

Tier: 1e-5 on every state slab and metric over 5 rounds (the trajectory
tier of ``tests/test_torch_wire_round.py``), on the f32 wire for all six
optimizers at P = 2 and (2, 2), on the quantized and streamed wires at
P = 2, on the per-round API and the per-leaf collective round; the
overlap engine (``comm_buckets=2``) at 1e-4, the tier of
``repro.launch.shard_check``. A quantized round agrees that closely only
while both sides make the same rounding decisions; with these inputs no
entry sits within an ulp of a boundary.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_shard_cases import CASES, ROUNDS, inputs
from repro_torch.core.fl import RoundMetrics
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.launch.shard_check import run_cases

HERE = os.path.dirname(os.path.abspath(__file__))
BY_NAME = {c["name"]: c for c in CASES}
DRAW_FIELDS = ("h", "u", "e", "r_dl", "mask", "r_up")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shard") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable,
                        os.path.join(HERE, "_torch_shard_jax.py"), path],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def port(jax_ref):
    """Every case on the port's ranks, one start of workers a mesh."""
    out = {}
    for shape in sorted({c["mesh"] for c in CASES}):
        cases = []
        for c in CASES:
            if c["mesh"] != shape:
                continue
            params, batches = inputs(c)
            draws = {f: jax_ref.get(f"{c['name']}/{f}") for f in DRAW_FIELDS}
            cases.append(dict(name=c["name"], kind=c["kind"],
                              channel=c["channel"], adaptive=c["adaptive"],
                              fl=c["fl"], params=params, batches=batches,
                              rounds=ROUNDS, draws=draws))
        torch.set_num_threads(1)
        out.update(run_on_mesh(run_cases, shape, "cpu", args=(cases, "cpu"),
                               timeout=300))
    return out


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _names(kind):
    return [c["name"] for c in CASES if c["kind"] == kind]


@pytest.mark.parametrize("name", _names("runner"))
def test_sharded_runner_matches_jax(name, jax_ref, port):
    case, res = BY_NAME[name], port[name]
    tol = case["tol"]
    state, ms = res["state"], res["metrics"]
    _close(state["w"], jax_ref[f"{name}/w"], tol, "w")
    n_opt = len([k for k in jax_ref if k.startswith(f"{name}/opt")])
    assert len(state["opt"]) == n_opt
    for i, o in enumerate(state["opt"]):
        _close(o, jax_ref[f"{name}/opt{i}"], tol, f"opt{i}")
    assert state["step"] == int(jax_ref[f"{name}/step"]) == ROUNDS
    _close(state["alpha_hat"], jax_ref[f"{name}/alpha_hat"], tol,
           "alpha_hat")
    if f"{name}/ef" in jax_ref:
        assert state["ef"].shape == jax_ref[f"{name}/ef"].shape
        _close(state["ef"], jax_ref[f"{name}/ef"], tol, "ef")
    else:
        assert state["ef"] is None
    for f in RoundMetrics._fields:
        _close(ms[f], jax_ref[f"{name}/m_{f}"], tol, f)


@pytest.mark.parametrize("name", _names("perround"))
def test_sharded_round_step_matches_jax(name, jax_ref, port):
    leaves = port[name]["leaves"]
    want = sorted((k for k in jax_ref if k.startswith(f"{name}/leaf")),
                  key=lambda k: int(k.rsplit("leaf", 1)[1]))
    assert len(leaves) == len(want)
    for i, (got, key) in enumerate(zip(leaves, want)):
        _close(got, jax_ref[key], BY_NAME[name]["tol"], f"leaf {i}")
    for f in RoundMetrics._fields:
        _close(port[name]["metrics"][f], jax_ref[f"{name}/m_{f}"],
               BY_NAME[name]["tol"], f)


@pytest.mark.parametrize("name", _names("psum"))
def test_sharded_leaf_round_matches_jax(name, jax_ref, port):
    leaves = port[name]["leaves"]
    want = sorted((k for k in jax_ref if k.startswith(f"{name}/leaf")),
                  key=lambda k: int(k.rsplit("leaf", 1)[1]))
    assert len(leaves) == len(want)
    for i, (got, key) in enumerate(zip(leaves, want)):
        _close(got, jax_ref[key], BY_NAME[name]["tol"], f"leaf {i}")
    _close(port[name]["losses"], jax_ref[f"{name}/losses"],
           BY_NAME[name]["tol"], "losses")
