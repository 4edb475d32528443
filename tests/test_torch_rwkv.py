"""The port's RWKV-6 module and the rwkv family (RWKV-6-7B) against the
JAX package, on the CPU.

Inputs come from numpy seeds; the JAX package's parameters are carried
across with ``repro_torch.convert`` (the values move bitwise), with the
leaves that init sets to constants (``mix_base``, ``w0``, ``mix_k``,
``mix_r``) redrawn so that the ddlerp and the channel mix's casts are
exercised. Tiers:

* ``_wkv_chunked`` (y and the final state) at the ``(s, chunk)`` cases
  of ``tests/test_ssm_rwkv.py``: f32 within 1e-5 of scale;
* ``time_mix_forward`` (output, final state, last input) and
  ``channel_mix_forward``, then three ``time_mix_decode`` /
  ``channel_mix_decode`` steps from the prefill state (outputs and the
  cache, written in place): f32 within 1e-4 of scale, bf16 within 3e-2;
* the model (``tests/_torch_family.py``): ``forward``, ``prefill`` and 8
  greedy decode steps of the smoke config, ``loss_fn`` and its
  gradients (in bf16 both packages' gradients against the f32 one at
  5e-2 of scale, a tier JAX's own bf16 gradient needs: 4.4e-2), the
  tiny preset's 3-round slab trajectory, ``n_params``,
  ``stack_init`` drawing in place, the two CLIs and
  ``examples/serve_decode_torch.py`` on the CPU.
"""

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family as fam
from repro.models import rwkv as jrwkv
from repro_torch.models import rwkv as trwkv

ARCH = "rwkv6-7b"
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("s,chunk", [(7, 4), (16, 4), (33, 8), (12, 16)])
def test_wkv_chunked_matches_jax(s, chunk):
    b, h, d = 2, 3, 8
    rng = np.random.default_rng(s * 100 + chunk)
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    w = (0.3 + 0.6 / (1 + np.exp(-rng.standard_normal((b, s, h, d))))
         ).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, d))).astype(np.float32)
    jy, js = jrwkv._wkv_chunked(*map(jnp.asarray, (r, k, v, w, u)), chunk)
    ty, ts = trwkv._wkv_chunked(*map(torch.from_numpy, (r, k, v, w, u)),
                                chunk)
    assert ty.dtype == ts.dtype == torch.float32
    fam.scaled_close(ty, jy, 1e-5, "y")
    fam.scaled_close(ts, js, 1e-5, "final state")


CFG = dict(d_model=64, n_heads=2, d_ff=128, lora_rank=8, chunk=4)


def _module(dtype, s=11):
    jcfg, tcfg = jrwkv.RWKVConfig(**CFG), trwkv.RWKVConfig(**CFG)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rng = np.random.default_rng(2)
    jt = jrwkv.time_mix_init(jax.random.key(0), jcfg, jdt)
    jt["mix_base"] = jnp.asarray(
        0.5 * rng.standard_normal((5, CFG["d_model"])), jnp.float32)
    jt["w0"] = jnp.asarray(-2.0 + 0.5 * rng.standard_normal(CFG["d_model"]),
                           jnp.float32)
    jc = jrwkv.channel_mix_init(jax.random.key(1), jcfg, jdt)
    for key in ("mix_k", "mix_r"):
        jc[key] = jnp.asarray(rng.uniform(size=CFG["d_model"]), jnp.float32)
    x = rng.standard_normal((2, s, CFG["d_model"])).astype(np.float32)
    tdt = getattr(torch, dtype)
    return (jcfg, tcfg, jt, fam.tensors(jt), jc, fam.tensors(jc),
            jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_and_channel_mix_forward_match_jax(dtype):
    jcfg, tcfg, jt, tt, jc, tc, jx, tx = _module(dtype)
    tier = fam.TIER[dtype]
    jy, js, jlast = jrwkv.time_mix_forward(jt, jcfg, jx, return_state=True)
    ty, ts, tlast = trwkv.time_mix_forward(tt, tcfg, tx, return_state=True)
    assert ty.dtype == tx.dtype and ts.dtype == torch.float32
    fam.scaled_close(ty, jy, tier, "time mix")
    fam.scaled_close(ts, js, tier, "time mix final state")
    fam.scaled_close(tlast, jlast, 0.0, "time mix last input")
    fam.scaled_close(trwkv.channel_mix_forward(tc, tcfg, tx),
                     jrwkv.channel_mix_forward(jc, jcfg, jx), tier,
                     "channel mix")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_continues_the_prefill_state_in_place(dtype):
    """Prefill 11 tokens, then three decode steps of the time and channel
    mix on the cache the prefill left; each step against JAX's, and the
    cache the port's decode writes in place against JAX's new one."""
    jcfg, tcfg, jt, tt, jc, tc, jx, tx = _module(dtype)
    tier = fam.TIER[dtype]
    _, js, jlast = jrwkv.time_mix_forward(jt, jcfg, jx, return_state=True)
    _, ts, tlast = trwkv.time_mix_forward(tt, tcfg, tx, return_state=True)
    jcache = {"state": js, "x_tm": jlast, "x_cm": jx[:, -1]}
    tcache = {"state": ts.clone(), "x_tm": tlast.clone(),
              "x_cm": tx[:, -1].clone()}
    held = dict(tcache)
    x1 = np.random.default_rng(9).standard_normal(
        (3, 2, 1, CFG["d_model"])).astype(np.float32)
    for step in range(3):
        jx1 = jnp.asarray(x1[step]).astype(jx.dtype)
        tx1 = torch.from_numpy(x1[step]).to(tx.dtype)
        jy, jcache = jrwkv.time_mix_decode(jt, jcfg, jx1, jcache)
        ty, tcache = trwkv.time_mix_decode(tt, tcfg, tx1, tcache)
        fam.scaled_close(ty, jy, tier, f"time mix decode {step}")
        jy, jcache = jrwkv.channel_mix_decode(jc, jcfg, jx1, jcache)
        ty, tcache = trwkv.channel_mix_decode(tc, tcfg, tx1, tcache)
        fam.scaled_close(ty, jy, tier, f"channel mix decode {step}")
        assert all(tcache[k] is held[k] for k in held)
        for k in held:
            fam.scaled_close(tcache[k], jcache[k], tier, f"cache {k}")


def test_prefill_then_decode_equals_one_longer_prefill():
    """The time mix's prefill state continued by decode gives what a
    forward over the whole sequence gives (f32, 2e-5 of scale)."""
    _, tcfg, _, tt, _, _, _, tx = _module("float32", s=10)
    want = trwkv.time_mix_forward(tt, tcfg, tx)
    _, s, last = trwkv.time_mix_forward(tt, tcfg, tx[:, :7],
                                        return_state=True)
    cache = {"state": s, "x_tm": last, "x_cm": torch.zeros_like(last)}
    got = [trwkv.time_mix_decode(tt, tcfg, tx[:, t:t + 1], cache)[0]
           for t in range(7, 10)]
    fam.scaled_close(torch.cat(got, 1), want[:, 7:], 2e-5, "decode")


# --------------------------------------------------------------------------
# the rwkv family
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_greedy_decode_match_jax(dtype):
    fam.check_forward_prefill_decode(ARCH, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(dtype):
    """In bf16 the gradient leaves of both packages are held to the f32
    gradient (``_torch_family.BF16_VS_F32``): JAX's own bf16 gradient is
    4.4e-2 of scale from it, the port's 3.3e-2 (the loss at 2e-3 of
    JAX's, as in every family)."""
    fam.check_loss_and_gradients(ARCH, dtype, bf16_vs_jax=False)


def test_tiny_slab_round_matches_jax_pallas_round():
    fam.check_tiny_slab_round(ARCH)


@pytest.mark.parametrize("preset,n_layers,want", [
    ("tiny", None, None), ("full", None, 7_618_830_336),
    ("full", 2, 979_501_056)])      # run (d) of chip_smoke.py
def test_n_params_is_the_jax_packages(preset, n_layers, want):
    n = fam.check_n_params(ARCH, preset, n_layers)
    assert want is None or n == want


@pytest.mark.parametrize("n_layers", [1, 3])
def test_stack_init_is_per_layer_init_drawn_in_place(n_layers, monkeypatch):
    shapes = fam.check_stack_init_in_place(ARCH, n_layers, monkeypatch)
    assert (5, 16, 128) in shapes and (4, 32) in shapes   # mix_w2, u


def test_the_clis_serve_and_train_the_family_on_the_cpu(capsys):
    fam.check_clis(ARCH, capsys)


def _example():
    path = ROOT / "examples" / "serve_decode_torch.py"
    spec = importlib.util.spec_from_file_location("serve_decode_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_decode_twin_runs_its_default_on_the_cpu(capsys):
    """The JAX example's defaults and ``--`` pass-through; its two lines
    printed as the JAX CLI prints them."""
    ex = _example()
    assert ex.launcher_argv([]) == ex.DEFAULT_ARGV == [
        "--arch", "rwkv6-7b", "--preset", "tiny", "--batch", "2",
        "--prompt-len", "32", "--gen", "8"]
    assert ex.launcher_argv(["--", "--arch", "hymba-1.5b"]) == [
        "--arch", "hymba-1.5b"]
    r = ex.main(ex.launcher_argv(["--device", "cpu"]))
    assert tuple(r["ids"].shape) == (2, 8)
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"arch=rwkv6-7b prefill 32 toks x2: [\d.]+ ms; "
                        r"decode 8 toks: [\d.]+ ms \([\d.]+ ms/tok\)",
                        lines[0]), lines[0]
    assert lines[1] == f"generated ids[0,:16]: {r['ids'][0].tolist()}"
