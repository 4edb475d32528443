"""The port's flash attention (B5) and its kernel-level ops against the
JAX package, on the CPU.

* ``flash_attention_ref`` (the plain version, which the wrapper runs on a
  CPU tensor) and ``ops.causal_flash_attention`` against the JAX
  package's ``flash_attention_ref`` and its Pallas ``flash_attention``
  in interpret mode, on the six ``FLASH_CASES`` of tests/test_kernels.py
  and in f32 and bf16, with the tolerances that file holds the JAX
  kernel to: 2e-5 in f32, 3e-2 in bf16 (inputs are bf16 there, outputs
  are rounded to bf16 by both sides);
* the wrapper refuses what the kernel does not take, on any device;
* ``ops.fused_server_update`` and ``ops.fused_ota_aggregate`` against
  the JAX package's, the OTA MAC fed the JAX package's own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, to_np
from repro.core import adaptive as jadaptive
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.core.adaptive import (AdaptiveConfig, ServerOptState,
                                       _make_slab_update)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import flash_attention_ref

# (B, Sq, Sk, H, K, D, causal, window, bq, bk), as tests/test_kernels.py
FLASH_CASES = [
    (1, 32, 32, 2, 2, 16, True, None, 16, 16),
    (2, 64, 64, 4, 2, 32, True, None, 32, 32),
    (1, 100, 100, 8, 8, 64, True, 48, 32, 32),
    (2, 1, 96, 4, 2, 32, False, None, 8, 32),     # decode-like
    (1, 80, 80, 6, 3, 16, True, 16, 16, 16),      # GQA group 2 + window
    (1, 33, 65, 2, 1, 8, False, None, 16, 16),    # ragged padding
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(case, dtype):
    b, sq, sk, h, kh, d = case[:6]
    rng = np.random.default_rng(sum(case[:6]))
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    return jx, [tensor_from_numpy(np.asarray(a), "cpu") for a in jx]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_plain_version_matches_jax(case, dtype):
    causal, window, bq, bk = case[6:]
    (jq, jk, jv), (q, k, v) = _qkv(case, dtype)
    want_ref = j_flash_ref(jq, jk, jv, causal=causal, window=window)
    want_pallas = j_flash(jq, jk, jv, causal=causal, window=window, bq=bq,
                          bk=bk, interpret=True)
    got = flash_attention_ref(q, k, v, causal=causal, window=window)
    wrapped = flash_attention(q, k, v, causal=causal, window=window, bq=bq,
                              bk=bk)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(wrapped, got)    # the CPU wrapper is the plain version
    tol = TOL[dtype]
    assert_close(got, want_ref, tol, tol, "vs flash_attention_ref")
    assert_close(got, want_pallas, tol, tol, "vs the Pallas kernel")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_causal_flash_attention_op_matches_jax(case, dtype):
    causal, window, bq, bk = case[6:]
    (jq, jk, jv), (q, k, v) = _qkv(case, dtype)
    want = jops.causal_flash_attention(jq, jk, jv, causal=causal,
                                       window=window, bq=bq, bk=bk,
                                       interpret=True)
    got = ops.causal_flash_attention(q, k, v, causal=causal, window=window,
                                     bq=bq, bk=bk)
    assert_close(got, want, TOL[dtype], TOL[dtype])
    if causal:   # causal is the default
        assert torch.equal(ops.causal_flash_attention(q, k, v, window=window),
                           got)


def test_cpu_wrapper_launches_nothing():
    (_, (q, k, v)) = _qkv(FLASH_CASES[1], "float32")
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before


def _refusals():
    z = torch.zeros
    q, kv = z(1, 8, 4, 16), z(1, 8, 2, 16)
    grad = z(1, 8, 4, 16, requires_grad=True)
    return {
        "requires grad": ((grad, kv, kv), {}, "no backward"),
        "k requires grad": ((q, z(1, 8, 2, 16, requires_grad=True), kv), {},
                            "no backward"),
        "heads": ((z(1, 8, 3, 16), kv, kv), {}, "multiple of kv heads"),
        "mixed dtypes": ((q, kv.bfloat16(), kv), {}, "one dtype"),
        "f16": ((q.half(), kv.half(), kv.half()), {}, "one dtype"),
        "head dim": ((z(1, 8, 4, 300), z(1, 8, 2, 300), z(1, 8, 2, 300)), {},
                     "head dim"),
        "k/v shapes": ((q, kv, z(1, 9, 2, 16)), {}, "k and v must be"),
        "rank": ((q[0], kv, kv), {}, "4-D"),
        "strided": ((z(1, 8, 4, 32)[..., ::2], kv, kv), {}, "contiguous"),
        "window": ((q, kv, kv), {"window": 0}, "window"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_wrapper_refuses(name):
    args, kw, match = _refusals()[name]
    with pytest.raises(ValueError, match=match):
        flash_attention(*args, **kw)


def test_wrapper_refuses_other_devices():
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)


# --------------------------------------------------------------------------
# ops.fused_server_update / fused_ota_aggregate
# --------------------------------------------------------------------------

_OPTIMIZERS = {"adagrad": jadaptive.adagrad_ota, "adam": jadaptive.adam_ota,
               "amsgrad": jadaptive.amsgrad_ota, "yogi": jadaptive.yogi_ota,
               "momentum": jadaptive.fedavgm, "sgd": jadaptive.fedavg}


def _tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((7, 5)).astype(dtype),
            "b": rng.standard_normal((5,)).astype(dtype),
            "blk": {"k": rng.standard_normal((3, 4, 6)).astype(dtype)}}


def jcfg_port(jcfg):
    """The port's AdaptiveConfig equal to a JAX one (less its backend)."""
    return AdaptiveConfig(**{k: getattr(jcfg, k) for k in (
        "optimizer", "lr", "beta1", "beta2", "alpha", "alpha_ema", "eps",
        "momentum")})


@pytest.mark.parametrize("mode", sorted(_OPTIMIZERS))
def test_fused_server_update_matches_jax(mode):
    rng = np.random.default_rng(7)
    params, g = _tree(rng), _tree(rng)
    kw = dict(lr=0.05, beta1=0.9, beta2=0.3, alpha=1.5, eps=1e-8)
    jcfg = jadaptive.AdaptiveConfig(
        optimizer={v: k for k, v in jadaptive._SLAB_MODES.items()}[mode],
        momentum=kw["beta1"], **kw)
    jstate = _OPTIMIZERS[mode](jcfg).init(jax.tree.map(jnp.asarray, params))
    jp, js = jax.tree.map(jnp.asarray, params), jstate
    tp, ts = params_from_numpy(params, "cpu"), ServerOptState(
        *(params_from_numpy(jax.tree.map(np.asarray, x), "cpu")
          for x in jstate))
    for _ in range(3):      # three rounds: the state carries across
        jg = jax.tree.map(jnp.asarray, g)
        jp, js = jops.fused_server_update(jg, js, jp, mode=mode,
                                          interpret=True, **kw)
        tp, ts = ops.fused_server_update(params_from_numpy(g, "cpu"), ts, tp,
                                         mode=mode, **kw)
        g = jax.tree.map(lambda x: 0.5 * x, g)
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert_close(a, b, 1e-5, 1e-6)
    assert int(ts.step) == int(js.step) == 3
    for a, b in zip(jax.tree.leaves((ts.delta, ts.nu)),
                    jax.tree.leaves((js.delta, js.nu))):
        assert_close(a, b, 1e-5, 1e-6)
    # the tree-in / tree-out update is the same launch
    tg = params_from_numpy(g, "cpu")
    want_p, want_s = ops.fused_server_update(tg, ts, tp, mode=mode, **kw)
    got_p, got_s = _make_slab_update(jcfg_port(jcfg))(tg, ts, tp)
    for a, b in zip(jax.tree.leaves((got_p, got_s)),
                    jax.tree.leaves((want_p, want_s))):
        assert torch.equal(a, b)


def test_fused_server_update_refuses_unknown_modes():
    p = params_from_numpy(_tree(np.random.default_rng(0)), "cpu")
    with pytest.raises(ValueError, match="unknown update mode"):
        ops.fused_server_update(p, None, p, lr=0.1, beta1=0.9, beta2=0.3,
                                alpha=1.5, eps=1e-8, mode="lion")


@pytest.mark.parametrize("alpha", [1.2, 1.7, 2.0])
def test_fused_ota_aggregate_matches_jax(alpha):
    rng = np.random.default_rng(3)
    n, d = 6, 1000
    grads = rng.standard_normal((n, d)).astype(np.float32)
    h = rng.uniform(0.5, 1.5, n).astype(np.float32)
    key = jax.random.key(11)
    want = jops.fused_ota_aggregate(jnp.asarray(grads), jnp.asarray(h), key,
                                    alpha=alpha, scale=0.3, interpret=True)
    # the JAX op's draws, made the way it makes them from its key
    ku, ke = jax.random.split(key)
    u = jax.random.uniform(ku, (d,), jnp.float32, -np.pi / 2 + 1e-6,
                           np.pi / 2 - 1e-6)
    e = -jnp.log(jax.random.uniform(ke, (d,), jnp.float32,
                                    minval=jnp.finfo(jnp.float32).tiny))
    got = ops.fused_ota_aggregate(
        *(torch.from_numpy(np.array(x)) for x in (grads, h, u, e)),
        alpha=alpha, scale=0.3)
    assert_close(got, want, 1e-5, 1e-5 * float(np.abs(to_np(want)).max()))
