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
* which kernel a CUDA call gets (``flash_variant``, a pure function of
  dtype and shape), each variant's tier (``flash_tolerance``) on
  hand-made values and the Hopper one's against a CPU model of its
  arithmetic (p rounded to bf16 before ``p @ v``), and the plain version
  on query rows that see no key against JAX's reference (the mean of v
  over all keys);
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
from repro_torch.kernels.flash_attention import (HOPPER_MAX_SEQ_Q,
                                                 flash_attention,
                                                 flash_tolerance,
                                                 flash_variant)
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
# The two kernels' dispatch, the Hopper variant's tier, rows without keys
# --------------------------------------------------------------------------

_BF, _F32 = torch.bfloat16, torch.float32
_ALIGNED = (0x7f0000000000, 0x7f0000100000, 0x7f0000200000, 0x7f0000300000)
# (dtype, head dim, Sq, data pointers q / k / v / out) -> variant
VARIANT_CASES = {
    "bf16 D128 (every dense zoo model)": (_BF, 128, 4096, _ALIGNED, "hopper"),
    "bf16 D64": (_BF, 64, 100, _ALIGNED, "hopper"),
    "bf16 at the q-tile limit": (_BF, 128, HOPPER_MAX_SEQ_Q, _ALIGNED,
                                 "hopper"),
    "bf16 past the q-tile limit": (_BF, 128, HOPPER_MAX_SEQ_Q + 1, _ALIGNED,
                                   "scalar"),
    "f32 D128": (_F32, 128, 4096, _ALIGNED, "scalar"),
    "bf16 D32": (_BF, 32, 64, _ALIGNED, "scalar"),
    "bf16 D80": (_BF, 80, 64, _ALIGNED, "scalar"),
    "bf16 D256": (_BF, 256, 64, _ALIGNED, "scalar"),
    "bf16 k 8-byte aligned": (_BF, 128, 64, (_ALIGNED[0], _ALIGNED[1] + 8,
                                             *_ALIGNED[2:]), "scalar"),
    "bf16 out 2-byte aligned": (_BF, 64, 64, (*_ALIGNED[:3],
                                              _ALIGNED[3] + 2), "scalar"),
}


@pytest.mark.parametrize("name", sorted(VARIANT_CASES))
def test_flash_variant_is_chosen_from_dtype_and_shape(name):
    dtype, d, sq, ptrs, want = VARIANT_CASES[name]
    assert flash_variant(dtype, d, sq, ptrs) == want


_REF = torch.tensor([1.0, -2.0, 0.0, 0.5, 3.0])
TOLERANCE_CASES = {
    # variant, ref dtype, |v| attention -> 2^-7 |ref| + 2^-8 attn + 2e-5
    "hopper": ("hopper", _BF, torch.tensor([0.5, 1.0, 0.8, 0.0, 3.0]),
               [2 ** -7 + 2 ** -9, 2 ** -6 + 2 ** -8, 0.8 * 2 ** -8, 2 ** -8,
                3 * 2 ** -7 + 3 * 2 ** -8]),
    "scalar bf16": ("scalar", _BF, None,
                    [2 ** -7, 2 ** -6, 0.0, 2 ** -8, 3 * 2 ** -7]),
    "scalar f32": ("scalar", _F32, None, [0.0] * 5),
}


@pytest.mark.parametrize("name", sorted(TOLERANCE_CASES))
def test_flash_tolerance_on_hand_made_values(name):
    variant, dtype, ref_abs_v, want = TOLERANCE_CASES[name]
    got = flash_tolerance(variant, _REF.to(dtype), ref_abs_v)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.tensor(want) + 2e-5, rtol=1e-7,
                               atol=0.0)


def test_flash_tolerance_refuses_unknown_variants():
    with pytest.raises(ValueError, match="unknown variant"):
        flash_tolerance("cutlass", _REF)


def _hopper_model(q, k, v, causal, window, skip_tile=None):
    """The Hopper kernel's arithmetic on the CPU: f32 scores and softmax,
    p rounded to bf16 for ``p @ v`` with f32 sums, l from the f32 p, the
    output rounded to bf16. ``skip_tile`` drops the 128 keys from that
    index on, in both sums (a fault the tier must catch)."""
    b, sq, hn, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, hn // kh, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / d ** 0.5
    dpos = torch.arange(sq)[:, None] - torch.arange(k.shape[1])[None, :]
    ok = torch.ones_like(dpos, dtype=torch.bool)
    if causal:
        ok &= dpos >= 0
    if window is not None:
        ok &= dpos < window
    s = s.masked_fill(~ok, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if skip_tile is not None:
        p[..., skip_tile:skip_tile + 128] = 0.0
    o = torch.einsum("bkgqs,bskd->bqkgd", p.bfloat16().float(), v.float())
    o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, sq, hn, d).bfloat16()


def _bf16_qkv(case, seed):
    b, sq, sk, h, kh, d = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16()
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]


HOPPER_MODEL_CASES = [
    (1, 256, 256, 2, 1, 128, True, None),
    (1, 64, 1024, 2, 2, 64, False, None),
    (1, 300, 300, 4, 2, 128, True, 100),
]


@pytest.mark.parametrize("case", HOPPER_MODEL_CASES, ids=str)
def test_hopper_tier_holds_p_rounded_to_bf16(case):
    """The tier covers what the Hopper kernel's arithmetic does to the
    plain version's result, with room to spare; and it is not so loose
    that one dropped kv tile of a long row passes."""
    causal, window = case[6:]
    q, k, v = _bf16_qkv(case, sum(case[:6]))
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    ref_abs_v = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                    causal=causal, window=window)
    tol = flash_tolerance("hopper", ref, ref_abs_v)
    got = _hopper_model(q, k, v, causal, window)
    share = float(((got.float() - ref.float()).abs() / tol).max())
    assert share <= 0.9, share
    if window is None:   # the last 128 keys: every row keeps some key
        dropped = _hopper_model(q, k, v, causal, window,
                                skip_tile=case[2] - 128)
        assert float(((dropped.float() - ref.float()).abs() / tol).max()) > 1


KEYLESS_CASES = [
    # (B, Sq, Sk, H, K, D, causal, window): rows from Sk + window - 1 on
    # see no key
    (1, 300, 100, 4, 2, 64, False, 64),
    (1, 300, 100, 4, 2, 32, True, 64),
    (1, 200, 40, 2, 1, 32, False, 50),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KEYLESS_CASES, ids=str)
def test_plain_version_on_rows_without_keys_matches_jax(case, dtype):
    causal, window = case[6:]
    (jq, jk, jv), (q, k, v) = _qkv(case, dtype)
    want = j_flash_ref(jq, jk, jv, causal=causal, window=window)
    got = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = TOL[dtype]
    assert_close(got, want, tol, tol, "vs flash_attention_ref")
    # those rows hold the mean of v over all Sk keys
    first = case[2] + window - 1
    g = case[3] // case[4]
    mean = v.float().mean(1).repeat_interleave(g, dim=1)     # (B, H, D)
    rows = got[:, first:].float()
    assert rows.shape[1] == case[1] - first > 0
    assert_close(rows, mean[:, None].expand_as(rows), tol, tol,
                 "rows without keys")


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
