"""The port's quantized wire (plain versions) against the JAX package's,
on the same numpy inputs.

* Transmit: ``kernels.ref.ota_transmit_ref`` against the JAX oracle
  ``repro.kernels.ref.ota_transmit_ref`` and the JAX kernel
  ``ota_transmit_slab`` in Pallas interpret mode. The faded sum is taken
  in another order in each, and a one-ulp change of x can flip one
  rounding decision, so payloads must be equal on at least 99.9 % of
  entries and within one quantization step everywhere; scales agree to
  1e-6 relative plus 1e-6 of their largest; residuals, ``x - q s``, to
  1e-6 relative plus 1e-6 of the largest |x| (an ulp of x carries into
  the residual as it is), and within one step where a payload entry
  flipped.
* Receive: ``ota_receive_ref`` against the JAX oracle (not the interpret
  kernel, which is red against that oracle on this jax) at 1e-5; the
  statistics' count exactly.
* Packing bitwise; the int8 downlink and the zero-tail mask against the
  JAX functions.
* The wrappers on CPU tensors are their plain versions and launch
  nothing; what the port does not cover yet raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, to_np
from repro.core import ota as jota
from repro.core import slab as jslab
from repro.kernels import ota_channel as jkern
from repro.kernels import ref as jref
from repro_torch.core import ota as tota
from repro_torch.core.channel import CMS_U_BOUND
from repro_torch.core.slab import make_slab_spec
from repro_torch.kernels import ota_channel as tkern
from repro_torch.kernels import ref as tref

N, D = 7, 1024
PAD = 100          # the last 100 columns are a padding tail

TX_CASES = [("int8", True, False), ("int8", False, False),
            ("sign", False, False), ("sign", False, True)]


def _tx_inputs(seed):
    rng = np.random.default_rng(seed)
    grads = rng.normal(0, 1, (N, D)).astype(np.float32)
    grads[:, -PAD:] = 0.0
    grads[:, 128:256] = 0.0            # one all-zero block
    grads[:, 300] = 0.0                # an isolated zero
    h = (0.5 + rng.random(N)).astype(np.float32)
    r = rng.random(D).astype(np.float32)
    ef = (0.01 * rng.normal(0, 1, D)).astype(np.float32)
    ef[-PAD:] = 0.0
    ef[128:256] = 0.0
    ef[300] = 0.0
    return grads, h, r, ef


def _assert_payload(q_t, s_t, q_j, s_j):
    """Equal on >= 99.9 % of entries, within one step on the rest."""
    q_t, q_j = to_np(q_t), to_np(q_j)
    s_j = to_np(s_j)
    assert_close(s_t, s_j, 1e-6, 1e-6 * float(np.max(np.abs(s_j))), "s")
    assert np.mean(q_t == q_j) >= 0.999
    assert np.all(np.abs(q_t - q_j) <= 1.0)


def _assert_residual(t_out, j_out, grads, h, ef):
    x = (h[:, None] * grads).sum(axis=0) / N + ef
    same = to_np(t_out[0]) == to_np(j_out[0])
    a, b = to_np(t_out[2]), to_np(j_out[2])
    tol = 1e-6 * np.abs(b) + 1e-6 * float(np.max(np.abs(x)))
    assert np.all(np.abs(a - b)[same] <= tol[same])
    step = np.repeat(to_np(j_out[1]), 128)
    assert np.all(np.abs(a - b)[~same] <= step[~same] * (1 + 1e-6))


@pytest.mark.parametrize("use_ef", [False, True])
@pytest.mark.parametrize("qmode,stochastic,zero_fold", TX_CASES,
                         ids=["int8-sr", "int8-rtn", "sign", "sign-fold"])
def test_transmit_ref_matches_jax_ref_and_kernel(qmode, stochastic,
                                                 zero_fold, use_ef):
    grads, h, r, ef = _tx_inputs(1)
    kw = dict(quantize=True, stochastic=stochastic, qmode=qmode,
              zero_fold=zero_fold, return_residual=use_ef)
    sr = qmode == "int8" and stochastic
    t_out = tref.ota_transmit_ref(
        torch.from_numpy(grads), torch.from_numpy(h),
        r=torch.from_numpy(r) if sr else None,
        ef=torch.from_numpy(ef) if use_ef else None, **kw)
    jargs = dict(r=jnp.asarray(r) if sr else None,
                 ef=jnp.asarray(ef) if use_ef else None, **kw)
    for j_out in (jref.ota_transmit_ref(jnp.asarray(grads), jnp.asarray(h),
                                        **jargs),
                  jkern.ota_transmit_slab(jnp.asarray(grads), jnp.asarray(h),
                                          interpret=True, **jargs)):
        assert len(t_out) == len(j_out) == (3 if use_ef else 2)
        assert t_out[0].dtype == torch.int8 and t_out[1].dtype == torch.float32
        _assert_payload(t_out[0], t_out[1], j_out[0], j_out[1])
        if use_ef:
            _assert_residual(t_out, j_out, grads, h, ef)
    q, s = to_np(t_out[0]), to_np(t_out[1])
    # the padding tail is exact on every container
    assert np.all(q[-PAD:] == (1 if zero_fold else 0))
    assert s[1] == (0.0 if zero_fold else 1.0)   # the all-zero block


def test_transmit_ref_f32_partial_matches_jax():
    grads, h, _, _ = _tx_inputs(2)
    for n_total in (None, 20):
        a = tref.ota_transmit_ref(torch.from_numpy(grads),
                                  torch.from_numpy(h), n_total=n_total)
        b = jref.ota_transmit_ref(jnp.asarray(grads), jnp.asarray(h),
                                  n_total=n_total)
        assert_close(a, b, 1e-6, 1e-6)


def _rx_inputs(seed, rows, qmode):
    rng = np.random.default_rng(seed)
    if qmode == "int8":
        q = rng.integers(-127, 128, (rows, D)).astype(np.int8)
        s = rng.random((rows, D // 128)).astype(np.float32)
    else:
        q = rng.choice(np.array([-1, 0, 1], np.int8), (rows, D))
        s = rng.random((rows, D // 128)).astype(np.float32)
    q[:, -PAD:] = 0
    u = rng.uniform(-CMS_U_BOUND, CMS_U_BOUND, D).astype(np.float32)
    e = (-np.log(rng.random(D))).astype(np.float32)
    u[-PAD:], e[-PAD:] = 0.0, 1.0
    return q, s, u, e


@pytest.mark.parametrize("pilot_stats", [False, True])
@pytest.mark.parametrize("packed", [None, "fold", "planes"])
@pytest.mark.parametrize("rows", [1, 3])
def test_receive_ref_matches_jax_ref(rows, packed, pilot_stats):
    q, s, u, e = _rx_inputs(3, rows, "int8" if packed is None else "sign")
    if packed == "fold":
        q = np.where(q < 0, -1, 1).astype(np.int8)
    kw = dict(alpha=1.5, scale=0.1, packed=packed, pilot_stats=pilot_stats)
    if packed is None:
        tp, jp = torch.from_numpy(q), jnp.asarray(q)
    else:
        tp = tref.pack_sign_slab(torch.from_numpy(q),
                                 planes=packed == "planes")
        jp = jkern.pack_sign_slab(jnp.asarray(q), planes=packed == "planes")
    t_out = tref.ota_receive_ref(tp, torch.from_numpy(s), torch.from_numpy(u),
                                 torch.from_numpy(e), **kw)
    j_out = jref.ota_receive_ref(jp, jnp.asarray(s), jnp.asarray(u),
                                 jnp.asarray(e), **kw)
    if pilot_stats:
        (t_out, t_stats), (j_out, j_stats) = t_out, j_out
        assert float(t_stats[0]) == float(j_stats[0]) == D - PAD
        assert_close(t_stats, j_stats, 1e-5, 1e-3, "stats")
    assert_close(t_out, j_out, 1e-5, 1e-5, "out")
    if packed != "fold":
        assert np.all(to_np(t_out)[-PAD:] == 0.0)


@pytest.mark.parametrize("planes", [False, True])
def test_sign_packing_is_bitwise_jax(planes):
    rng = np.random.default_rng(4)
    q = rng.choice(np.array([-1, 0, 1], np.int8), (3, D))
    if not planes:
        q = np.where(q < 0, -1, 1).astype(np.int8)
    t_words = tref.pack_sign_slab(torch.from_numpy(q), planes=planes)
    j_words = jkern.pack_sign_slab(jnp.asarray(q), planes=planes)
    assert t_words.dtype == torch.uint32
    assert t_words.shape == (3, tref.sign_words(D, planes=planes))
    assert tref.sign_words(D, planes=planes) == jkern.sign_words(
        D, planes=planes)
    np.testing.assert_array_equal(t_words.view(torch.int32).numpy(),
                                  np.asarray(j_words).view(np.int32))
    back = tref.unpack_sign_slab(t_words, D, planes=planes)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jkern.unpack_sign_slab(j_words, D, planes=planes)))
    np.testing.assert_array_equal(back.numpy(), q)
    with pytest.raises(ValueError):
        tref.unpack_sign_slab(t_words[:, 1:], D, planes=planes)
    with pytest.raises(ValueError):
        tref.sign_words(100)


def test_wire_constants_are_the_jax_constants():
    assert tref.LANE == jkern.LANE == jref.LANE
    assert tref.INT8_MAX == jkern.INT8_MAX == jref.INT8_MAX


def test_downlink_quantize_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(0, 1, D).astype(np.float32)
    w[-PAD:] = 0.0
    w[256:384] = 0.0
    r = np.array(jota.downlink_sr_slab_inputs(jax.random.key(1), D))
    a = tota.downlink_quantize_slab(torch.from_numpy(w), torch.from_numpy(r))
    b = jota.downlink_quantize_slab(jnp.asarray(w), jnp.asarray(r))
    assert_close(a, b, 1e-6, 1e-6)
    assert np.all(to_np(a)[-PAD:] == 0.0) and np.all(to_np(a)[256:384] == 0.0)
    # within one quantization step of the f32 master
    s = np.max(np.abs(w.reshape(-1, 128)), axis=1) / 127.0
    assert np.all(np.abs(to_np(a) - w).reshape(-1, 128)
                  <= s[:, None] * (1 + 1e-6))


def test_restore_zero_tail_matches_jax():
    tree = {"a": np.zeros((5, 41), np.float32)}
    tspec, jspec = make_slab_spec(tree), jslab.make_slab_spec(tree)
    assert (tspec.total, tspec.padded) == (jspec.total, jspec.padded)
    x = np.random.default_rng(6).normal(0, 1, tspec.padded).astype(np.float32)
    a = tota.restore_zero_tail(torch.from_numpy(x), tspec)
    b = jota.restore_zero_tail(jnp.asarray(x), jspec)
    np.testing.assert_array_equal(to_np(a), np.asarray(b))
    assert np.all(to_np(a)[tspec.total:] == 0.0)
    assert tota.restore_zero_tail(None, tspec) is None


def test_cpu_wrappers_run_the_plain_versions():
    grads, h, r, ef = (torch.from_numpy(x) for x in _tx_inputs(7))
    before = (tkern.ota_transmit_slab.launches,
              tkern.ota_receive_slab.launches)
    kw = dict(quantize=True, r=r, ef=ef, return_residual=True)
    for a, b in zip(tkern.ota_transmit_slab(grads, h, **kw),
                    tref.ota_transmit_ref(grads, h, **kw)):
        assert torch.equal(a, b)
    q, s, u, e = (torch.from_numpy(x) for x in _rx_inputs(8, 2, "sign"))
    words = tkern.pack_sign_slab(q, planes=True)
    rkw = dict(alpha=1.3, scale=0.1, packed="planes", pilot_stats=True)
    a = tkern.ota_receive_slab(words, s, u, e, **rkw)
    b = tref.ota_receive_ref(words, s, u, e, **rkw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (tkern.ota_transmit_slab.launches,
            tkern.ota_receive_slab.launches) == before


def test_wrapper_refusals_and_checks():
    grads, h, r, _ = (torch.from_numpy(x) for x in _tx_inputs(9))
    # the f32 transmit (ported with the streamed axis) is the plain sum
    # here, and streams with acc= / row_chunk=; the quantizer refuses both
    assert torch.equal(tkern.ota_transmit_slab(grads, h),
                       tref.ota_transmit_ref(grads, h))
    with pytest.raises(ValueError, match="quantize=True cannot stream"):
        tkern.ota_transmit_slab(grads, h, quantize=True, r=r,
                                acc=torch.zeros(D))
    assert tref.ota_transmit_ref(grads, h, row_chunk=2).shape == (D,)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tkern.ota_transmit_slab(grads, h, quantize=True, sr_seed=3)
    with pytest.raises(ValueError, match="EITHER"):
        tkern.ota_transmit_slab(grads, h, quantize=True, r=r, sr_seed=3)
    with pytest.raises(ValueError, match="needs r"):
        tkern.ota_transmit_slab(grads, h, quantize=True)
    with pytest.raises(ValueError, match="multiple of 128"):
        tkern.ota_transmit_slab(grads[:, :100], h, quantize=True,
                                stochastic=False)
    with pytest.raises(ValueError, match="zero_fold"):
        tkern.ota_transmit_slab(grads, h, quantize=True, r=r, zero_fold=True)
    q, s, u, e = (torch.from_numpy(x) for x in _rx_inputs(10, 1, "int8"))
    with pytest.raises(ValueError, match="payload must be"):
        tkern.ota_receive_slab(q, s, u, e, alpha=1.5, scale=0.1,
                               packed="fold")
    with pytest.raises(ValueError, match="unknown packed"):
        tkern.ota_receive_slab(q, s, u, e, alpha=1.5, scale=0.1,
                               packed="nibble")
    m = torch.empty((1, D), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tkern.ota_receive_slab(m, torch.empty((1, D // 128), device="meta"),
                               torch.empty(D, device="meta"),
                               torch.empty(D, device="meta"), alpha=1.5,
                               scale=0.1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tkern.ota_transmit_slab(torch.empty((2, D), device="meta"),
                                torch.empty(2, device="meta"), quantize=True,
                                stochastic=False)
