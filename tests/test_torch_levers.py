"""The training forward's attention levers against the JAX package, on
the CPU: ``kv_chunk`` and ``window_block`` in
``models/attention.py:attend`` (``remat``: ``tests/test_torch_remat.py``).

Inputs come from numpy seeds; parameters are carried across bitwise
(``repro_torch.convert``). Tiers:

* ``attend`` with a lever against JAX's ``attend`` with the same lever
  (its ``_attend_chunked`` / ``_attend_window_blocked``): 1e-6 of the
  output's scale in f32 (another library's exp and sums), 3e-2 in bf16
  (the output rounded to bf16 in both: a few bf16 ulps); the branch
  taken is the one JAX's conditions pick;
* the model twins of ``tests/test_perf_options.py`` (window_block,
  kv_chunk, decode consistency with both levers and ``ssm_chunk``), each
  held against JAX's logits, loss and gradients at the family tiers of
  ``tests/_torch_family.py`` (f32 1e-4, loss 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

import _torch_family as fam
from _torch_ref import to_np
from repro.models import attention as jattn
from repro_torch.core.slab import tree_flatten
from repro_torch.models import attention as tattn

# JAX's attend compiled whole: its eager call compiles op by op (4 x the
# time of one jit)
_jattend = jax.jit(jattn.attend, static_argnums=(5, 6),
                   static_argnames=("kv_chunk", "window_block"))


def _inputs(b, sq, sk, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]


def _scaled_err(got, want):
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _spy(monkeypatch, name):
    """Wrap ``models.attention.<name>`` to count its calls."""
    calls = []
    real = getattr(tattn, name)

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tattn, name, counted)
    return calls


# --------------------------------------------------------------------------
# attend


CHUNK_CASES = {
    # name: (Sq, Sk, chunk, window, causal, query heads per kv head,
    #        k_valid, dtype)
    "ragged-causal-gqa1": (37, 37, 8, None, True, 1, False, "float32"),
    "ragged-window-gqa2": (37, 37, 8, 12, True, 2, False, "float32"),
    "ragged-bidirectional-gqa4": (37, 37, 16, None, False, 4, False,
                                  "float32"),
    "even-window-not-causal": (40, 40, 8, 12, False, 2, False, "float32"),
    "kvalid-decode": (1, 37, 8, None, True, 2, True, "float32"),
    "kvalid-window-decode-even": (1, 40, 8, 12, True, 1, True, "float32"),
    "cross": (9, 37, 8, None, False, 4, False, "float32"),
    "one-chunk": (8, 8, 8, None, True, 2, False, "float32"),
    "ragged-causal-gqa2-bf16": (37, 37, 8, None, True, 2, False, "bfloat16"),
    "kvalid-window-decode-bf16": (1, 37, 8, 12, True, 4, True, "bfloat16"),
}


@pytest.mark.parametrize("name", sorted(CHUNK_CASES))
def test_attend_kv_chunk_matches_jax(name, monkeypatch):
    sq, sk, chunk, window, causal, g, valid, dtype = CHUNK_CASES[name]
    q, k, v = _inputs(2, sq, sk, 4, 4 // g, 16)
    qp = np.arange(sk - sq, sk, dtype=np.int32)
    kp = np.arange(sk, dtype=np.int32)
    kv = None
    if valid:
        kv = np.random.default_rng(1).random((2, sk)) > 0.3
        kv[:, 0] = True                  # every row sees a key
    jdt = jnp.dtype(dtype)
    want = _jattend(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                    jnp.asarray(qp), jnp.asarray(kp), causal, window,
                    k_valid=None if kv is None else jnp.asarray(kv),
                    kv_chunk=chunk)
    calls = _spy(monkeypatch, "_attend_chunked")
    tdt = getattr(torch, dtype)
    got = tattn.attend(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                       torch.from_numpy(qp), torch.from_numpy(kp), causal,
                       window, k_valid=None if kv is None else
                       torch.from_numpy(kv), kv_chunk=chunk)
    assert len(calls) == (1 if sk > chunk else 0)     # JAX's condition
    assert got.dtype == tdt
    assert _scaled_err(got, want) <= (1e-6 if dtype == "float32" else 3e-2)


# name: (S, window, query heads per kv head, dtype); S <= 2W falls back
# to the plain path, as in JAX
WINDOW_CASES = {"ragged": (45, 8, 2, "float32"),
                "even-gqa4": (48, 8, 4, "float32"),
                "just-past-2w": (17, 8, 2, "float32"),
                "2w-fallback": (16, 8, 2, "float32"),
                "short-fallback": (5, 8, 1, "float32"),
                "ragged-bf16": (45, 8, 2, "bfloat16")}


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_attend_window_block_matches_jax(name, monkeypatch):
    s, w, g, dtype = WINDOW_CASES[name]
    kh = 4 // g
    q, k, v = _inputs(2, s, s, 4, kh, 16, seed=3)
    pos = np.arange(s, dtype=np.int32)
    jdt = jnp.dtype(dtype)
    want = _jattend(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                    jnp.asarray(pos), jnp.asarray(pos), True, w,
                    window_block=True)
    calls = _spy(monkeypatch, "_attend_window_blocked")
    tdt = getattr(torch, dtype)
    tpos = torch.from_numpy(pos)
    got = tattn.attend(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                       tpos, tpos, True, w, window_block=True)
    assert len(calls) == (1 if s > 2 * w else 0)
    assert _scaled_err(got, want) <= (1e-6 if dtype == "float32" else 3e-2)


def test_levers_follow_jaxs_other_conditions(monkeypatch):
    """window_block needs a window, causality, Sq == Sk and no k_valid;
    kv_chunk needs Sk > kv_chunk; without positions (B5) neither acts."""
    chunked = _spy(monkeypatch, "_attend_chunked")
    blocked = _spy(monkeypatch, "_attend_window_blocked")
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 40, 40, 2, 1, 8))
    pos = torch.arange(40, dtype=torch.int32)
    tattn.attend(q, k, v, pos, pos, False, 8, window_block=True)
    tattn.attend(q, k, v, pos, pos, True, None, window_block=True)
    tattn.attend(q, k, v, pos, pos, True, 8, window_block=True,
                 k_valid=torch.ones((1, 40), dtype=torch.bool))
    tattn.attend(q[:, :5], k, v, pos[:5], pos, True, 8, window_block=True)
    tattn.attend(q, k, v, pos, pos, True, None, kv_chunk=40)
    tattn.attend(q, k, v, None, None, True, 8, kv_chunk=8,
                 window_block=True)
    assert chunked == [] and blocked == []


# --------------------------------------------------------------------------
# the model twins of tests/test_perf_options.py


def _lever_models(arch, **changes):
    """f32 smoke models of ``arch`` with ``changes`` in both packages,
    the port's parameters carried to JAX."""
    return fam.models(arch, "float32", seed=1, port_init=True, **changes)


def _check_loss_grads(jm, tm, jp, tp, toks):
    """loss_fn and its gradients, the port's through the lever, against
    JAX's with the lever."""
    jv, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, {"tokens": jnp.asarray(toks)})
    tg, tv = grad_and_value(tm.loss_fn)(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    for i, (a, b) in enumerate(zip(tree_flatten(tg)[0], jax.tree.leaves(jg))):
        fam.scaled_close(a, b, 1e-4, f"gradient leaf {i}")


def test_window_block_model_matches_jax(monkeypatch):
    """starcoder2's smoke model at window 8, 40 tokens: the training
    forward takes _attend_window_blocked in every layer."""
    jm, tm, jp, tp = _lever_models("starcoder2-15b", window=8,
                                   window_block=True)
    toks = np.random.default_rng(2).integers(0, tm.config.vocab, (2, 40))
    calls = _spy(monkeypatch, "_attend_window_blocked")
    _check_loss_grads(jm, tm, jp, tp, toks.astype(np.int32))
    assert len(calls) == tm.config.n_layers


def test_kv_chunk_model_matches_jax(monkeypatch):
    """qwen3's smoke model at kv_chunk 8, 33 tokens: training and then
    decode against the cache take _attend_chunked; prefill + greedy
    decode steps against JAX's (ids equal)."""
    jm, tm, jp, tp = _lever_models("qwen3-14b", kv_chunk=8)
    toks = np.random.default_rng(2).integers(
        0, tm.config.vocab, (2, 33)).astype(np.int32)
    calls = _spy(monkeypatch, "_attend_chunked")
    _check_loss_grads(jm, tm, jp, tp, toks)
    assert len(calls) == tm.config.n_layers
    steps, length = 3, 33 + 3
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, length=length)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        length=length)
    fam.scaled_close(tl, jl, 1e-4, "prefill logits")
    decode = jax.jit(jm.decode_step)
    for i in range(steps):
        jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], -1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = decode(jp, jc, jtok, jnp.asarray(33 + i))
        tl, tc = tm.decode_step(tp, tc, ttok, 33 + i)
        fam.scaled_close(tl, jl, 1e-4, f"decode step {i} logits")
    assert len(calls) == tm.config.n_layers * (1 + steps)


def test_decode_consistency_with_both_levers():
    """hymba's smoke model with ssm_chunk 8, window_block at window 8 and
    kv_chunk 8: prefill + one decode step against forward (the JAX
    test's check), each against JAX's logits, and loss and gradients
    against JAX's. 25 tokens (the JAX test's 24 + 1): with the 8 meta
    tokens the cache then holds 41 positions, not a whole number of
    chunks, where JAX's chunked decode fails (ROADMAP C; the next
    test)."""
    jm, tm, jp, tp = _lever_models("hymba-1.5b", ssm_chunk=8, window=8,
                                   window_block=True, kv_chunk=8)
    b, s = 2, 25
    toks = np.random.default_rng(2).integers(
        0, tm.config.vocab, (b, s + 1)).astype(np.int32)
    length = s + tm.config.n_meta_tokens + 8
    tf, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    tpre, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                             length=length)
    tdec, _ = tm.decode_step(tp, cache, torch.from_numpy(toks[:, s:]), s)
    assert _scaled_err(tpre[:, 0], tf[:, s - 1]) < 2e-4
    assert _scaled_err(tdec[:, 0], tf[:, s]) < 2e-4
    jf, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    jpre, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                          length=length)
    jdec, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(toks[:, s:]),
                                      jnp.asarray(s))
    for got, want, what in ((tf, jf, "forward"), (tpre, jpre, "prefill"),
                            (tdec, jdec, "decode")):
        fam.scaled_close(got, want, 1e-4, what)
    _check_loss_grads(jm, tm, jp, tp, toks)


def test_kv_chunk_decode_at_a_whole_number_of_chunks():
    """A fault of the reference the port does not share: JAX's
    ``_attend_chunked`` reshapes decode's (1, Sk) key mask to (B, n, chunk)
    unpadded, so at batch 2 and a cache of a whole number of chunks
    (40 = 5 x 8) its decode step raises. The port's step equals JAX's
    without the lever (the same function)."""
    q, k, v = _inputs(2, 1, 40, 4, 2, 16, seed=5)
    qp, kp = np.full((1,), 39, np.int32), np.arange(40, dtype=np.int32)
    kv = np.ones((1, 40), bool)
    kv[0, 30:] = False
    args = [jnp.asarray(a) for a in (q, k, v, qp, kp[None])]
    with pytest.raises(TypeError, match="reshape"):
        jattn.attend(*args, True, None, k_valid=jnp.asarray(kv), kv_chunk=8)
    want = jattn.attend(*args, True, None, k_valid=jnp.asarray(kv))
    got = tattn.attend(*(torch.from_numpy(a) for a in (q, k, v, qp,
                                                       kp[None])),
                       True, None, k_valid=torch.from_numpy(kv), kv_chunk=8)
    assert _scaled_err(got, want) <= 1e-6
