"""``remat`` (``models/transformer.py:stack_apply``'s ``_Remat``, the
twin of ``jax.checkpoint``) against the JAX package and against the
port's plain stack, on the CPU.

* ``loss_fn`` and its gradients with ``remat=True`` in both packages,
  one arch of each family, at the family tiers of
  ``tests/_torch_family.py`` (f32: loss 1e-5, each leaf 1e-4 of its
  scale; bf16 3e-2, with the bf16 exceptions the family tests name);
* remat on against off in the port under ``vmap(grad)``: bitwise,
  except two families held at 1e-6 (f32) and 2^-8 (bf16) of the largest
  gradient entry (a key bias's gradient is zero in exact arithmetic, so
  per leaf its noise is all there is). Whisper, whose encoder output is
  read by every decoder layer: under remat each layer's share of its
  gradient comes back from its own backward and they are summed in
  another order (measured 9.3e-9 in f32, 9.3e-6 in bf16). The MoE: the
  recompute's batched dispatch (``index_put(accumulate=True)``) sums a
  slot's duplicates in an order that depends on the CPU's threads
  (bitwise with one thread or torch's deterministic algorithms; 1.5e-8
  of a 1.03 largest entry at 4 clients, bitwise at the 2 of the
  family test);
* a 3-round tiny slab trajectory with remat equal to one without.
"""

import dataclasses
import weakref

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as pytree_leaves

import _torch_family as fam
from repro_torch import configs as tconfigs
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                 run_rounds_slab)
from repro_torch.core.slab import tree_flatten
from repro_torch.core.slab_state import init_train_state
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model

# one arch of each of the seven families
FAMILIES = {"dense": "qwen3-14b", "moe": "qwen3-moe-235b-a22b",
            "mla": "minicpm3-4b", "rwkv": "rwkv6-7b", "hybrid": "hymba-1.5b",
            "vlm": "llama-3.2-vision-11b", "encdec": "whisper-medium"}
# remat on against off not bitwise (module docstring)
NOT_BITWISE = ("encdec", "moe")
# the bf16 exceptions of the family tests (tests/_torch_family.py), held
# on those tests' JAX-initialised parameters
JAX_INIT_BF16 = ("rwkv", "vlm")
# the bf16 exceptions of the family tests (tests/_torch_family.py)
BF16_OPTIONS = {"rwkv": dict(bf16_vs_jax=False),
                "vlm": dict(held_to_f32=("['x_gate']", "['x_mlp_gate']"))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_loss_and_gradients_match_jax(family, dtype, monkeypatch):
    """loss_fn and its gradients with remat=True in both packages (JAX's
    jax.checkpoint in every stack_apply, the port's _Remat); the
    training forward never reaches B5. The port's init is carried to JAX
    (no JAX init to wait for), but for the bf16 exceptions' families,
    which take the family tests' parameters (JAX's init, seed 3), on
    which those exceptions were measured."""
    def refuse(*args, **kwargs):
        raise AssertionError("loss_fn called flash_attention")
    monkeypatch.setattr(tattn, "flash_attention", refuse)
    options = BF16_OPTIONS.get(family, {}) if dtype == "bfloat16" else {}
    fam.check_loss_and_gradients(FAMILIES[family], dtype, remat=True,
                                 port_init=family not in JAX_INIT_BF16
                                 or dtype == "float32", **options)


def _client_grads(arch, dtype, remat):
    """The port's per-client gradients and losses under
    vmap(grad_and_value(loss_fn)), 2 clients x 2 x 16 tokens (+ the
    family's embeddings), the vlm gates opened."""
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), param_dtype=dtype,
                              remat=remat)
    model = build_model(cfg)
    params = model.init(seed=3, device="cpu")
    for k, v in fam.VLM_GATES.items():
        if k in params.get("blocks", {}):
            params["blocks"][k].fill_(v)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 2, 16))
    batch = fam.tbatch(toks, fam.family_inputs(cfg, (2, 2)))
    return vmap(grad_and_value(model.loss_fn), in_dims=(None, 0))(params,
                                                                  batch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_equals_the_plain_stack_under_vmap(family, dtype):
    """remat on against off in the port: bitwise, but Whisper's and the
    MoE's within 1e-6 (f32) or 2^-8 (bf16, measured 4.2e-5) of the
    largest gradient entry (module docstring). Whisper's encoder and the vlm's cross
    branch get nonzero gradients, equal with and without remat: the
    encoder's output and the image tokens are inputs of every layer's
    recomputation, not tensors it closes over."""
    arch = FAMILIES[family]
    (g0, l0), (g1, l1) = (_client_grads(arch, dtype, r) for r in (False,
                                                                   True))
    assert torch.equal(l0, l1)
    top = max(float(a.float().abs().max()) for a in tree_flatten(g0)[0])
    tier = 1e-6 if dtype == "float32" else 2 ** -8     # bf16's unit
    for (path, a), b in zip(_paths(g0), tree_flatten(g1)[0]):
        if family in NOT_BITWISE:
            err = float((a.float() - b.float()).abs().max())
            assert err <= tier * top, (path, err, top)
        else:
            assert torch.equal(a, b), path
    if family in ("encdec", "vlm"):
        key = "enc_blocks" if family == "encdec" else "blocks"
        for path, a in _paths(g1[key]):
            if (path.endswith("wk.bias")      # zero in exact arithmetic
                    or (family == "vlm" and ("selfs" in path
                                             or "gate" in path))):
                continue
            assert bool((a.float().abs().sum(
                dim=tuple(range(1, a.dim()))) > 0).all()), path


def _paths(tree, prefix=""):
    """(path, leaf) in tree_flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        f"{prefix}.{k}")]
    return [(prefix, tree)]


def test_remat_forward_takes_the_training_products(monkeypatch):
    """Inside the remat Function's forward under vmap(grad) the MoE's
    expert products see a torch.func transform, so they multiply the
    operands cast to f32 (the training product) and never the inference
    call; B5 is never reached."""
    seen = []
    real = tmoe._expert_product

    def spy(a, b):
        seen.append(a.requires_grad or tmoe._under_transform(a))
        return real(a, b)

    monkeypatch.setattr(tmoe, "_expert_product", spy)
    calls = fam.counting_flash(monkeypatch)
    _client_grads("qwen3-moe-235b-a22b", "bfloat16", True)
    assert seen and all(seen)
    assert calls == []


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen3-moe-235b-a22b"])
def test_tiny_slab_trajectory_with_remat_equals_without(arch):
    """3 rounds of the tiny preset in f32 (adam_ota, f32 wire, 4 clients
    under vmap, TorchDraws): remat on gives the same losses and state
    (bitwise, Whisper's and the MoE's at 1e-6: module docstring)."""
    n, batch, seq, rounds = 4, 2, 16, 3
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tconfigs.preset_config(arch, "tiny"),
                                  param_dtype="float32", remat=remat)
        model = build_model(cfg)
        ad = AdaptiveConfig(optimizer="adam_ota", lr=0.02, beta2=0.3)
        ch = OTAChannelConfig()
        state = init_train_state(ad, model.init(seed=0, device="cpu"),
                                 device="cpu")
        draws = TorchDraws(ch, state.spec, n, seed=1, device="cpu")
        rng = np.random.default_rng(4)
        batches = [fam.tbatch(rng.integers(0, cfg.vocab, (n, batch, seq)),
                              fam.family_inputs(cfg, (n, batch), seed=t))
                   for t in range(rounds)]
        run = make_slab_round_runner(model.loss_fn, ch, ad, FLConfig(
            n_clients=n), device="cpu")
        out.append(run_rounds_slab(run, state, draws, batches.__getitem__,
                                   rounds, chunk=1))
    (s0, h0), (s1, h1) = out
    tol = 1e-6 if cfg.family in NOT_BITWISE else 0.0
    np.testing.assert_allclose([h["loss"] for h in h1],
                               [h["loss"] for h in h0], rtol=tol, atol=0)
    for a, b in zip((s0.w, *s0.opt), (s1.w, *s1.opt)):
        if tol:
            fam.scaled_close(b, a, tol, "state slab")
        else:
            assert torch.equal(a, b)


def _toy_stack(n_layers=3, d=8):
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(n_layers, d, d, generator=g) / d ** 0.5}


def _toy_block(record):
    def block(p, x, scale):
        record.append(torch.is_grad_enabled())
        h = torch.tanh(x @ p["w"]) * scale
        return x + h, (h ** 2).mean()
    return block


def test_remat_forward_records_nothing():
    """Under vmap(grad) each layer's first call (the Function's forward)
    runs with grad off, so it keeps no activation for a backward; the
    second (the backward's recompute under vjp) with grad on. The values
    and gradients equal the plain stack's, the extra tensor's included."""
    from repro_torch.models import transformer as ttfm

    def loss(params, x, scale, remat, record):
        y, aux = ttfm.stack_apply(_toy_block(record), params, x,
                                  torch.zeros(()), extras=(scale,),
                                  remat=remat)
        return (y ** 2).mean() + aux

    params = _toy_stack()
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(1))
    scale = torch.tensor(0.7)
    out = {}
    for remat in (False, True):
        record = []
        out[remat] = vmap(grad_and_value(
            lambda p, xx, s: loss(p, xx, s, remat, record), argnums=(0, 2)),
            in_dims=(None, 0, None))(params, x, scale)
        if remat:
            assert record == [False] * 3 + [True] * 3
    (g0, l0), (g1, l1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert torch.equal(g0[0]["w"], g1[0]["w"]) and torch.equal(g0[1], g1[1])


class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops made and that are still alive,
    and their peak: a CPU measure of what a computation holds."""

    def __init__(self):
        super().__init__()
        self.refs, self.size, self.live, self.peak = {}, {}, 0, 0

    def _drop(self, key):
        self.refs[key] -= 1
        if not self.refs[key]:
            self.live -= self.size.pop(key)
            del self.refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out)[0]:
            if torch.is_tensor(t):
                key = t.untyped_storage().data_ptr()
                if key not in self.refs:
                    self.refs[key] = 0
                    self.size[key] = t.untyped_storage().nbytes()
                    self.live += self.size[key]
                self.refs[key] += 1
                weakref.finalize(t, self._drop, key)
        self.peak = max(self.peak, self.live)
        return out


def test_remat_holds_a_fraction_of_the_plain_stacks_memory():
    """vmap(grad) over 2 clients of an 8-layer stack whose layers make
    (2, 512, 1024) f32 intermediates: with remat the peak of live bytes
    is under a third of the plain stack's (measured 140 against 522 MB
    at twice this size): the forward keeps only each layer's input, and
    each recomputed layer is freed once its backward is done (the vjp's
    gradients detached from the graph it records)."""
    from repro_torch.models import transformer as ttfm

    g = torch.Generator().manual_seed(0)
    params = {"w1": torch.randn(8, 256, 1024, generator=g) / 16,
              "w2": torch.randn(8, 1024, 256, generator=g) / 32}
    x = torch.randn(2, 2, 512, 256, generator=g)

    def block(p, h):
        return h + torch.tanh(h @ p["w1"]) @ p["w2"], torch.zeros(())

    peak = {}
    for remat in (False, True):
        def loss(p, xx):
            y, _ = ttfm.stack_apply(block, p, xx, remat=remat)
            return (y ** 2).mean()

        with _LiveBytes() as live:
            vmap(grad_and_value(loss), in_dims=(None, 0))(params, x)
        peak[remat] = live.peak
    assert peak[True] < peak[False] / 3, peak
