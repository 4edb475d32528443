"""Layouts carry over bitwise: slabs, conversion and data.

The same parameters (the JAX package's, carried across with
``repro_torch.convert``) give bitwise-equal slabs in both packages, for
the three vision models; specs agree field for field (shard padding
included); the port's own copy of ``repro.data`` draws the same arrays
from the same seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import slab as jslab
from repro.core.adaptive import AdaptiveConfig as JAdaptiveConfig
from repro.core.slab_state import init_train_state as j_init_train_state
from repro import data as jdata
from repro.models import vision as jvision
from repro_torch import data as tdata
from repro_torch.convert import (params_from_numpy, tensor_from_numpy,
                                 train_state_from_numpy)
from repro_torch.core import slab as tslab
from repro_torch.core.adaptive import AdaptiveConfig, state_slab_rows
from repro_torch.core.slab_state import init_train_state

MODELS = {
    "logreg": lambda: jvision.logistic_regression(20, 5),
    "mlp": lambda: jvision.mlp(20, 5, hidden=16),
    "resnet_tiny": lambda: jvision.resnet_tiny(10, channels=(8, 16),
                                               blocks_per_stage=1),
}


def _jax_params(name):
    return MODELS[name]().init(jax.random.key(0))


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_slabs_bitwise_equal_across_packages(name, shards):
    jp = _jax_params(name)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jspec = jslab.make_slab_spec(jp, shards=shards)
    tspec = tslab.make_slab_spec(tp, shards=shards)
    for f in ("shapes", "offsets", "sizes", "total", "padded", "shards",
              "shard_len", "n_leaves"):
        assert getattr(tspec, f) == getattr(jspec, f), f
    assert [str(d).split(".")[-1] for d in tspec.dtypes] == \
        [str(d) for d in jspec.dtypes]
    js = np.array(jslab.tree_to_slab(jspec, jp))
    ts = tslab.tree_to_slab(tspec, tp).numpy()
    assert js.dtype == ts.dtype and np.array_equal(js, ts)
    # and back: the same leaves, bitwise
    back = tslab.slab_to_tree(tspec, torch.from_numpy(js))
    for k in jp:
        assert np.array_equal(back[k].numpy(), np.asarray(jp[k])), k


def test_leaf_order_is_jax_flatten_order():
    tree = {"b": np.ones((2,), np.float32),
            "a": {"z": np.zeros((3,), np.float32),
                  "y": [np.full((1,), 2.0, np.float32),
                        np.full((2, 2), 3.0, np.float32)]},
            "c": (np.full((4,), 4.0, np.float32),)}
    jleaves = jax.tree.leaves(tree)
    tleaves, treedef = tslab.tree_flatten(tree)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert np.array_equal(np.asarray(a), b)
    rebuilt = tslab.tree_unflatten(treedef, tleaves)
    assert jax.tree.structure(rebuilt) == jax.tree.structure(tree)
    jspec = jslab.make_slab_spec(tree)
    tt = jax.tree.map(torch.from_numpy, tree)
    tspec = tslab.make_slab_spec(tt)
    assert np.array_equal(np.asarray(jslab.tree_to_slab(jspec, tree)),
                          tslab.tree_to_slab(tspec, tt).numpy())


def test_stack_to_slab_and_bf16_leaves_bitwise():
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(3, 5, 7)).astype(np.float32),
            "b": rng.normal(size=(3, 130)).astype(np.float32)}
    one = {k: v[0] for k, v in tree.items()}
    jspec = jslab.make_slab_spec(one)
    tspec = tslab.make_slab_spec(one)
    assert np.array_equal(
        np.asarray(jslab.stack_to_slab(jspec, tree)),
        tslab.stack_to_slab(tspec, jax.tree.map(torch.from_numpy,
                                                tree)).numpy())
    # bf16 leaves: the slab is f32, the round trip restores bf16 bits
    jb = {"w": jnp.asarray(one["w"], jnp.bfloat16)}
    tb = params_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    assert tb["w"].dtype == torch.bfloat16
    jspec = jslab.make_slab_spec(jb)
    tspec = tslab.make_slab_spec(tb)
    assert tspec.dtypes == (torch.bfloat16,)
    js = np.asarray(jslab.tree_to_slab(jspec, jb))
    ts = tslab.tree_to_slab(tspec, tb).numpy()
    assert np.array_equal(js, ts)
    back = tslab.slab_to_tree(tspec, torch.from_numpy(ts))["w"]
    assert back.dtype == torch.bfloat16
    assert np.array_equal(back.view(torch.int16).numpy(),
                          np.asarray(jb["w"]).view(np.int16))
    assert tslab.zeros_slab(tspec).shape == (tspec.padded,)


def test_spec_rejects_empty_and_bad_shards():
    with pytest.raises(ValueError):
        tslab.make_slab_spec({})
    with pytest.raises(ValueError):
        tslab.make_slab_spec({"a": np.zeros(3)}, shards=0)
    spec = tslab.make_slab_spec({"a": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="structure"):
        tslab.tree_to_slab(spec, {"b": torch.zeros(3)})


@pytest.mark.parametrize("optimizer", ["adam_ota", "amsgrad_ota",
                                       "fedavgm", "fedavg"])
def test_train_state_carries_over_bitwise(optimizer):
    jp = _jax_params("mlp")
    jstate = j_init_train_state(JAdaptiveConfig(optimizer=optimizer), jp)
    rng = np.random.default_rng(1)
    # a state mid-training: random slabs with a zero tail
    spec = tslab.make_slab_spec(params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))
    tail = np.arange(spec.padded) >= spec.total
    opt = [np.where(tail, 0, rng.random(spec.padded)).astype(np.float32)
           for _ in jstate.opt]
    assert len(opt) == len(state_slab_rows(AdaptiveConfig(
        optimizer=optimizer)))
    st = train_state_from_numpy(spec, step=np.asarray(jstate.step) + 4,
                                w=np.asarray(jstate.w), opt=opt,
                                alpha_hat=np.float32(1.7), device="cpu")
    assert int(st.step) == 4 and st.step.dtype == torch.int32
    assert np.array_equal(st.w.numpy(), np.asarray(jstate.w))
    for a, b in zip(st.opt, opt):
        assert np.array_equal(a.numpy(), b)
    assert float(st.alpha_hat) == np.float32(1.7)
    fresh = init_train_state(AdaptiveConfig(optimizer=optimizer),
                             params_from_numpy(jax.tree.map(np.asarray, jp),
                                               "cpu"), device="cpu")
    assert np.array_equal(fresh.w.numpy(), np.asarray(jstate.w))
    assert len(fresh.opt) == len(jstate.opt)
    assert all(not o.any() for o in fresh.opt)
    with pytest.raises(ValueError, match="float32"):
        train_state_from_numpy(spec, step=0, w=np.zeros(3, np.float32),
                               opt=[], alpha_hat=0.0, device="cpu")


def test_tensor_from_numpy_keeps_dtype_and_bits():
    x = np.arange(6, dtype=np.int64).reshape(2, 3)
    t = tensor_from_numpy(x, "cpu")
    assert t.dtype == torch.int64 and np.array_equal(t.numpy(), x)
    x[0, 0] = 99                               # a copy, not a view
    assert int(t[0, 0]) == 0


@pytest.mark.parametrize("kind", ["gaussian_mixture", "synthetic_images",
                                  "token_stream", "lm_batches"])
def test_data_copy_draws_the_same_arrays(kind):
    if kind == "gaussian_mixture":
        a = jdata.gaussian_mixture(300, 6, 4, seed=3)
        b = tdata.gaussian_mixture(300, 6, 4, seed=3)
        pairs = [(a.x, b.x), (a.y, b.y)]
    elif kind == "synthetic_images":
        a = jdata.synthetic_images(50, 32, seed=2)
        b = tdata.synthetic_images(50, 32, seed=2)
        pairs = [(a.x, b.x), (a.y, b.y)]
    elif kind == "token_stream":
        pairs = [(jdata.token_stream(500, 64, seed=1),
                  tdata.token_stream(500, 64, seed=1))]
    else:
        toks = tdata.token_stream(500, 64, seed=1)
        pairs = [(jdata.lm_batches(toks, 3, 8, 2, seed=4),
                  tdata.lm_batches(toks, 3, 8, 2, seed=4))]
    for x, y in pairs:
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("dir_alpha", [None, 0.1])
@pytest.mark.parametrize("local_steps", [1, 2])
def test_federated_batcher_copy_matches(dir_alpha, local_steps):
    data = jdata.synthetic_images(200, 8, seed=0)
    a = jdata.FederatedBatcher(data, 5, 4, dir_alpha=dir_alpha,
                               local_steps=local_steps, seed=3)
    b = tdata.FederatedBatcher(data, 5, 4, dir_alpha=dir_alpha,
                               local_steps=local_steps, seed=3)
    assert a.heterogeneity() == b.heterogeneity()
    for t in range(3):
        ba, bb = a(t), b(t)
        for k in ("x", "y"):
            assert np.array_equal(ba[k], bb[k])
    parts_a = jdata.dirichlet_partition(data.y, 7, 0.3, seed=2)
    parts_b = tdata.dirichlet_partition(data.y, 7, 0.3, seed=2)
    assert all(np.array_equal(p, q) for p, q in zip(parts_a, parts_b))
    assert all(np.array_equal(p, q) for p, q in
               zip(jdata.iid_partition(50, 4, 1), tdata.iid_partition(50, 4,
                                                                      1)))
