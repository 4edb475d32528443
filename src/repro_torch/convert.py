"""Carry weights and training state across from the JAX package.

The JAX package's parameters and ``SlabTrainState`` arrays, handed over
as numpy arrays (``np.asarray`` of each leaf), become the port's tensors
on ``device``. Layouts are the same in both packages (HWIO conv weights,
slab leaf order), so values move bitwise: nothing is transposed or
re-packed. bf16 leaves (numpy's ``bfloat16`` extension dtype) are carried
as their raw 16-bit words.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.slab import SlabSpec, tree_map
from repro_torch.core.slab_state import SlabTrainState
from repro_torch.device import DeviceLike, resolve_device

PyTree = Any


def tensor_from_numpy(x, device: DeviceLike = None) -> torch.Tensor:
    """One array -> a tensor on ``device`` with the same dtype and bits."""
    dev = resolve_device(device)
    # a C-ordered copy; np.ascontiguousarray would make a 0-dim leaf 1-dim
    a = np.array(x, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_numpy(tree: PyTree, device: DeviceLike = None) -> PyTree:
    """A (nested) dict of arrays -> the same dict of tensors."""
    dev = resolve_device(device)
    return tree_map(lambda x: tensor_from_numpy(x, dev), tree)


def train_state_from_numpy(spec: SlabSpec, *, step, w, opt: Sequence,
                           alpha_hat, ef: Optional[Any] = None,
                           device: DeviceLike = None) -> SlabTrainState:
    """The arrays of a JAX ``SlabTrainState`` -> the port's state.

    ``spec`` is the port's layout of the same model
    (``make_slab_spec(params)``); every slab must have its padded length.
    ``alpha_hat`` is the tracked tail-index EMA and ``ef`` the
    (spec.shards, padded) error-feedback residual rows (None without
    error feedback), so a state in the middle of a tracked or quantized
    run carries over as it stands.
    """
    dev = resolve_device(device)
    slabs = [tensor_from_numpy(x, dev) for x in (w, *opt)]
    for s in slabs:
        if tuple(s.shape) != (spec.padded,) or s.dtype != torch.float32:
            raise ValueError(f"slabs must be ({spec.padded},) float32, got "
                             f"{tuple(s.shape)} {s.dtype}")
    ef_t = None
    if ef is not None:
        ef_t = tensor_from_numpy(ef, dev)
        if (tuple(ef_t.shape) != (spec.shards, spec.padded)
                or ef_t.dtype != torch.float32):
            raise ValueError(f"ef must be ({spec.shards}, {spec.padded}) "
                             f"float32, got {tuple(ef_t.shape)} "
                             f"{ef_t.dtype}")
    return SlabTrainState(
        step=tensor_from_numpy(np.asarray(step, np.int32), dev),
        w=slabs[0], opt=tuple(slabs[1:]),
        alpha_hat=tensor_from_numpy(np.asarray(alpha_hat, np.float32), dev),
        spec=spec, ef=ef_t)
