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
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


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
    """
    dev = resolve_device(device)
    if ef is not None:
        raise NotImplementedError(
            "error-feedback residual rows belong to the quantized uplink, "
            "which is not ported yet: ROADMAP item A8")
    slabs = [tensor_from_numpy(x, dev) for x in (w, *opt)]
    for s in slabs:
        if tuple(s.shape) != (spec.padded,) or s.dtype != torch.float32:
            raise ValueError(f"slabs must be ({spec.padded},) float32, got "
                             f"{tuple(s.shape)} {s.dtype}")
    return SlabTrainState(
        step=tensor_from_numpy(np.asarray(step, np.int32), dev),
        w=slabs[0], opt=tuple(slabs[1:]),
        alpha_hat=tensor_from_numpy(np.asarray(alpha_hat, np.float32), dev),
        spec=spec)
