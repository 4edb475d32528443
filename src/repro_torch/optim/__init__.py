"""Local (client-side) optimizers and learning-rate schedules.

PyTorch counterpart of ``repro.optim``. The paper's CLIENTUPDATE returns
a plain gradient, but the framework also supports multi-step local
training (FedAvg-style); these are the optimizers clients use locally,
and schedules for the server's eta. Plain functions on a pytree of
tensors (nested dicts, lists, tuples): ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)``, with the
JAX package's dtypes (moments in f32, parameters back in their own
dtype). A schedule maps a step (an int or a tensor) to a 0-dim f32
tensor.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core.slab import tree_flatten, tree_map

PyTree = Any


class LocalOpt(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], Tuple[PyTree, PyTree]]
    name: str


def _zeros_f32(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def sgd(lr: float) -> LocalOpt:
    def init(params):
        return ()

    def update(grads, state, params):
        new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return new, state

    return LocalOpt(init, update, "sgd")


def momentum(lr: float, beta: float = 0.9) -> LocalOpt:
    def update(grads, state, params):
        m = tree_map(lambda s, g: beta * s + g.float(), state, grads)
        new = tree_map(lambda p, mi: (p - lr * mi).to(p.dtype), params, m)
        return new, m

    return LocalOpt(_zeros_f32, update, "momentum")


class AdamWState(NamedTuple):
    step: torch.Tensor             # 0-dim int32
    m: PyTree
    v: PyTree


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> LocalOpt:
    def init(params):
        leaves = tree_flatten(params)[0]
        dev = leaves[0].device if leaves else None
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          _zeros_f32(params), _zeros_f32(params))

    def update(grads, state, params):
        t = state.step + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state.m, grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state.v, grads)
        bc1 = 1 - torch.pow(b1, t.float())
        bc2 = 1 - torch.pow(b2, t.float())

        def upd(p, m_, v_):
            step = lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            return (p - step - lr * weight_decay * p.float()).to(p.dtype)

        return tree_map(upd, params, m, v), AdamWState(t, m, v)

    return LocalOpt(init, update, "adamw")


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0
                    ) -> Callable[[Any], torch.Tensor]:
    def lr_at(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0, 1)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr_at


def constant_schedule(base_lr: float) -> Callable[[Any], torch.Tensor]:
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)
