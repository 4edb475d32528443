"""The paper's own experiment models, as functions over a parameter dict.

PyTorch counterpart of ``repro.models.vision``: logistic regression (the
paper's convex task), an MLP, and "ResNet-tiny" (conv stem, 2-conv
residual blocks with projection shortcuts, GroupNorm, global average
pool; the stand-in for ResNet-18 on CIFAR).

The models are plain functions of a parameter dict, so per-client
gradients come from ``torch.func.vmap(torch.func.grad(...))`` over the
parameters. The parameter layout is the JAX package's: conv weights are
HWIO and activations NHWC, so the slab of a model is bitwise the same in
both packages. ``predict`` permutes to NCHW / OIHW only around
``F.conv2d`` and pads "SAME" explicitly, as XLA does (asymmetric for
even strided inputs). GroupNorm is written out as ``_groupnorm`` is in
the JAX package.

``init(seed, device)`` draws from a CPU ``torch.Generator`` seeded with
``seed`` and moves the result to ``device`` (default: the card). The
values differ from the JAX package's inits (a different generator); the
parity tests carry the JAX parameters over with ``repro_torch.convert``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.slab import tree_flatten
from repro_torch.device import DeviceLike, resolve_device


class TaskModel(NamedTuple):
    init: Callable            # (seed=0, device=None) -> params dict
    loss_fn: Callable         # (params, batch{x,y}) -> scalar
    predict: Callable         # (params, x) -> logits
    name: str


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, y[..., None], dim=-1)[..., 0]
    return torch.mean(logz - gold)


def accuracy(model: TaskModel, params, x, y, batch: int = 4096) -> float:
    dev = tree_flatten(params)[0][0].device
    correct = 0
    with torch.no_grad():
        for i in range(0, len(y), batch):
            logits = model.predict(params, torch.as_tensor(x[i:i + batch],
                                                           device=dev))
            yy = torch.as_tensor(np.asarray(y[i:i + batch]), device=dev)
            correct += int(torch.sum(torch.argmax(logits, -1) == yy))
    return correct / len(y)


def logistic_regression(d: int, n_classes: int) -> TaskModel:
    def init(seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        return {"w": torch.zeros((d, n_classes), device=dev),
                "b": torch.zeros((n_classes,), device=dev)}

    def predict(p, x):
        return x @ p["w"] + p["b"]

    def loss_fn(p, batch):
        return _xent(predict(p, batch["x"]), batch["y"])

    return TaskModel(init, loss_fn, predict, "logreg")


def mlp(d: int, n_classes: int, hidden: int = 128) -> TaskModel:
    def init(seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        s1, s2 = 1 / math.sqrt(d), 1 / math.sqrt(hidden)
        p = {"w1": torch.randn((d, hidden), generator=gen) * s1,
             "b1": torch.zeros((hidden,)),
             "w2": torch.randn((hidden, n_classes), generator=gen) * s2,
             "b2": torch.zeros((n_classes,))}
        return {k: v.to(dev) for k, v in p.items()}

    def predict(p, x):
        h = torch.relu(x @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    def loss_fn(p, batch):
        return _xent(predict(p, batch["x"]), batch["y"])

    return TaskModel(init, loss_fn, predict, "mlp")


# ---------------------------------------------------------------------------
# ResNet-tiny.
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int):
    """(low, high) padding of XLA's "SAME" convolution on one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(w: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x HWIO -> NHWC "SAME" convolution."""
    kh, kw = w.shape[0], w.shape[1]
    pw = _same_pads(x.shape[2], kw, stride)
    ph = _same_pads(x.shape[1], kh, stride)
    xn = x.permute(0, 3, 1, 2)
    if any(pw + ph):
        xn = F.pad(xn, pw + ph)
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _conv_init(gen: torch.Generator, k: int, cin: int, cout: int):
    return torch.randn((k, k, cin, cout), generator=gen) * math.sqrt(
        2.0 / (k * k * cin))


def _groupnorm(scale, bias, x, groups=8, eps=1e-5):
    n, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(n, h, w, g, c // g)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = torch.square(xg - mu).mean(dim=(1, 2, 4), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(n, h, w, c) * scale + bias


def resnet_tiny(n_classes: int, channels=(16, 32, 64), blocks_per_stage=2,
                in_channels: int = 3) -> TaskModel:
    """Residual conv net with GroupNorm (no running statistics to
    aggregate across FL clients, a standard FL substitution)."""

    def init(seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        p = {"stem": _conv_init(gen, 3, in_channels, channels[0]),
             "gn0_s": torch.ones((channels[0],)),
             "gn0_b": torch.zeros((channels[0],))}
        cin = channels[0]
        for si, c in enumerate(channels):
            for bi in range(blocks_per_stage):
                pre = f"s{si}b{bi}"
                stride = 2 if (bi == 0 and si > 0) else 1
                p[pre + "_c1"] = _conv_init(gen, 3, cin, c)
                p[pre + "_g1s"], p[pre + "_g1b"] = torch.ones((c,)), torch.zeros((c,))
                p[pre + "_c2"] = _conv_init(gen, 3, c, c)
                p[pre + "_g2s"], p[pre + "_g2b"] = torch.ones((c,)), torch.zeros((c,))
                if stride != 1 or cin != c:
                    p[pre + "_proj"] = _conv_init(gen, 1, cin, c)
                cin = c
        p["head_w"] = torch.zeros((cin, n_classes))
        p["head_b"] = torch.zeros((n_classes,))
        return {k: v.to(dev) for k, v in p.items()}

    def predict(p, x):
        h = torch.relu(_groupnorm(p["gn0_s"], p["gn0_b"], _conv(p["stem"], x)))
        for si, c in enumerate(channels):
            for bi in range(blocks_per_stage):
                pre = f"s{si}b{bi}"
                stride = 2 if (bi == 0 and si > 0) else 1
                y = _conv(p[pre + "_c1"], h, stride)
                y = torch.relu(_groupnorm(p[pre + "_g1s"], p[pre + "_g1b"], y))
                y = _conv(p[pre + "_c2"], y)
                y = _groupnorm(p[pre + "_g2s"], p[pre + "_g2b"], y)
                sc = h if (pre + "_proj") not in p else _conv(p[pre + "_proj"],
                                                              h, stride)
                h = torch.relu(y + sc)
        pooled = h.mean(dim=(1, 2))
        return pooled @ p["head_w"] + p["head_b"]

    def loss_fn(p, batch):
        return _xent(predict(p, batch["x"]), batch["y"])

    return TaskModel(init, loss_fn, predict, "resnet_tiny")
