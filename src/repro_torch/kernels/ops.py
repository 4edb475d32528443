"""Public wrappers around the port's kernels.

PyTorch counterpart of ``repro.kernels.ops``:

* ``fused_server_update`` routes a parameter pytree through the slab
  engine (``core.slab``) and applies the fused ADOTA update in ONE
  ``adaptive_update_slab`` launch over the whole model;
* ``fused_ota_aggregate(grads, h, u, e, *, alpha, scale)`` is the fused
  OTA MAC on stacked client gradients (N, d), ``ota_channel_slab``
  itself. The JAX version draws the CMS inputs, u (d,) angles and e (d,)
  Exp(1) draws, from a key; the port takes its draws as data, so the
  caller passes them;
* ``causal_flash_attention`` is ``flash_attention`` itself, whose
  ``causal`` already defaults to True.

There is no ``jit`` and no ``interpret`` switch: the tensors' device
decides, as in every wrapper of the port.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.adaptive import (_SLAB_MODES, AdaptiveConfig,
                                       ServerOptState, apply_slab_update)
from repro_torch.core.slab import make_slab_spec, tree_to_slab
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ota_channel import ota_channel_slab

PyTree = Any

_MODE_TO_OPTIMIZER = {mode: name for name, mode in _SLAB_MODES.items()}


def fused_server_update(g: PyTree, state: ServerOptState, params: PyTree, *,
                        lr: float, beta1: float, beta2: float, alpha: float,
                        eps: float, mode: str = "adam"
                        ) -> Tuple[PyTree, ServerOptState]:
    """Kernel-fused equivalent of a server optimizer's ``.update()``: one
    ``adaptive_update_slab`` launch over the whole model slab. ``state``
    has the matching optimizer's layout (amsgrad: nu = {"v", "vmax"}).
    For ``momentum``, ``beta1`` is the server momentum coefficient."""
    if mode not in _MODE_TO_OPTIMIZER:
        raise ValueError(f"unknown update mode {mode!r}; "
                         f"options: {sorted(_MODE_TO_OPTIMIZER)}")
    cfg = AdaptiveConfig(optimizer=_MODE_TO_OPTIMIZER[mode], lr=lr,
                         beta1=beta1, beta2=beta2, alpha=alpha, eps=eps,
                         momentum=beta1)
    spec = make_slab_spec(params)
    return apply_slab_update(cfg, spec, tree_to_slab(spec, g), state, params)


fused_ota_aggregate = ota_channel_slab
causal_flash_attention = flash_attention
