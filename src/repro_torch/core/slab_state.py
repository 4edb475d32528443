"""Slab-resident training state: the model and optimizer state as slabs.

PyTorch counterpart of ``repro.core.slab_state``. The server update is a
pure slab computation, so the multi-round loop never leaves slab form:
``SlabTrainState`` holds the parameter slab, the optimizer-state slabs
(in ``state_slab_rows`` order), the round counter and the tail-index
telemetry, with the static ``SlabSpec`` alongside.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.adaptive import AdaptiveConfig, state_slab_rows
from repro_torch.core.slab import (SlabSpec, make_slab_spec, tree_to_slab,
                                   zeros_slab)
from repro_torch.device import DeviceLike, resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class SlabTrainState:
    """Resident training state of the slab engine.

    ``w`` is the (spec.padded,) f32 parameter slab; ``opt`` the
    optimizer-state slabs in ``state_slab_rows(cfg)`` order; ``step`` the
    int32 round counter (0-dim tensor); ``alpha_hat`` the f32 tail-index
    EMA (0.0 = not yet seeded; static-alpha configs keep 0.0); ``ef`` the
    error-feedback residual rows, None while the quantized uplink is not
    ported.
    """

    step: torch.Tensor
    w: torch.Tensor
    opt: Tuple[torch.Tensor, ...]
    alpha_hat: torch.Tensor
    spec: SlabSpec
    ef: Optional[torch.Tensor] = None


def init_train_state(cfg: AdaptiveConfig, params: PyTree,
                     spec: Optional[SlabSpec] = None, shards: int = 1,
                     error_feedback: bool = False,
                     device: DeviceLike = None) -> SlabTrainState:
    """Fresh resident state on ``device``: params packed once, optimizer
    slabs zero, ``alpha_hat`` at the unseeded sentinel 0.0."""
    dev = resolve_device(device)
    if error_feedback:
        raise NotImplementedError(
            "error-feedback residual rows belong to the quantized uplink, "
            "which is not ported yet: ROADMAP item A8")
    if spec is None:
        spec = make_slab_spec(params, shards=shards)
    n_rows = len(state_slab_rows(cfg))
    return SlabTrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        w=tree_to_slab(spec, params).to(dev),
        opt=tuple(zeros_slab(spec, device=dev) for _ in range(n_rows)),
        alpha_hat=torch.zeros((), dtype=torch.float32, device=dev),
        spec=spec)
