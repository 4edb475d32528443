"""Slab-resident training state: the model and optimizer state as slabs.

PyTorch counterpart of ``repro.core.slab_state``. The server update is a
pure slab computation, so the multi-round loop never leaves slab form:
``SlabTrainState`` holds the parameter slab, the optimizer-state slabs
(in ``state_slab_rows`` order), the round counter and the tail-index
telemetry, with the static ``SlabSpec`` alongside.

Pytrees appear only at the boundaries: ``pack_train_state`` /
``unpack_train_state`` convert to and from the per-round API's
``(params, ServerOptState)``, and ``spec_meta`` is the layout's
fingerprint that checkpoints carry (``repro_torch.checkpoint``), the
same dict as the JAX package's for the same parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.adaptive import (AdaptiveConfig, ServerOptState,
                                       pack_state_slabs, state_slab_rows)
from repro_torch.core.slab import (SlabSpec, make_slab_spec, slab_to_tree,
                                   tree_flatten, tree_to_slab, treedef_str,
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
    (spec.shards, spec.padded) f32 error-feedback residual rows, one per
    transmitter (the single-device round carries row 0), None without
    error feedback.
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
    slabs zero, ``alpha_hat`` at the unseeded sentinel 0.0, and with
    ``error_feedback=True`` zero (spec.shards, padded) residual rows, as
    ``repro.core.slab_state.init_train_state`` makes them."""
    dev = resolve_device(device)
    if spec is None:
        spec = make_slab_spec(params, shards=shards)
    n_rows = len(state_slab_rows(cfg))
    return SlabTrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        w=tree_to_slab(spec, params).to(dev),
        opt=tuple(zeros_slab(spec, device=dev) for _ in range(n_rows)),
        alpha_hat=torch.zeros((), dtype=torch.float32, device=dev),
        spec=spec,
        ef=(torch.zeros((spec.shards, spec.padded), dtype=torch.float32,
                        device=dev)
            if error_feedback else None))


def pack_train_state(cfg: AdaptiveConfig, spec: SlabSpec, params: PyTree,
                     state: ServerOptState,
                     alpha_hat: Optional[torch.Tensor] = None
                     ) -> SlabTrainState:
    """Boundary: flatten a ``(params, ServerOptState)`` pair into slabs on
    the parameters' device. ``alpha_hat`` defaults to the unseeded
    sentinel 0.0 (``ServerOptState`` carries no tail-index telemetry)."""
    dev = tree_flatten(params)[0][0].device
    if alpha_hat is None:
        alpha_hat = torch.zeros((), dtype=torch.float32, device=dev)
    return SlabTrainState(
        step=torch.as_tensor(state.step, dtype=torch.int32, device=dev),
        w=tree_to_slab(spec, params),
        opt=pack_state_slabs(cfg, spec, state),
        alpha_hat=torch.as_tensor(alpha_hat, dtype=torch.float32,
                                  device=dev),
        spec=spec)


def unpack_train_state(cfg: AdaptiveConfig, state: SlabTrainState
                       ) -> Tuple[PyTree, ServerOptState]:
    """Boundary: the ``(params, ServerOptState)`` pytrees (params in their
    leaf dtypes, optimizer state f32; modes that carry no delta / nu get
    the 0-dim zero placeholders of their ``init``)."""
    spec = state.spec
    rows = dict(zip(state_slab_rows(cfg), state.opt))
    zero = torch.zeros((), dtype=torch.float32, device=state.w.device)
    delta = (slab_to_tree(spec, rows["delta"], cast=False)
             if "delta" in rows else zero)
    if "vmax" in rows:
        nu = {"v": slab_to_tree(spec, rows["nu"], cast=False),
              "vmax": slab_to_tree(spec, rows["vmax"], cast=False)}
    elif "nu" in rows:
        nu = slab_to_tree(spec, rows["nu"], cast=False)
    else:
        nu = zero
    params = slab_to_tree(spec, state.w)
    return params, ServerOptState(step=state.step, delta=delta, nu=nu)


def spec_meta(spec: SlabSpec) -> dict:
    """JSON-serialisable fingerprint of a slab layout, stored beside
    checkpoints so a resume can verify that the current model gives the
    same layout. Key for key the JAX package's: numpy dtype names and
    ``jax.tree``'s treedef string. The treedef catches what the leaf
    metadata cannot: two same-shaped leaves renamed or reordered."""
    return {"total": spec.total, "padded": spec.padded,
            "shards": spec.shards,
            "shapes": [list(s) for s in spec.shapes],
            "dtypes": [str(d).removeprefix("torch.") for d in spec.dtypes],
            "offsets": list(spec.offsets),
            "treedef": treedef_str(spec.treedef)}


def check_spec_meta(spec: SlabSpec, meta: dict, where: str = "") -> None:
    """Raise if ``spec`` does not reproduce the checkpointed layout."""
    current = spec_meta(spec)
    if current != meta:
        diff = [k for k in current if current[k] != meta.get(k)]
        raise ValueError(
            f"slab layout mismatch{' in ' + where if where else ''}: "
            f"checkpoint was written with a different {'/'.join(diff)} "
            f"(ckpt {[meta.get(k) for k in diff]!r} vs current "
            f"{[current[k] for k in diff]!r}); resuming would re-pack "
            "state into a different layout")
