"""Federated-learning rounds on the resident slab engine (Algorithm 1).

PyTorch counterpart of the slab-resident path of ``repro.core.fl``. Each
round:

    1. broadcasts the weight slab as a parameter dict (views of the slab);
    2. computes every client's gradient with
       ``torch.func.vmap(torch.func.grad_and_value(loss_fn))``
       (the twin of ``jax.vmap(jax.value_and_grad)``), or a FedAvg-style
       pseudo-gradient from k local SGD steps;
    3. runs ONE fused ``ota_channel_slab`` launch (the MAC);
    4. runs ONE fused ``adaptive_update_slab`` launch (the server update)
       on the resident state slabs.

The round takes its random draws as ``RoundDraws`` instead of a PRNG key
(``repro_torch.core.draws``). ``make_slab_round_runner`` drives R rounds
as a host loop (the JAX package scans them), and ``run_rounds_slab`` is
the host driver over chunks of rounds.

Configurations this slice does not cover raise ``NotImplementedError``
naming the ROADMAP item that brings them; none silently degrades.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.adaptive import (AdaptiveConfig, slab_update_slabs,
                                       state_slab_rows)
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import RoundDraws
from repro_torch.core.ota import ota_aggregate_slab
from repro_torch.core.slab import slab_to_tree, tree_map, tree_to_slab
from repro_torch.core.slab_state import SlabTrainState
from repro_torch.device import DeviceLike, resolve_device

PyTree = Any
LossFn = Callable[[PyTree, Any], torch.Tensor]   # (params, batch) -> scalar


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Fields, defaults and checks as in ``repro.core.fl.FLConfig``. The
    port's round covers the resident configuration; the streamed and
    participating fields (``client_chunk``, ``sample_rate < 1``,
    ``client_weights``, ``double_buffer``) are refused by the round
    until ROADMAP item A9 ports them."""

    n_clients: int = 50
    local_steps: int = 1          # k; 1 == Algorithm 1 (one grad per round)
    local_lr: float = 0.05        # local SGD lr when local_steps > 1
    client_chunk: Optional[int] = None
    sample_rate: float = 1.0
    client_weights: Optional[Tuple[float, ...]] = None
    double_buffer: bool = False

    def __post_init__(self):
        if not 0.0 < self.sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in (0, 1], got "
                             f"{self.sample_rate}; a rate of 0 means no "
                             "client ever participates (every round would "
                             "be a dead round)")
        if self.client_chunk is not None and self.client_chunk < 1:
            raise ValueError(f"client_chunk must be >= 1, got "
                             f"{self.client_chunk}")
        if self.double_buffer and self.client_chunk is None:
            raise ValueError(
                "double_buffer pipelines the STREAMED client scan; set "
                "client_chunk (the resident round has no chunk schedule "
                "to double-buffer)")
        if self.client_weights is not None:
            w = tuple(float(x) for x in self.client_weights)
            if len(w) != self.n_clients:
                raise ValueError(f"client_weights must have one entry per "
                                 f"client: got {len(w)} for "
                                 f"{self.n_clients} clients")
            if not all(math.isfinite(x) and x >= 0.0 for x in w):
                raise ValueError("client_weights must be finite and >= 0")
            if sum(w) <= 0.0:
                raise ValueError("client_weights must sum to > 0")
            object.__setattr__(self, "client_weights", w)

    @property
    def dynamic_norm(self) -> bool:
        return self.sample_rate < 1.0 or self.client_weights is not None

    @property
    def dynamic_round(self) -> bool:
        return self.client_chunk is not None or self.dynamic_norm


class RoundMetrics(NamedTuple):
    loss: torch.Tensor             # mean client loss before the update
    grad_norm: torch.Tensor        # L2 norm of the clean aggregated gradient
    noisy_grad_norm: torch.Tensor  # L2 norm of g_t after the channel
    fading_mean: torch.Tensor      # mean of this round's h draw
    alpha_hat: torch.Tensor        # the tail index the server update used
    n_participants: torch.Tensor   # f32 count of clients in the aggregate


def _client_update(loss_fn: LossFn, fl_cfg: FLConfig
                   ) -> Callable[[PyTree, Any], Tuple[PyTree, torch.Tensor]]:
    """Build CLIENTUPDATE: (params, client_batch) -> (grad-like, loss)."""

    if fl_cfg.local_steps == 1:
        def one(params, batch):
            return grad_and_value(loss_fn)(params, batch)
        return one

    def multi(params, batches):
        # batches: leaves with a leading axis k (one micro-batch per step).
        w, losses = params, []
        for i in range(fl_cfg.local_steps):
            g, loss = grad_and_value(loss_fn)(
                w, tree_map(lambda x: x[i], batches))
            w = tree_map(lambda p, gi: p - fl_cfg.local_lr * gi, w, g)
            losses.append(loss)
        denom = fl_cfg.local_lr * fl_cfg.local_steps
        pseudo = tree_map(lambda a, b: (a - b) / denom, params, w)
        # Mean over the k local steps, as the JAX package reports it.
        return pseudo, torch.mean(torch.stack(losses))

    return multi


def _check_covered(channel_cfg: OTAChannelConfig,
                   adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig,
                   backend: Optional[str], batch_gen) -> None:
    """Refuse every configuration this slice does not port yet."""
    if backend == "pallas_sharded":
        raise NotImplementedError(
            'backend="pallas_sharded" (the sharded engine) is not ported '
            "yet: ROADMAP item A12")
    if backend is not None:
        raise ValueError(f"backend={backend!r}: the port has no backend "
                         "switch; the device decides")
    if channel_cfg.uplink.quantized:
        raise NotImplementedError(
            f"uplink={channel_cfg.uplink.mode!r} (quantized wire) is not "
            "ported yet: ROADMAP item A8")
    if channel_cfg.downlink != "f32":
        raise NotImplementedError(
            f"downlink={channel_cfg.downlink!r} (quantized broadcast) is "
            "not ported yet: ROADMAP item A8")
    if channel_cfg.comm_buckets > 1:
        raise NotImplementedError(
            "comm_buckets > 1 (bucketed MAC collectives of the sharded "
            "engine) is not ported yet: ROADMAP item A12")
    if adaptive_cfg.track_alpha:
        raise NotImplementedError(
            'alpha="auto" (the closed tail-index loop) is not ported yet: '
            "ROADMAP item A7")
    if fl_cfg.dynamic_round or batch_gen is not None:
        raise NotImplementedError(
            "client_chunk / sample_rate < 1 / client_weights / batch_gen "
            "(the streamed client axis) are not ported yet: ROADMAP item A9")
    state_slab_rows(adaptive_cfg)    # unknown optimizer names raise here


def make_slab_round_step(loss_fn: LossFn, channel_cfg: OTAChannelConfig,
                         adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig,
                         device: DeviceLike = None,
                         backend: Optional[str] = None, batch_gen=None):
    """Slab-resident ADOTA round on ``device`` (default: the card).

    Returns ``step(state, draws, client_batches) -> (state, metrics)``:
    ``state`` a ``SlabTrainState`` on the device, ``draws`` the round's
    ``RoundDraws``, ``client_batches`` leaves shaped (N, ...) for
    ``local_steps == 1`` and (N, k, ...) otherwise (numpy arrays or
    tensors). Per round the only pytree materialised is the parameter
    view the clients consume; the optimizer state never leaves slab form.
    """
    _check_covered(channel_cfg, adaptive_cfg, fl_cfg, backend, batch_gen)
    dev = resolve_device(device)
    client_fn = vmap(_client_update(loss_fn, fl_cfg), in_dims=(None, 0))
    alpha_metric = float(adaptive_cfg.alpha)
    n_metric = float(fl_cfg.n_clients)

    def step(state: SlabTrainState, draws: RoundDraws, client_batches):
        if state.w.device != dev:
            raise ValueError(f"state lives on {state.w.device}, the round "
                             f"on {dev}")
        spec = state.spec
        batches = tree_map(lambda x: torch.as_tensor(x, device=dev),
                           client_batches)
        # Model broadcast: the one pytree the round materialises.
        params = slab_to_tree(spec, state.w)
        grads, losses = client_fn(params, batches)
        # Kernel launch 1: fused fading reduction + interference.
        g_slab, h, grads_slab, _, _ = ota_aggregate_slab(
            draws.to(dev), channel_cfg, grads, spec)
        w_in = state.w
        if any(dt != torch.float32 for dt in spec.dtypes):
            # Non-f32 leaves round-trip through their storage dtype each
            # round, as in the JAX package.
            w_in = tree_to_slab(spec, params)
        # Kernel launch 2: fused server update on the resident slabs.
        new_opt, w_new = slab_update_slabs(adaptive_cfg, g_slab, state.opt,
                                           w_in)
        metrics = RoundMetrics(
            loss=torch.mean(losses),
            grad_norm=torch.sqrt(torch.sum(torch.square(
                torch.mean(grads_slab, dim=0)))),
            noisy_grad_norm=torch.sqrt(torch.sum(torch.square(g_slab))),
            fading_mean=torch.mean(h),
            alpha_hat=torch.tensor(alpha_metric, dtype=torch.float32,
                                   device=dev),
            n_participants=torch.tensor(n_metric, dtype=torch.float32,
                                        device=dev),
        )
        return SlabTrainState(state.step + 1, w_new, new_opt,
                              state.alpha_hat, spec, state.ef), metrics

    return step


def make_slab_round_runner(loss_fn: LossFn, channel_cfg: OTAChannelConfig,
                           adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig,
                           device: DeviceLike = None,
                           backend: Optional[str] = None, batch_gen=None):
    """R rounds as a host loop over the resident state.

    Returns ``run(state, draws, client_batches) -> (state, metrics)``
    with ``draws`` a sequence of R ``RoundDraws`` and ``client_batches``
    leaves shaped (R, N, ...); metrics come back stacked (R,).
    """
    step = make_slab_round_step(loss_fn, channel_cfg, adaptive_cfg, fl_cfg,
                                device=device, backend=backend,
                                batch_gen=batch_gen)

    def run(state: SlabTrainState, draws: Sequence[RoundDraws],
            client_batches):
        ms: List[RoundMetrics] = []
        for r in range(len(draws)):
            state, m = step(state, draws[r],
                            tree_map(lambda x: x[r], client_batches))
            ms.append(m)
        return state, RoundMetrics(*(torch.stack(f) for f in zip(*ms)))

    return run


def _log_round(log, t: int, rec: dict) -> None:
    """One history record, formatted as the JAX drivers do."""
    log(f"round {t+1:5d}  loss {rec['loss']:.4f}  "
        f"|g| {rec['grad_norm']:.3e}  |g_t| {rec['noisy_grad_norm']:.3e}"
        + (f"  acc {rec.get('accuracy', float('nan')):.4f}"
           if 'accuracy' in rec else ""))


def _stack(*xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack(xs)


def run_rounds_slab(run_chunk, state: SlabTrainState,
                    draws_fn: Callable[[int], RoundDraws],
                    batch_fn: Callable[[int], PyTree], n_rounds: int,
                    chunk: int = 8, eval_fn: Optional[Callable] = None,
                    eval_every: int = 0, log_every: int = 0, log=print):
    """Host driver over ``run_chunk`` (from ``make_slab_round_runner``).

    Rounds are dispatched in chunks of up to ``chunk``. Round t takes
    ``draws_fn(t)`` and ``batch_fn(t)``: both keyed by the ABSOLUTE round
    index, the port's form of the JAX driver's ``key_fn``. Eval (on the
    parameter dict) happens only at chunk boundaries; chunks are clipped
    so every ``eval_every`` multiple is one. Returns ``(state, history)``
    with one dict per round, as the JAX driver returns.
    """
    history = []
    t = 0
    while t < n_rounds:
        r = min(chunk, n_rounds - t)
        if eval_every:
            r = min(r, eval_every - t % eval_every)
        draws = [draws_fn(t + i) for i in range(r)]
        batches = tree_map(_stack, *[batch_fn(t + i) for i in range(r)])
        state, ms = run_chunk(state, draws, batches)
        cols = {k: getattr(ms, k).tolist() for k in
                ("loss", "grad_norm", "noisy_grad_norm", "alpha_hat",
                 "n_participants")}
        for i in range(r):
            history.append({"round": t + i,
                            **{k: float(v[i]) for k, v in cols.items()}})
        t += r
        if eval_fn is not None and eval_every and t % eval_every == 0:
            history[-1].update(eval_fn(slab_to_tree(state.spec, state.w)))
        if log_every:
            for i in range(t - r, t):
                if (i + 1) % log_every == 0:
                    _log_round(log, i, history[i])
    return state, history
