"""The parts of an ADOTA-FL round that the single-device engine
(``core.fl``) and the sharded one (``core.shard``) share; it imports
neither. ``FLConfig`` and ``RoundMetrics``; ``client_update``
(CLIENTUPDATE); the round's checks and inputs (``check_state``,
``round_inputs``); the server's half of a round (``storage_round_trip``,
``make_server_step``); ``round_metrics``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch.func import grad_and_value

from repro_torch import spans
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.draws import RoundDraws
from repro_torch.core.slab import (SlabSpec, slab_to_tree, tree_map,
                                   tree_to_slab)
from repro_torch.core.slab_state import SlabTrainState
from repro_torch.core.tail_index import effective_alpha, update_alpha_ema

PyTree = Any
LossFn = Callable[[PyTree, Any], torch.Tensor]   # (params, batch) -> scalar


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Fields, defaults and checks as in ``repro.core.fl.FLConfig``.

    ``client_chunk`` streams the client axis in chunks of that many
    rows; ``sample_rate < 1`` samples the participants each round (the
    mask comes with the draws); ``client_weights`` weights each client's
    contribution; ``double_buffer`` issues chunk c's client compute
    before folding chunk c-1 (needs ``client_chunk``)."""

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


def client_update(loss_fn: LossFn, fl_cfg: FLConfig
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


def check_state(state: SlabTrainState, dev: torch.device,
                use_ef: bool) -> None:
    """Refuse a state on another device than the round's, or one with no
    residual rows under error feedback."""
    if state.w.device != dev:
        raise ValueError(f"state lives on {state.w.device}, the round on "
                         f"{dev}")
    if use_ef and state.ef is None:
        shards = state.spec.shards
        raise ValueError(
            "UplinkConfig.error_feedback=True but the SlabTrainState "
            "carries no residual rows; build it with init_train_state(..., "
            + (f"shards={shards}, " if shards > 1 else "")
            + "error_feedback=True)")


def round_inputs(dev: torch.device, fl_cfg: FLConfig, draws: RoundDraws,
                 client_batches: PyTree):
    """The round's draws and batch leaves (or None) on ``dev``. A mask in
    the draws needs a streamed round config. A leaf that is not already
    on a card counts one ``spans.host_syncs`` when the round runs on one:
    the copy from the host blocks."""
    draws = draws.to(dev)
    if draws.mask is not None and not fl_cfg.dynamic_round:
        raise ValueError("draws.mask is set but the round config is "
                         "resident (FLConfig.sample_rate is 1)")

    def move(x):
        if dev.type == "cuda" and not (isinstance(x, torch.Tensor)
                                       and x.device.type == "cuda"):
            spans.host_syncs += 1
        return torch.as_tensor(x, device=dev)
    return draws, (None if client_batches is None
                   else tree_map(move, client_batches))


def fill(x: float, dev: torch.device) -> torch.Tensor:
    """A 0-dim f32 metric: a fill on the device, not a copy from the host
    (no sync)."""
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def storage_round_trip(spec: SlabSpec, params: PyTree,
                       master: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The full slab the server update reads when some leaves are not
    f32: they round-trip through their storage dtype, from the broadcast
    ``params``, or under the int8 downlink from the f32 ``master``."""
    return tree_to_slab(spec, params if master is None
                        else slab_to_tree(spec, master))


def make_server_step(adaptive_cfg: AdaptiveConfig, dev: torch.device,
                     update: Callable):
    """The server's half of a round: ``server_step(state, g, stats, w_in,
    ef_new=None, ok=None) -> (alpha_hat, alpha_metric, opt, w, ef)``, the
    next state's slabs (the engine advances ``step``).

    ``g`` is the noisy aggregate over the state's slabs (a rank's slice
    on the sharded engine), ``stats`` the (3,) pilot statistics (summed
    over the ranks), ``w_in`` the master slab the update reads,
    ``ef_new`` the fresh error-feedback residual row and ``update`` the
    engine's ``adaptive.slab_update_slabs`` (B1). Under ``alpha="auto"``
    the statistics fold into the tracked ``alpha_hat``. Where the 0-dim
    bool ``ok`` is false, nobody transmitted: the slabs carry over, selected
    on the device."""
    track = adaptive_cfg.track_alpha

    def server_step(state: SlabTrainState, g: torch.Tensor,
                    stats: Optional[torch.Tensor], w_in: torch.Tensor,
                    ef_new: Optional[torch.Tensor] = None,
                    ok: Optional[torch.Tensor] = None):
        if track:
            alpha_hat = update_alpha_ema(state.alpha_hat, stats,
                                         adaptive_cfg.alpha_ema)
            alpha_arg = effective_alpha(alpha_hat)
        else:
            alpha_hat, alpha_arg = state.alpha_hat, None
            alpha_metric = fill(adaptive_cfg.alpha, dev)
        opt, w = update(adaptive_cfg, g, state.opt, w_in, alpha=alpha_arg)
        ef = state.ef if ef_new is None else ef_new[None]
        if ok is not None:
            w = torch.where(ok, w, state.w)
            opt = tuple(torch.where(ok, a, b) for a, b in zip(opt, state.opt))
            if track:
                alpha_hat = torch.where(ok, alpha_hat, state.alpha_hat)
            if ef_new is not None:
                # the residual of a transmission that never happened
                # must not replace the carried one
                ef = torch.where(ok, ef, state.ef)
        return (alpha_hat, alpha_hat if track else alpha_metric, tuple(opt),
                w, ef)

    return server_step


def round_metrics(loss: torch.Tensor, clean: torch.Tensor,
                  g_slab: torch.Tensor, h: torch.Tensor,
                  alpha: torch.Tensor, n_participants: torch.Tensor,
                  summed: bool = False) -> RoundMetrics:
    """The metrics of a round from its slabs: slab norms are tree norms,
    the padding tail being zero. ``loss`` is the clients' (N,) losses and
    ``clean`` their mean gradient, or with ``summed`` the participants'
    summed loss and gradient, divided here by their count (1 in a round
    with none)."""
    if summed:
        nf = torch.clamp_min(n_participants, 1.0)
        loss, clean = loss / nf, clean / nf
    else:
        loss = torch.mean(loss)
    return RoundMetrics(
        loss=loss,
        grad_norm=torch.sqrt(torch.sum(torch.square(clean))),
        noisy_grad_norm=torch.sqrt(torch.sum(torch.square(g_slab))),
        fading_mean=torch.mean(h),
        alpha_hat=alpha,
        n_participants=n_participants,
    )
