"""Federated-learning rounds on the resident slab engine (Algorithm 1).

PyTorch counterpart of the slab-resident path of ``repro.core.fl``. Each
round:

    1. broadcasts the weight slab as a parameter dict (views of the slab;
       under ``downlink="int8"`` the int8-quantized reconstruction the
       clients see, while the server keeps the f32 master);
    2. computes every client's gradient with
       ``torch.func.vmap(torch.func.grad_and_value(loss_fn))``
       (the twin of ``jax.vmap(jax.value_and_grad)``), or a FedAvg-style
       pseudo-gradient from k local SGD steps;
    3. runs the MAC: ONE fused ``ota_channel_slab`` launch on the f32
       uplink, or ONE ``ota_transmit_slab`` and ONE ``ota_receive_slab``
       launch on a quantized uplink (with the error-feedback residual
       carried in ``SlabTrainState.ef``);
    4. under ``alpha="auto"`` folds the MAC's pilot statistics into the
       resident ``alpha_hat`` (``core.tail_index``), on the device;
    5. runs ONE fused ``adaptive_update_slab`` launch (the server update)
       on the resident state slabs, with the tracked alpha as a device
       operand.

A DYNAMIC round config (``client_chunk``, ``sample_rate < 1`` or
``client_weights``) takes the streamed uplink of ``core.stream`` in place
of steps 2-3: the client axis is walked in chunks of O(chunk * d)
memory, participation and weights fold into the effective fading, and a
round in which nobody took part leaves the server state as it was.

The round takes its random draws as ``RoundDraws`` instead of a PRNG key
(``repro_torch.core.draws``). ``make_slab_round_runner`` drives R rounds
as a host loop (the JAX package scans them), and ``run_rounds_slab`` is
the host loop over chunks of rounds; it resumes at ``start_round``
and calls ``chunk_hook`` after each chunk (checkpoints:
``repro_torch.checkpoint``).

The per-round pytree API, the one the paper's experiments and the
examples run through, is ``make_round_step`` + ``init_server`` +
``run_rounds``: params and a ``ServerOptState`` in, the same out, each
round. It is the JAX package's pallas round: the MAC through
``ota_aggregate_slab`` and ONE fused server update
(``apply_slab_update``) on slabs packed from the pytrees.

Configurations the port does not cover yet raise ``NotImplementedError``
naming the ROADMAP item that brings them; none silently degrades.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.adaptive import (AdaptiveConfig, ServerOptState,
                                       apply_slab_update,
                                       make_server_optimizer,
                                       slab_update_slabs, state_slab_rows)
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import RoundDraws
from repro_torch.core.ota import downlink_quantize_slab, ota_aggregate_slab
from repro_torch.core.slab import (make_slab_spec, slab_to_tree,
                                   tree_flatten, tree_map, tree_to_slab)
from repro_torch.core.slab_state import SlabTrainState
from repro_torch.core.stream import client_weight_array, streamed_round_parts
from repro_torch.core.tail_index import effective_alpha, update_alpha_ema
from repro_torch.device import DeviceLike, resolve_device

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
                   backend: Optional[str], batch_gen, mesh=None) -> None:
    """Refuse every configuration this slice does not port yet."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (rounds distributed over a device mesh, the sharded "
            "engine) is not ported yet: ROADMAP item A12")
    if backend == "pallas_sharded":
        raise NotImplementedError(
            'backend="pallas_sharded" (the sharded engine) is not ported '
            "yet: ROADMAP item A12")
    if backend is not None:
        raise ValueError(f"backend={backend!r}: the port has no backend "
                         "switch; the device decides")
    if channel_cfg.comm_buckets > 1:
        raise NotImplementedError(
            "comm_buckets > 1 (bucketed MAC collectives of the sharded "
            "engine) is not ported yet: ROADMAP item A12")
    if batch_gen is not None and not fl_cfg.dynamic_round:
        raise ValueError("batch_gen= needs a streamed round config "
                         "(FLConfig.client_chunk); the resident path "
                         "consumes materialised client_batches")
    state_slab_rows(adaptive_cfg)    # unknown optimizer names raise here


def _fill(x: float, dev: torch.device) -> torch.Tensor:
    """A 0-dim f32 metric: a fill on the device, not a copy from the host
    (no sync)."""
    return torch.full((), x, dtype=torch.float32, device=dev)


def _round_metrics(losses: torch.Tensor, grads_slab: torch.Tensor,
                   g_slab: torch.Tensor, h: torch.Tensor,
                   alpha_hat: torch.Tensor, n_participants: torch.Tensor
                   ) -> RoundMetrics:
    """The metrics of a resident (all-client) round, from its slabs: slab
    norms are tree norms, the padding tail being zero."""
    return RoundMetrics(
        loss=torch.mean(losses),
        grad_norm=torch.sqrt(torch.sum(torch.square(
            torch.mean(grads_slab, dim=0)))),
        noisy_grad_norm=torch.sqrt(torch.sum(torch.square(g_slab))),
        fading_mean=torch.mean(h),
        alpha_hat=alpha_hat,
        n_participants=n_participants,
    )


def make_round_step(loss_fn: LossFn, channel_cfg: OTAChannelConfig,
                    adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig,
                    device: DeviceLike = None,
                    backend: Optional[str] = None, mesh=None):
    """One ADOTA-FL round over vmapped clients, on ``device`` (default:
    the card), on pytrees.

    Returns ``round_step(params, opt_state, draws, client_batches) ->
    (params, opt_state, metrics)``: ``params`` a pytree of tensors on the
    device, ``opt_state`` the ``ServerOptState`` of ``init_server``,
    ``draws`` the round's ``RoundDraws``, ``client_batches`` leaves (N,
    ...) for ``local_steps == 1`` and (N, k, ...) otherwise. The round is
    the JAX package's ``make_round_step(backend="pallas")``: the MAC
    through ``ota_aggregate_slab`` (one channel launch on the f32 uplink;
    one transmit and one receive launch on a quantized one) and ONE fused
    server update over slabs packed from the pytrees.

    Refused as in the JAX package (``ValueError``): alpha "auto", a
    dynamic round, error feedback and the int8 downlink, which need the
    resident loop (``make_slab_round_step``). The sharded engine
    (``backend="pallas_sharded"``, ``mesh=``) waits for ROADMAP item A12
    (``NotImplementedError``).
    """
    if adaptive_cfg.track_alpha:
        raise ValueError(
            'AdaptiveConfig.alpha == "auto" needs the slab-resident loop '
            '(make_slab_round_step / make_slab_round_runner, or '
            'launch.train --track-alpha): the per-round pytree API has no '
            'resident alpha_hat to carry the estimator EMA across rounds')
    if fl_cfg.dynamic_round:
        raise ValueError(
            "client_chunk / sample_rate < 1 / client_weights need the "
            "slab-resident loop (make_slab_round_step / "
            "make_slab_round_runner): the per-round pytree API has no "
            "streamed uplink path")
    if channel_cfg.uplink.error_feedback or channel_cfg.downlink != "f32":
        raise ValueError(
            "error_feedback / downlink != \"f32\" need the slab-resident "
            "loop (make_slab_round_step / make_slab_round_runner): the "
            "per-round pytree API has no resident residual slab to carry "
            "across rounds and no slab broadcast to quantize")
    _check_covered(channel_cfg, adaptive_cfg, fl_cfg, backend, None, mesh)
    dev = resolve_device(device)
    client_fn = vmap(_client_update(loss_fn, fl_cfg), in_dims=(None, 0))
    alpha = float(adaptive_cfg.alpha)
    n_clients = float(fl_cfg.n_clients)

    def round_step(params, opt_state: ServerOptState, draws: RoundDraws,
                   client_batches):
        leaf = tree_flatten(params)[0][0]
        if leaf.device != dev:
            raise ValueError(f"params live on {leaf.device}, the round on "
                             f"{dev}")
        draws = draws.to(dev)
        if draws.mask is not None:
            raise ValueError("draws.mask is set but the round config is "
                             "resident (FLConfig.sample_rate is 1)")
        batches = tree_map(lambda x: torch.as_tensor(x, device=dev),
                           client_batches)
        grads, losses = client_fn(params, batches)
        spec = make_slab_spec(params)
        # The MAC, then the fused server update with g_t still a slab.
        g_slab, h, grads_slab, _, _ = ota_aggregate_slab(
            draws, channel_cfg, grads, spec)
        new_params, new_state = apply_slab_update(adaptive_cfg, spec, g_slab,
                                                  opt_state, params)
        return new_params, new_state, _round_metrics(
            losses, grads_slab, g_slab, h, _fill(alpha, dev),
            _fill(n_clients, dev))

    return round_step


def init_server(params: PyTree, adaptive_cfg: AdaptiveConfig
                ) -> ServerOptState:
    """The optimizer state of ``adaptive_cfg`` for ``params``, on their
    device."""
    return make_server_optimizer(adaptive_cfg).init(params)


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

    A dynamic round config (``fl_cfg.dynamic_round``) streams the uplink
    (``core.stream.streamed_round_parts``). Its draws carry the
    participation mask under ``sample_rate < 1``. A round in which
    nobody took part skips the server update: w, the optimizer slabs,
    ``alpha_hat`` and ``ef`` carry over unchanged (selected on the
    device, with no read back to the host), only ``step`` advances, and
    the metrics record ``n_participants == 0``. ``batch_gen(draws, idx)``
    replaces the materialised batches (pass ``client_batches=None``).
    """
    _check_covered(channel_cfg, adaptive_cfg, fl_cfg, backend, batch_gen)
    dev = resolve_device(device)
    client_fn = vmap(_client_update(loss_fn, fl_cfg), in_dims=(None, 0))
    track = adaptive_cfg.track_alpha
    use_ef = channel_cfg.uplink.error_feedback
    dl_int8 = channel_cfg.downlink == "int8"
    n_metric = float(fl_cfg.n_clients)
    static_alpha = None if track else float(adaptive_cfg.alpha)
    weights = client_weight_array(fl_cfg, dev)

    def broadcast_slab(state: SlabTrainState, draws: RoundDraws):
        """The weight slab the CLIENTS see: the f32 master, or its int8
        reconstruction under the int8 downlink."""
        if not dl_int8:
            return state.w
        return downlink_quantize_slab(state.w,
                                      draws.wire("r_dl", state.spec.padded))

    def check_state(state: SlabTrainState) -> None:
        if state.w.device != dev:
            raise ValueError(f"state lives on {state.w.device}, the round "
                             f"on {dev}")
        if use_ef and state.ef is None:
            raise ValueError(
                "UplinkConfig.error_feedback=True but the SlabTrainState "
                "carries no residual rows; build it with "
                "init_train_state(..., error_feedback=True)")

    def server_half(state, params, g_slab, stats):
        """The tracked alpha's EMA and the server update; returns
        (alpha_hat, alpha_metric, new_opt, w_new)."""
        spec = state.spec
        if track:
            alpha_hat = update_alpha_ema(state.alpha_hat, stats,
                                         adaptive_cfg.alpha_ema)
            alpha_arg = effective_alpha(alpha_hat)
            alpha_metric = alpha_hat
        else:
            alpha_hat = state.alpha_hat
            alpha_arg = None
            alpha_metric = _fill(static_alpha, dev)
        w_in = state.w
        if any(dt != torch.float32 for dt in spec.dtypes):
            # Non-f32 leaves round-trip through their storage dtype each
            # round, as in the JAX package; under the int8 downlink the
            # cast applies to the master, never to the broadcast.
            w_in = tree_to_slab(spec, params if not dl_int8
                                else slab_to_tree(spec, state.w))
        # The server update on the resident slabs (a tracked alpha goes
        # in as a device operand).
        new_opt, w_new = slab_update_slabs(adaptive_cfg, g_slab, state.opt,
                                           w_in, alpha=alpha_arg)
        return alpha_hat, alpha_metric, new_opt, w_new

    def to_dev(client_batches):
        return tree_map(lambda x: torch.as_tensor(x, device=dev),
                        client_batches)

    if fl_cfg.dynamic_round:
        can_skip = fl_cfg.dynamic_norm

        def dynamic_step(state: SlabTrainState, draws: RoundDraws,
                         client_batches=None):
            check_state(state)
            spec = state.spec
            draws = draws.to(dev)
            params = slab_to_tree(spec, broadcast_slab(state, draws))
            parts = streamed_round_parts(
                draws, channel_cfg, fl_cfg, spec, client_fn, params,
                client_batches=(None if client_batches is None
                                else to_dev(client_batches)),
                batch_gen=batch_gen, pilot_stats=track,
                ef=state.ef[0] if use_ef else None, weights=weights)
            a_new, alpha_metric, new_opt, w_new = server_half(
                state, params, parts.g_slab, parts.stats)
            ef_next = parts.ef_new[None] if use_ef else state.ef
            alpha_hat = a_new
            if can_skip:
                # Dead round: nobody transmitted, so the server state
                # carries over (only the round counter advances). Only a
                # dynamic normaliser can give one; with the static 1/N
                # the selects are left out.
                ok = parts.norm > 0.0
                w_new = torch.where(ok, w_new, state.w)
                new_opt = tuple(torch.where(ok, a, b)
                                for a, b in zip(new_opt, state.opt))
                if track:
                    alpha_hat = torch.where(ok, a_new, state.alpha_hat)
                    alpha_metric = alpha_hat
                if use_ef:
                    # the residual of a transmission that never happened
                    # must not replace the carried one
                    ef_next = torch.where(ok, ef_next, state.ef)
            nf = torch.clamp_min(parts.n_participants, 1.0)
            metrics = RoundMetrics(
                loss=parts.loss_sum / nf,
                grad_norm=torch.sqrt(torch.sum(torch.square(
                    parts.clean_slab / nf))),
                noisy_grad_norm=torch.sqrt(torch.sum(torch.square(
                    parts.g_slab))),
                fading_mean=torch.mean(parts.h),
                alpha_hat=alpha_metric,
                n_participants=parts.n_participants,
            )
            return SlabTrainState(state.step + 1, w_new, new_opt, alpha_hat,
                                  spec, ef_next), metrics

        return dynamic_step

    def step(state: SlabTrainState, draws: RoundDraws, client_batches):
        check_state(state)
        spec = state.spec
        draws = draws.to(dev)
        if draws.mask is not None:
            raise ValueError("draws.mask is set but the round config is "
                             "resident (FLConfig.sample_rate is 1)")
        batches = to_dev(client_batches)
        # Model broadcast: the one pytree the round materialises.
        params = slab_to_tree(spec, broadcast_slab(state, draws))
        grads, losses = client_fn(params, batches)
        # The MAC: one channel launch (f32) or transmit + receive
        # (quantized; the carried residual joins the transmit quantizer
        # and the fresh one comes back from the same launch).
        g_slab, h, grads_slab, stats, ef_new = ota_aggregate_slab(
            draws, channel_cfg, grads, spec, pilot_stats=track,
            ef=state.ef[0] if use_ef else None)
        alpha_hat, alpha_metric, new_opt, w_new = server_half(
            state, params, g_slab, stats)
        metrics = _round_metrics(losses, grads_slab, g_slab, h, alpha_metric,
                                 _fill(n_metric, dev))
        return SlabTrainState(state.step + 1, w_new, new_opt, alpha_hat,
                              spec, ef_new[None] if use_ef else state.ef
                              ), metrics

    return step


def make_slab_round_runner(loss_fn: LossFn, channel_cfg: OTAChannelConfig,
                           adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig,
                           device: DeviceLike = None,
                           backend: Optional[str] = None, batch_gen=None):
    """R rounds as a host loop over the resident state.

    Returns ``run(state, draws, client_batches) -> (state, metrics)``
    with ``draws`` a sequence of R ``RoundDraws`` and ``client_batches``
    leaves shaped (R, N, ...); metrics come back stacked (R,). With
    ``batch_gen`` (see ``make_slab_round_step``) there are no
    materialised batches: call ``run(state, draws)``.
    """
    step = make_slab_round_step(loss_fn, channel_cfg, adaptive_cfg, fl_cfg,
                                device=device, backend=backend,
                                batch_gen=batch_gen)

    def run(state: SlabTrainState, draws: Sequence[RoundDraws],
            client_batches=None):
        if batch_gen is not None and client_batches is not None:
            raise ValueError("batch_gen= runner takes no materialised "
                             "client_batches")
        ms: List[RoundMetrics] = []
        for r in range(len(draws)):
            batch = (None if batch_gen is not None else
                     tree_map(lambda x: x[r], client_batches))
            state, m = step(state, draws[r], batch)
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


class _DeadRoundAggregator:
    """One WARNING line per log interval instead of one per dead round,
    as in the JAX drivers: ``record(t)`` counts a round with no
    participants, ``flush()`` logs the count and the round span, if
    any, since the last flush."""

    def __init__(self, log):
        self._log = log
        self._count = 0
        self._first = self._last = 0

    def record(self, t: int) -> None:
        if self._count == 0:
            self._first = t
        self._last = t
        self._count += 1

    def flush(self) -> None:
        if not self._count:
            return
        span = (f"round {self._first + 1:5d}" if self._first == self._last
                else f"rounds {self._first + 1}-{self._last + 1}")
        self._log(f"{span}  WARNING: {self._count} dead round(s) — no "
                  "participants, server update skipped; consider a higher "
                  "sample_rate")
        self._count = 0


def run_rounds_slab(run_chunk, state: SlabTrainState,
                    draws_fn: Callable[[int], RoundDraws],
                    batch_fn: Callable[[int], PyTree], n_rounds: int,
                    chunk: int = 8, eval_fn: Optional[Callable] = None,
                    eval_every: int = 0, log_every: int = 0, log=print,
                    start_round: int = 0,
                    chunk_hook: Optional[Callable] = None,
                    align: Tuple[int, ...] = ()):
    """Host driver over ``run_chunk`` (from ``make_slab_round_runner``).

    Rounds ``start_round`` .. ``n_rounds - 1`` are dispatched in chunks
    of up to ``chunk``. Round t takes ``draws_fn(t)`` and
    ``batch_fn(t)``: both keyed by the ABSOLUTE round index (the port's
    form of the JAX package's ``key_fn``), so a run resumed at
    ``start_round`` sees the draws the uninterrupted run saw. Under
    ``batch_gen`` ``batch_fn`` returns None. Eval (on the parameter
    dict) happens only at chunk boundaries; chunks are clipped so every
    ``eval_every`` multiple, and every multiple of each period in
    ``align``, is one. ``chunk_hook(t, state, history)`` runs after every
    chunk, t the next round (e.g. for checkpoints). Dead rounds (no
    participants) are logged as one WARNING line per log interval.
    Returns ``(state, history)`` with one dict per round run, as the JAX
    package's ``run_rounds_slab`` returns.
    """
    history = []
    dead = _DeadRoundAggregator(log)
    t = start_round
    while t < n_rounds:
        r = min(chunk, n_rounds - t)
        for period in (eval_every, *align):
            if period:
                r = min(r, period - t % period)
        draws = [draws_fn(t + i) for i in range(r)]
        bs = [batch_fn(t + i) for i in range(r)]
        batches = (None if all(b is None for b in bs)
                   else tree_map(_stack, *bs))
        state, ms = run_chunk(state, draws, batches)
        cols = {k: getattr(ms, k).tolist() for k in
                ("loss", "grad_norm", "noisy_grad_norm", "alpha_hat",
                 "n_participants")}
        for i in range(r):
            history.append({"round": t + i,
                            **{k: float(v[i]) for k, v in cols.items()}})
            if history[-1]["n_participants"] == 0.0:
                dead.record(t + i)
        t += r
        if eval_fn is not None and eval_every and t % eval_every == 0:
            history[-1].update(eval_fn(slab_to_tree(state.spec, state.w)))
        if log_every:
            for i in range(t - r, t):
                if (i + 1) % log_every == 0:
                    dead.flush()
                    # history is indexed from start_round, i is absolute
                    _log_round(log, i, history[i - start_round])
        if chunk_hook is not None:
            chunk_hook(t, state, history)
    dead.flush()
    return state, history


def run_rounds(round_step, params: PyTree, opt_state: ServerOptState,
               draws_fn: Callable[[int], RoundDraws],
               batch_fn: Callable[[int], PyTree], n_rounds: int,
               eval_fn: Optional[Callable] = None, eval_every: int = 0,
               log_every: int = 0, log=print):
    """Host loop over ``round_step`` (from ``make_round_step``).

    Round t takes ``draws_fn(t)`` and ``batch_fn(t)``, keyed by the
    absolute round as in ``run_rounds_slab``. Eval (``eval_fn(params)``)
    after every ``eval_every``-th round joins that round's record.
    Returns ``(params, opt_state, history)``, one dict per round, as the
    JAX package's ``run_rounds`` returns.
    """
    history = []
    dead = _DeadRoundAggregator(log)
    for t in range(n_rounds):
        params, opt_state, m = round_step(params, opt_state, draws_fn(t),
                                          batch_fn(t))
        # one read back to the host a round
        vals = torch.stack([m.loss, m.grad_norm, m.noisy_grad_norm,
                            m.alpha_hat, m.n_participants]).tolist()
        rec = {"round": t, **dict(zip(("loss", "grad_norm",
                                       "noisy_grad_norm", "alpha_hat",
                                       "n_participants"), vals))}
        if rec["n_participants"] == 0.0:
            dead.record(t)
        if eval_fn is not None and eval_every and (t + 1) % eval_every == 0:
            rec.update(eval_fn(params))
        history.append(rec)
        if log_every and (t + 1) % log_every == 0:
            dead.flush()
            _log_round(log, t, rec)
    dead.flush()
    return params, opt_state, history
