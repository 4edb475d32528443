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

``backend="pallas_sharded"`` with ``mesh=`` (a ``DeviceMesh`` over a
started process group) takes each of these entry points to the sharded
engine, ``core.shard``, called on every rank; ``make_sharded_round_step``
is the per-leaf collective round (``core.ota.ota_psum``).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch import spans
from repro_torch.core.adaptive import (AdaptiveConfig, ServerOptState,
                                       apply_slab_update,
                                       make_server_optimizer,
                                       slab_update_slabs, state_slab_rows)
from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import RoundDraws
from repro_torch.core.ota import (downlink_quantize_slab, ota_aggregate_slab,
                                  ota_psum, psum_axes)
from repro_torch.core.round import (FLConfig, LossFn, PyTree, RoundMetrics,
                                    check_state, client_update, fill,
                                    make_server_step, round_inputs,
                                    round_metrics, storage_round_trip)
from repro_torch.core.shard import (make_shard_slab_runner,
                                    make_shard_slab_step, shard_round_step)
from repro_torch.core.slab import (make_slab_spec, slab_to_tree,
                                   tree_flatten, tree_map)
from repro_torch.core.slab_state import SlabTrainState
from repro_torch.core.stream import client_weight_array, streamed_round_parts
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.spans import span


def _check_covered(channel_cfg: OTAChannelConfig,
                   adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig,
                   backend: Optional[str], batch_gen, mesh=None) -> None:
    """Refuse what the round cannot run: a backend switch (the device
    decides; ``"pallas_sharded"`` with ``mesh=`` selects the sharded
    engine), a mesh or bucketed collectives without the sharded engine,
    and ``batch_gen`` outside the single-device streamed round."""
    if backend not in (None, "pallas_sharded"):
        raise ValueError(f"backend={backend!r}: the port has no backend "
                         "switch; the device decides (backend="
                         "'pallas_sharded' with mesh= selects the sharded "
                         "engine)")
    if backend == "pallas_sharded":
        if mesh is None:
            raise ValueError('backend="pallas_sharded" needs a mesh; pass '
                             "mesh= (a torch.distributed DeviceMesh)")
        if batch_gen is not None:
            raise ValueError('batch_gen= is only supported by the streamed '
                             'single-device backends, not "pallas_sharded"')
    elif mesh is not None:
        raise ValueError(
            'mesh= was given but the backend is not "pallas_sharded": the '
            "round runs single-device and would silently ignore it; use "
            'backend="pallas_sharded" for distributed rounds')
    elif channel_cfg.comm_buckets > 1:
        raise ValueError(
            "comm_buckets > 1 buckets the sharded MAC collective; the "
            'single-device round has none: use backend="pallas_sharded" '
            "with mesh=, or comm_buckets=1")
    if batch_gen is not None and not fl_cfg.dynamic_round:
        raise ValueError("batch_gen= needs a streamed round config "
                         "(FLConfig.client_chunk); the resident path "
                         "consumes materialised client_batches")
    state_slab_rows(adaptive_cfg)    # unknown optimizer names raise here


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
    resident loop (``make_slab_round_step``). ``backend="pallas_sharded"``
    with ``mesh=`` (a ``DeviceMesh``) runs the round on the sharded
    engine (``core.shard.shard_round_step``), called on every rank with
    the rank's draws.
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
    if backend == "pallas_sharded":
        return shard_round_step(loss_fn, channel_cfg, adaptive_cfg, fl_cfg,
                                mesh, device)
    dev = resolve_device(device)
    client_fn = vmap(client_update(loss_fn, fl_cfg), in_dims=(None, 0))

    def round_step(params, opt_state: ServerOptState, draws: RoundDraws,
                   client_batches):
        leaf = tree_flatten(params)[0][0]
        if leaf.device != dev:
            raise ValueError(f"params live on {leaf.device}, the round on "
                             f"{dev}")
        draws, batches = round_inputs(dev, fl_cfg, draws, client_batches)
        grads, losses = client_fn(params, batches)
        spec = make_slab_spec(params)
        # The MAC, then the fused server update with g_t still a slab.
        g_slab, h, grads_slab, _, _ = ota_aggregate_slab(
            draws, channel_cfg, grads, spec)
        new_params, new_state = apply_slab_update(adaptive_cfg, spec, g_slab,
                                                  opt_state, params)
        return new_params, new_state, round_metrics(
            losses, torch.mean(grads_slab, dim=0), g_slab, h,
            fill(adaptive_cfg.alpha, dev), fill(fl_cfg.n_clients, dev))

    return round_step


def init_server(params: PyTree, adaptive_cfg: AdaptiveConfig
                ) -> ServerOptState:
    """The optimizer state of ``adaptive_cfg`` for ``params``, on their
    device."""
    return make_server_optimizer(adaptive_cfg).init(params)


def make_slab_round_step(loss_fn: LossFn, channel_cfg: OTAChannelConfig,
                         adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig,
                         device: DeviceLike = None,
                         backend: Optional[str] = None, batch_gen=None,
                         mesh=None):
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
    ``backend="pallas_sharded"`` with ``mesh=`` is the sharded engine's
    step (``core.shard.make_shard_slab_step``).
    """
    _check_covered(channel_cfg, adaptive_cfg, fl_cfg, backend, batch_gen,
                   mesh)
    if backend == "pallas_sharded":
        return make_shard_slab_step(loss_fn, channel_cfg, adaptive_cfg,
                                    fl_cfg, mesh, device)
    dev = resolve_device(device)
    client_fn = vmap(client_update(loss_fn, fl_cfg), in_dims=(None, 0))
    track = adaptive_cfg.track_alpha
    use_ef = channel_cfg.uplink.error_feedback
    dl_int8 = channel_cfg.downlink == "int8"
    streamed = fl_cfg.dynamic_round
    weights = client_weight_array(fl_cfg, dev)
    server_step = make_server_step(adaptive_cfg, dev, slab_update_slabs)

    # Either uplink returns (g_slab, h, stats, ef_new, clean, loss,
    # n_participants, ok): ``clean`` the clients' mean gradient and
    # ``loss`` their losses (resident; no count: every client took part),
    # or the participants' sums and count (streamed); ``ok`` the
    # dead-round guard where a dynamic normaliser can give one.
    def resident_uplink(draws, spec, params, batches, ef):
        """Every client's gradient resident, then the MAC: one channel
        launch (f32) or transmit + receive (quantized; the carried
        residual joins the transmit quantizer and the fresh one comes
        back from the same launch)."""
        with span("clients"):
            grads, losses = client_fn(params, batches)
        with span("mac"):
            g_slab, h, grads_slab, stats, ef_new = ota_aggregate_slab(
                draws, channel_cfg, grads, spec, pilot_stats=track, ef=ef)
        # The client gradients, in both forms, are the round's largest
        # buffers (4 x 4 GB at a billion parameters): reduce them to the
        # metric here; they go when this returns, before the server
        # update allocates.
        with span("metrics"):
            return (g_slab, h, stats, ef_new, torch.mean(grads_slab, dim=0),
                    losses, None, None)

    def streamed_uplink(draws, spec, params, batches, ef):
        with span("mac"):    # each chunk's clients in a span of theirs
            p = streamed_round_parts(
                draws, channel_cfg, fl_cfg, spec, client_fn, params,
                client_batches=batches, batch_gen=batch_gen,
                pilot_stats=track, ef=ef, weights=weights)
        # with the static 1/N no round is dead: the selects are left out
        return (p.g_slab, p.h, p.stats, p.ef_new, p.clean_slab, p.loss_sum,
                p.n_participants, p.norm > 0.0 if fl_cfg.dynamic_norm
                else None)

    uplink = streamed_uplink if streamed else resident_uplink

    def step(state: SlabTrainState, draws: RoundDraws, client_batches=None):
        check_state(state, dev, use_ef)
        spec = state.spec
        with span("h2d"):
            draws, batches = round_inputs(dev, fl_cfg, draws, client_batches)
        # Model broadcast: the one pytree the round materialises; under
        # the int8 downlink the clients see the slab's int8
        # reconstruction, while the server keeps the f32 master.
        with span("broadcast"):
            params = slab_to_tree(spec, state.w if not dl_int8 else
                                  downlink_quantize_slab(
                                      state.w, draws.wire("r_dl",
                                                          spec.padded)))
        g_slab, h, stats, ef_new, clean, loss, n_part, ok = uplink(
            draws, spec, params, batches, state.ef[0] if use_ef else None)
        with span("server"):
            w_in = state.w
            if any(dt != torch.float32 for dt in spec.dtypes):
                w_in = storage_round_trip(spec, params,
                                          state.w if dl_int8 else None)
            alpha_hat, alpha_metric, opt, w, ef = server_step(
                state, g_slab, stats, w_in, ef_new, ok)
        with span("metrics"):
            if n_part is None:
                n_part = fill(fl_cfg.n_clients, dev)
            metrics = round_metrics(loss, clean, g_slab, h, alpha_metric,
                                    n_part, summed=streamed)
        return SlabTrainState(state.step + 1, w, opt, alpha_hat, spec,
                              ef), metrics

    return step


def make_slab_round_runner(loss_fn: LossFn, channel_cfg: OTAChannelConfig,
                           adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig,
                           device: DeviceLike = None,
                           backend: Optional[str] = None, batch_gen=None,
                           mesh=None):
    """R rounds as a host loop over the resident state.

    Returns ``run(state, draws, client_batches) -> (state, metrics)``
    with ``draws`` a sequence of R ``RoundDraws`` and ``client_batches``
    leaves shaped (R, N, ...); metrics come back stacked (R,). With
    ``batch_gen`` (see ``make_slab_round_step``) there are no
    materialised batches: call ``run(state, draws)``.
    ``backend="pallas_sharded"`` with ``mesh=`` is the sharded engine's
    runner (``core.shard.make_shard_slab_runner``).
    """
    if backend == "pallas_sharded":
        _check_covered(channel_cfg, adaptive_cfg, fl_cfg, backend, batch_gen,
                       mesh)
        return make_shard_slab_runner(loss_fn, channel_cfg, adaptive_cfg,
                                      fl_cfg, mesh, device)
    step = make_slab_round_step(loss_fn, channel_cfg, adaptive_cfg, fl_cfg,
                                device=device, backend=backend,
                                batch_gen=batch_gen, mesh=mesh)

    def run(state: SlabTrainState, draws: Sequence[RoundDraws],
            client_batches=None):
        if batch_gen is not None and client_batches is not None:
            raise ValueError("batch_gen= runner takes no materialised "
                             "client_batches")
        ms: List[RoundMetrics] = []
        for r in range(len(draws)):
            with span("round"):
                batch = (None if batch_gen is not None else
                         tree_map(lambda x: x[r], client_batches))
                state, m = step(state, draws[r], batch)
            ms.append(m)
        with span("metrics"):
            stacked = RoundMetrics(*(torch.stack(f) for f in zip(*ms)))
        return state, stacked

    return run


def _log_round(log, t: int, rec: dict) -> None:
    """One history record, formatted as the JAX drivers do."""
    log(f"round {t+1:5d}  loss {rec['loss']:.4f}  "
        f"|g| {rec['grad_norm']:.3e}  |g_t| {rec['noisy_grad_norm']:.3e}"
        + (f"  acc {rec.get('accuracy', float('nan')):.4f}"
           if 'accuracy' in rec else ""))


def _read_back(x: torch.Tensor) -> list:
    """A metric column on the host: the loop waits for the card."""
    spans.host_syncs += 1
    return x.tolist()


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
        with span("feed"):
            draws = [draws_fn(t + i) for i in range(r)]
            bs = [batch_fn(t + i) for i in range(r)]
            batches = (None if all(b is None for b in bs)
                       else tree_map(_stack, *bs))
        state, ms = run_chunk(state, draws, batches)
        with span("readback"):
            cols = {k: _read_back(getattr(ms, k)) for k in
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


def make_sharded_round_step(loss_fn: LossFn, channel_cfg: OTAChannelConfig,
                            adaptive_cfg: AdaptiveConfig, mesh,
                            client_axes: Tuple[str, ...] = ("data",)):
    """The per-leaf collective round, called on every rank of ``mesh``:
    ``body(params, opt_state, draws, local_batch) -> (params, opt_state,
    loss)``. Each rank along ``client_axes`` is one client: it computes
    the gradient of its own batch, ``core.ota.ota_psum`` aggregates over
    the air (f32 wire only), and the server update runs on every rank
    (the fused slab update). The loss is the clients' mean."""
    server_opt = make_server_optimizer(adaptive_cfg)
    n = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                  for a in client_axes)

    def body(params, opt_state: ServerOptState, draws: RoundDraws,
             local_batch):
        local_grad, loss = grad_and_value(loss_fn)(params, local_batch)
        g_t = ota_psum(local_grad, draws, channel_cfg, mesh, client_axes)
        new_params, new_state = server_opt.update(g_t, opt_state, params)
        return new_params, new_state, psum_axes(loss, mesh, client_axes) / n

    return body


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
