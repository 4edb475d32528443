"""Sharded slab engine: the OTA round distributed over a client mesh.

PyTorch counterpart of ``repro.core.shard``, on ``torch.distributed``.
The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims; every dim but ``"model"`` carries clients (``client_axes_of``).
Each rank is one process with one device, and it permanently owns one
contiguous ``spec.shard_len`` slice of the parameter slab and of every
optimizer-state slab (the JAX package's true ZeRO layout): its
``SlabTrainState`` holds ``w`` and the optimizer rows as (shard_len,)
slices and ``ef`` as its transmitter's (1, padded) residual row.
``shard_train_state`` and ``gather_train_state`` carry a state across
that boundary; checkpoints store the gathered (resident) state, so a
file is the same whatever the mesh.

Steady-state round, per rank (``make_shard_slab_step`` /
``make_shard_slab_runner``):

1. ``all_gather`` the parameter slices to the full (padded,) slab: the
   model broadcast (under ``downlink="int8"`` each rank quantizes its
   own slice first, with the full-width draw sliced at its offset, so
   the gathered broadcast is bitwise the single-device one).
2. The rank's N/P local clients compute their gradients; ONE transmit
   launch forms the faded partial sum ``(1/N) sum_{n local} h_n G_n``
   over the full slab width (``ota_transmit_slab`` with no carry, B3a;
   on a quantized wire the quantize-on-write launch, B3c, twice: the
   noisy payload with error feedback, the clean diagnostic payload).
3. The MAC superposition: at ``uplink="f32"`` a reduce-scatter of the
   stacked (2, padded) partials completes the MAC and hands each rank
   its own slice; on a quantized wire an all-to-all hands each rank the
   P payload blocks addressed to its slice (int8 codewords with
   per-transmitter scales cannot be summed on the wire).
4. The receive stage on the slice: the f32 slice gets the CMS
   interference in plain torch (the round's full-width (u, e), sliced);
   the quantized one dequantizes and superposes its P rows with the
   interference in one receive launch (B4), twice.
5. ONE server-update launch (B1) on the rank's resident slices.

Metric norms are square roots of summed squares of the slices, and the
alpha loop sums the slices' pilot statistics across ranks.

**Draws** follow the JAX per-shard contract: the full round's draws,
equal on every rank, sliced per shard and never re-keyed; the rounding
of the quantized uplink is per transmitter (``RoundDraws.shard``,
``r_up`` / ``r_clean``, ``sr_seed`` / ``sr_seed_clean``), transmitter 0
consuming the single-device draws, so the (1,)-mesh's quantized state is
bitwise the resident engine's. On the f32 wire the engines differ by
summation order only (B3a plus a reduce-scatter and plain CMS against
B2's one pass).

**Collectives.** A CUDA mesh runs over NCCL and a CPU mesh over gloo;
the engine checks that and never starts a process group itself (the
launchers in ``repro_torch.launch.mesh`` do). Several client axes chain
one collective a dim, in the JAX package's order, which reproduces its
row-major layout. ``channel_cfg.comm_buckets > 1`` selects the overlap
engine: the MAC collective splits into B buckets issued with
``async_op=True`` (each waited on before its result is read), the f32
partials fold as per-bucket GEMMs with the fast-exp CMS transform, the
round's scalar reductions fuse into one all-reduce, and the runner
issues round t+1's broadcast at the end of round t: the JAX package's
tolerance tier (1e-4). ``comm_buckets == 1`` is the default engine.

The round makes no host sync: every select on a device value is a
``torch.where``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.func import vmap

from repro_torch.core.adaptive import AdaptiveConfig, slab_update_slabs
from repro_torch.core.channel import (OTAChannelConfig, cms_transform,
                                      cms_transform_fast)
from repro_torch.core.draws import RoundDraws
from repro_torch.core.ota import (downlink_quantize_slab,
                                  interference_slab_inputs,
                                  linear_shard_index, psum_axes,
                                  restore_zero_tail)
from repro_torch.core.round import (FLConfig, RoundMetrics, check_state,
                                    client_update, fill, make_server_step,
                                    round_inputs, storage_round_trip)
from repro_torch.core.slab import (SlabSpec, make_slab_spec, slab_to_tree,
                                   stack_to_slab, tree_map)
from repro_torch.core.slab_state import (SlabTrainState, pack_train_state,
                                         unpack_train_state)
from repro_torch.core.stream import (client_weight_array, f32_matmul,
                                     fold_chunks, round_participation,
                                     take_rows)
from repro_torch.core.tail_index import log_moment_stats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ota_channel import (LANE, ota_receive_slab,
                                             ota_transmit_slab,
                                             pack_sign_slab)

PyTree = Any

# the collectives' backend of a mesh on each device type; no fallback
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def check_cards(n_ranks: int, device_type: str) -> None:
    """Refuse a CUDA mesh with more ranks than this machine has cards:
    one rank a card, as NCCL cannot put two ranks on one card."""
    if device_type != "cuda":
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_ranks > have:
        raise ValueError(
            f"a CUDA mesh of {n_ranks} ranks needs {n_ranks} cards, one a "
            f"rank (NCCL cannot put two ranks on one card), and this "
            f"machine has {have}; on one card run --mesh 1, or pass "
            "--device cpu for a mesh over gloo")


def client_axes_of(mesh) -> Tuple[str, ...]:
    """The client-carrying dims of a mesh: every dim except "model"."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def n_client_shards(mesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in client_axes_of(mesh))


# ---------------------------------------------------------------------------
# Collectives: issued async, waited on before their results are read.
# ---------------------------------------------------------------------------

def _wait(issued):
    for _, work in issued:
        work.wait()
    return [out for out, _ in issued]


def _issue_reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int):
    group = mesh.get_group(axis)
    s = dist.get_world_size(group)
    blocks = x.unflatten(dim, (s, -1)).movedim(dim, 0).contiguous()
    out = torch.empty(blocks.shape[1:], dtype=x.dtype, device=x.device)
    # the collective splits its input's dim 0 into the ranks' blocks
    return out, dist.reduce_scatter_tensor(
        out, blocks.view((s * out.shape[0],) + tuple(out.shape[1:])),
        group=group, async_op=True)


def _reduce_scatter_chain(xs: List[torch.Tensor], mesh, axes, dim: int
                          ) -> List[torch.Tensor]:
    for a in axes:
        xs = _wait([_issue_reduce_scatter(x, mesh, a, dim) for x in xs])
    return xs


def psum_scatter_slab(x: torch.Tensor, mesh, axes: Tuple[str, ...],
                      dim: int = 0) -> torch.Tensor:
    """Reduce-scatter over possibly several mesh dims, row-major.

    Scattering dim by dim in ``axes`` order splits dimension ``dim`` into
    P = prod(axes sizes) blocks whose order matches
    ``linear_shard_index`` (first axis major). Each rank ends with the
    fully summed block at its own linear index: the MAC superposition
    and the slice hand-off in one collective."""
    return _reduce_scatter_chain([x], mesh, axes, dim)[0]


def _issue_all_gather(x: torch.Tensor, mesh, axis: str):
    group = mesh.get_group(axis)
    x = x.contiguous()
    out = torch.empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out, dist.all_gather_into_tensor(out, x, group=group,
                                            async_op=True)


def all_gather_slab(x: torch.Tensor, mesh, axes: Tuple[str, ...]
                    ) -> torch.Tensor:
    """Inverse of ``psum_scatter_slab``'s layout on dim 0: concatenate
    the per-rank blocks back to full width (minor axis first)."""
    for a in reversed(axes):
        x = _wait([_issue_all_gather(x, mesh, a)])[0]
    return x


def _all_gather_start(x: torch.Tensor, mesh, axes: Tuple[str, ...]
                      ) -> Callable[[], torch.Tensor]:
    """``all_gather_slab`` with its first collective left in flight:
    returns the function that waits for it and finishes the chain."""
    issued = _issue_all_gather(x, mesh, axes[-1])

    def finish() -> torch.Tensor:
        return all_gather_slab(_wait([issued])[0], mesh, axes[:-1])

    return finish


def _exchange_chain(xs: List[torch.Tensor], mesh, axes, axis_sizes
                    ) -> List[torch.Tensor]:
    """``exchange_uplink_payload`` of several tensors at once."""
    dtypes = [x.dtype for x in xs]
    # gloo refuses uint32 (the packed sign words): they travel as int32,
    # the same bits
    xs = [x.view(torch.int32) if x.dtype == torch.uint32 else x for x in xs]
    rests = [tuple(x.shape[1:]) for x in xs]
    xs = [x.reshape(tuple(axis_sizes) + r) for x, r in zip(xs, rests)]
    for i, a in enumerate(axes):
        group = mesh.get_group(a)
        issued = []
        for x in xs:
            y = x.movedim(i, 0).contiguous()
            out = torch.empty_like(y)
            issued.append((out, dist.all_to_all_single(
                out, y, group=group, async_op=True)))
        xs = [out.movedim(0, i) for out in _wait(issued)]
    return [x.reshape((-1,) + r).contiguous().view(dt)
            for x, r, dt in zip(xs, rests, dtypes)]


def exchange_uplink_payload(x: torch.Tensor, mesh, axes: Tuple[str, ...],
                            axis_sizes: Tuple[int, ...]) -> torch.Tensor:
    """The slice hand-off of the quantized MAC: an all-to-all on the
    leading per-destination dimension. Row p of ``x`` (P, ...) is this
    transmitter's block addressed to shard p (``linear_shard_index``
    order); row q of the result is the block received FROM shard q.
    Chained over several dims on an (A, B, ..., rest) view (dim i split
    and re-concatenated at position i), which routes row (a, b, ...) to
    mesh coordinate (a, b, ...), the row-major linear index."""
    return _exchange_chain([x], mesh, axes, axis_sizes)[0]


# ---------------------------------------------------------------------------
# The quantized MAC.
# ---------------------------------------------------------------------------

def _transmitter_draws(channel_cfg: OTAChannelConfig, draws: RoundDraws,
                       spec: SlabSpec, idx: int, stochastic: bool,
                       inkernel: bool):
    """(r_noisy, r_clean, seed_noisy, seed_clean): this transmitter's
    rounding of its two payloads (all None without stochastic
    rounding)."""
    if not stochastic:
        return None, None, None, None
    if draws.shard != idx:
        raise ValueError(
            f"draws were made for transmitter {draws.shard}, this rank is "
            f"transmitter {idx}: the quantized uplink rounds per "
            "transmitter; make each rank's draws with TorchDraws(..., "
            "shard_index=...)")
    if inkernel:
        if draws.sr_seed is None or draws.sr_seed_clean is None:
            raise ValueError("this round needs draws.sr_seed and "
                             "draws.sr_seed_clean (UplinkConfig.sr_inkernel "
                             "on the card)")
        return None, None, draws.sr_seed, draws.sr_seed_clean
    return (draws.wire("r_up", spec.padded),
            draws.wire("r_clean", spec.padded), None, None)


def _int8_uplink(channel_cfg: OTAChannelConfig, g_stack: torch.Tensor,
                 h_loc: torch.Tensor, n_total: int, draws: RoundDraws,
                 idx: int, spec: SlabSpec, mesh, axes, axis_sizes,
                 pilot_stats: bool = False,
                 ef: Optional[torch.Tensor] = None,
                 clean_rows: Optional[torch.Tensor] = None):
    """The quantized MAC of a rank's (R, padded) rows: ONE transmit
    launch a payload (the noisy faded partial sum of ``g_stack`` with the
    carried residual ``ef``; the clean diagnostic sum of ``clean_rows``,
    default ``g_stack``, with h = 1, n_total = 1, no EF), the exchange,
    ONE receive launch a payload on the rank's slice. Returns
    ``(g_slice, clean_slice, stats, ef_new)``: ``stats`` this slice's
    (3,) pilot statistics (None unless ``pilot_stats``), ``ef_new`` the
    fresh (padded,) residual (None without ``ef``)."""
    up = channel_cfg.uplink
    stochastic = up.stochastic_rounding and up.mode == "int8"
    inkernel = (stochastic and up.sr_inkernel
                and g_stack.device.type == "cuda")
    r_noisy, r_clean, seed_noisy, seed_clean = _transmitter_draws(
        channel_cfg, draws, spec, idx, stochastic, inkernel)
    qkw = dict(quantize=True, stochastic=stochastic, qmode=up.mode,
               zero_fold=up.zero_fold)
    tx = ota_transmit_slab(g_stack, h_loc, n_total=n_total, r=r_noisy,
                           sr_seed=seed_noisy, ef=ef,
                           return_residual=ef is not None, **qkw)
    ef_new = tx[2] if ef is not None else None
    if clean_rows is None:
        clean_rows = g_stack
    ones = torch.ones((clean_rows.shape[0],), dtype=torch.float32,
                      device=g_stack.device)
    q_clean, s_clean = ota_transmit_slab(clean_rows, ones, n_total=1,
                                         r=r_clean, sr_seed=seed_clean,
                                         **qkw)
    g_slice, clean_slice, stats = _exchange_and_receive(
        channel_cfg, tx[0], tx[1], q_clean, s_clean, draws, idx, spec,
        mesh, axes, axis_sizes, pilot_stats=pilot_stats)
    if up.zero_fold:
        ef_new = restore_zero_tail(ef_new, spec)
    return g_slice, clean_slice, stats, ef_new


def _exchange_and_receive(channel_cfg: OTAChannelConfig, q_noisy, s_noisy,
                          q_clean, s_clean, draws: RoundDraws, idx: int,
                          spec: SlabSpec, mesh, axes, axis_sizes,
                          pilot_stats: bool = False):
    """Exchange this transmitter's two payloads (packed into uint32
    words first on a packed sign wire) and run the two receive launches
    on the rank's slice; the fold wire re-masks the slice's share of the
    slab's zero tail."""
    n_shards = math.prod(axis_sizes)
    shard_len = spec.shard_len
    off = idx * shard_len
    payload = torch.stack([q_noisy, q_clean]).reshape(
        2, n_shards, shard_len).transpose(0, 1)            # (P, 2, len)
    scales = torch.stack([s_noisy, s_clean]).reshape(
        2, n_shards, shard_len // LANE).transpose(0, 1)
    packed = channel_cfg.uplink.packed_sign
    if packed:
        payload = pack_sign_slab(payload, planes=(packed == "planes"))
    payload, scales = _bucketed_exchange([payload, scales],
                                         channel_cfg.comm_buckets, mesh,
                                         axes, axis_sizes)
    u, e, xi_scale = interference_slab_inputs(draws, channel_cfg, spec)
    u, e = u[off:off + shard_len], e[off:off + shard_len]
    stats = None
    g_slice = ota_receive_slab(
        payload[:, 0].contiguous(), scales[:, 0].contiguous(), u, e,
        alpha=channel_cfg.alpha, scale=xi_scale, packed=packed,
        pilot_stats=pilot_stats)
    if pilot_stats:
        g_slice, stats = g_slice
    clean_slice = ota_receive_slab(
        payload[:, 1].contiguous(), scales[:, 1].contiguous(),
        torch.zeros_like(u), torch.ones_like(e), alpha=channel_cfg.alpha,
        scale=0.0, packed=packed)
    if channel_cfg.uplink.zero_fold:
        g_slice = restore_zero_tail(g_slice, spec, offset=off)
        clean_slice = restore_zero_tail(clean_slice, spec, offset=off)
    return g_slice, clean_slice, stats


# ---------------------------------------------------------------------------
# The overlap engine (comm_buckets > 1).
# ---------------------------------------------------------------------------

def _bucketed_psum_scatter(rows: torch.Tensor, comm_buckets: int, mesh,
                           axes, axis_sizes) -> torch.Tensor:
    """Bucketed reduce-scatter of full-width (R, padded) rows. Rank p
    owns columns [p*shard_len, (p+1)*shard_len) of each row, so bucket b
    takes the (P, B, sub) sub-block view: each of the B reduce-scatters
    moves an (R, P*sub) block whose result is the rank's b-th sub-slice,
    all in flight together."""
    n_shards = math.prod(axis_sizes)
    nrows = rows.shape[0]
    sub = rows.shape[1] // (n_shards * comm_buckets)
    blocks = rows.reshape(nrows, n_shards, comm_buckets, sub)
    outs = _reduce_scatter_chain(
        [blocks[:, :, b, :].reshape(nrows, n_shards * sub)
         for b in range(comm_buckets)], mesh, axes, dim=1)
    return torch.cat(outs, dim=1)


def _bucketed_mac_f32(g_stack: torch.Tensor, coeff: torch.Tensor,
                      comm_buckets: int, mesh, axes, axis_sizes):
    """The overlap engine's resident f32 MAC: a bucket's faded partial
    and clean sum fold as ONE (2, n_local) @ (n_local, cols) product
    over its columns, and its reduce-scatter is issued before the next
    bucket's product. The product reassociates the transmit kernel's
    row sum (the tolerance tier). Returns ``(g_slice, clean_slice)``."""
    n_shards = math.prod(axis_sizes)
    n_loc = g_stack.shape[0]
    sub = g_stack.shape[1] // (n_shards * comm_buckets)
    blocks = g_stack.reshape(n_loc, n_shards, comm_buckets, sub)
    issued = []
    for b in range(comm_buckets):
        with f32_matmul():
            part = coeff @ blocks[:, :, b, :].reshape(n_loc, n_shards * sub)
        issued.append(_issue_reduce_scatter(part, mesh, axes[0], 1))
    outs = _reduce_scatter_chain(_wait(issued), mesh, axes[1:], dim=1)
    both = torch.cat(outs, dim=1)
    return both[0], both[1]


def _bucketed_exchange(xs: List[torch.Tensor], comm_buckets: int, mesh,
                       axes, axis_sizes) -> List[torch.Tensor]:
    """``exchange_uplink_payload`` of each of ``xs``, its per-destination
    columns split into B buckets, all in flight together: value-identical
    to one exchange. ``comm_buckets == 1`` is the plain exchange."""
    if comm_buckets == 1:
        return _exchange_chain(xs, mesh, axes, axis_sizes)
    pieces = []
    for x in xs:
        sub = x.shape[-1] // comm_buckets
        pieces += [x[..., b * sub:(b + 1) * sub] for b in range(comm_buckets)]
    outs = _exchange_chain(pieces, mesh, axes, axis_sizes)
    return [torch.cat(outs[i * comm_buckets:(i + 1) * comm_buckets], dim=-1)
            for i in range(len(xs))]


def _interference(channel_cfg: OTAChannelConfig, draws: RoundDraws,
                  off: int, width: int, g_slice: torch.Tensor, track: bool,
                  fast: bool):
    """The f32 wire's interference on the slice: the round's full-width
    (u, e) sliced, the CMS transform in plain torch (the overlap
    engine's single-exp form when ``fast``), added once after the
    reduction. Returns ``(g_slice, stats)``."""
    if not channel_cfg.interference:
        return g_slice, None
    transform = cms_transform_fast if fast else cms_transform
    xi_slice = channel_cfg.xi_scale * transform(
        draws.u[off:off + width], draws.e[off:off + width],
        channel_cfg.alpha)
    return g_slice + xi_slice, (log_moment_stats(xi_slice) if track
                                else None)


# ---------------------------------------------------------------------------
# The round.
# ---------------------------------------------------------------------------

def _make_bcast_fn(channel_cfg: OTAChannelConfig, spec: SlabSpec, mesh,
                   axes, idx: int):
    """The model broadcast: quantize this rank's slice (int8 downlink
    only; the full-width draw sliced at the rank's offset) and gather it
    to full width. Returns ``(bcast, bcast_start)``: the gather done, or
    left in flight (the overlap runner's prefetch)."""
    shard_len = spec.shard_len
    off = idx * shard_len

    def quantized(w_slice, draws):
        if channel_cfg.downlink != "int8":
            return w_slice
        r_dl = draws.wire("r_dl", spec.padded)[off:off + shard_len]
        return downlink_quantize_slab(w_slice, r_dl)

    def bcast(w_slice, draws):
        return all_gather_slab(quantized(w_slice, draws), mesh, axes)

    def bcast_start(w_slice, draws):
        return _all_gather_start(quantized(w_slice, draws), mesh, axes)

    return bcast, bcast_start


def _make_round_body(loss_fn, channel_cfg: OTAChannelConfig,
                     adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig, mesh,
                     axes, axis_sizes, spec: SlabSpec, dev: torch.device,
                     weights: Optional[torch.Tensor]):
    """The round of one rank: ``body(state, draws, local_batches,
    w_full=None) -> (state, metrics)`` on the rank's slices.
    ``local_batches`` are its clients' rows on the device; ``w_full``
    an already gathered broadcast (the overlap runner's prefetch);
    ``weights`` the clients' aggregation weights on the device."""
    n = fl_cfg.n_clients
    comm_buckets = channel_cfg.comm_buckets
    overlap = comm_buckets > 1
    if overlap and (spec.shard_len // LANE) % comm_buckets != 0:
        raise ValueError(
            f"comm_buckets={comm_buckets} must divide the per-shard "
            f"{LANE}-block count {spec.shard_len // LANE} "
            f"(shard_len={spec.shard_len}); pick a power-of-two "
            f"bucket count or a smaller one")
    n_shards = math.prod(axis_sizes)
    n_local = n // n_shards
    shard_len = spec.shard_len
    idx = linear_shard_index(mesh, axes)
    off = idx * shard_len
    local = slice(idx * n_local, (idx + 1) * n_local)
    client_fn = vmap(client_update(loss_fn, fl_cfg), in_dims=(None, 0))
    has_cast = any(dt != torch.float32 for dt in spec.dtypes)
    uplink = channel_cfg.uplink
    use_ef = uplink.error_feedback
    dl_int8 = channel_cfg.downlink == "int8"
    track = adaptive_cfg.track_alpha
    dynamic = fl_cfg.dynamic_round
    dynamic_norm = fl_cfg.dynamic_norm
    bcast, _ = _make_bcast_fn(channel_cfg, spec, mesh, axes, idx)
    server_step = make_server_step(adaptive_cfg, dev, slab_update_slabs)
    f32 = torch.float32

    def psum(x):
        return psum_axes(x, mesh, axes)

    def f32_finish(draws, acc, clean, norm_safe=None):
        """The f32 wire's superposition of the rank's faded partial and
        clean sum: a reduce-scatter (bucketed on the overlap engine)
        hands each rank its slice, which takes the participation norm,
        if any, and the interference: (g_slice, clean_slice, stats)."""
        rows = torch.stack([acc, clean])
        if overlap:
            both = _bucketed_psum_scatter(rows, comm_buckets, mesh, axes,
                                          axis_sizes)
        else:
            both = psum_scatter_slab(rows, mesh, axes, dim=1)
        g_slice = both[0] if norm_safe is None else both[0] / norm_safe
        g_slice, stats = _interference(channel_cfg, draws, off, shard_len,
                                       g_slice, track, overlap)
        return g_slice, both[1], stats

    def resident_mac(params, batches, draws, ef):
        """Steps 2-4 with every local client resident: (g_slice,
        clean_slice, stats, ef_new, loss_in)."""
        grads, losses = client_fn(params, batches)
        h_loc = draws.h[local]
        g_stack = stack_to_slab(spec, grads)
        del grads
        stats = ef_new = None
        if uplink.quantized:
            g_slice, clean_slice, stats, ef_new = _int8_uplink(
                channel_cfg, g_stack, h_loc, n, draws, idx, spec, mesh,
                axes, axis_sizes, pilot_stats=track, ef=ef)
        elif overlap:
            coeff = torch.stack([h_loc * (1.0 / n), torch.ones_like(h_loc)])
            g_slice, clean_slice = _bucketed_mac_f32(
                g_stack, coeff, comm_buckets, mesh, axes, axis_sizes)
            g_slice, stats = _interference(channel_cfg, draws, off,
                                           shard_len, g_slice, track, True)
        else:
            # B3a: the faded partial over the local rows, no carry
            g_slice, clean_slice, stats = f32_finish(
                draws, ota_transmit_slab(g_stack, h_loc, n_total=n),
                torch.sum(g_stack, dim=0))
        return g_slice, clean_slice, stats, ef_new, torch.mean(losses)

    def streamed_mac(params, batches, draws, ef, mask, gain, norm_safe):
        """Steps 2-4 with the local clients streamed in chunks
        (``core.stream.fold_chunks`` over the rank's rows), ``norm_safe``
        the participation norm (None under the static 1/N): (g_slice,
        clean_slice, stats, ef_new, loss_sum)."""
        h_eff = draws.h * gain if dynamic_norm else draws.h
        acc, clean, loss_sum = fold_chunks(
            client_fn, params, spec, lambda rows: take_rows(batches, rows),
            h_eff[local], mask[local], 1 if dynamic_norm else n, fl_cfg)
        stats = ef_new = None
        if uplink.quantized:
            # the noisy partial pre-divided by the participation norm
            # before quantization; the clean one stays raw
            noisy = acc if norm_safe is None else acc / norm_safe
            one = torch.ones((1,), dtype=f32, device=dev)
            g_slice, clean_slice, stats, ef_new = _int8_uplink(
                channel_cfg, noisy[None], one, 1, draws, idx, spec, mesh,
                axes, axis_sizes, pilot_stats=track, ef=ef,
                clean_rows=clean[None])
        else:
            g_slice, clean_slice, stats = f32_finish(draws, acc, clean,
                                                     norm_safe)
        return g_slice, clean_slice, stats, ef_new, loss_sum

    def body(state: SlabTrainState, draws: RoundDraws, batches,
             w_full=None):
        ef = state.ef[0] if use_ef else None
        # 1. model broadcast: slices -> full slab -> parameter views
        if w_full is None:
            w_full = bcast(state.w, draws)
        params = slab_to_tree(spec, w_full)
        ok = None
        if not dynamic:
            g_slice, clean_slice, stats, ef_new, loss_in = resident_mac(
                params, batches, draws, ef)
            loss_div = fill(n_shards, dev)
            den = n_part = fill(n, dev)
        else:
            mask, gain = round_participation(draws, fl_cfg, weights)
            n_part = torch.sum(mask)
            norm_safe = None
            if dynamic_norm:
                norm = torch.sum(gain)
                # a round nobody took part in leaves the state as it was
                ok = norm > 0.0
                norm_safe = torch.where(ok, norm, torch.ones_like(norm))
            g_slice, clean_slice, stats, ef_new, loss_in = streamed_mac(
                params, batches, draws, ef, mask, gain, norm_safe)
            den = loss_div = torch.clamp_min(n_part, 1.0)

        # the round's cross-rank sums: the loss, the norms' squared sums
        # and the pilot statistics (fused into one all-reduce on the
        # overlap engine)
        clean_sq = torch.sum(torch.square(clean_slice))
        noisy_sq = torch.sum(torch.square(g_slice))
        if track and stats is None:      # interference off: no residual
            stats = torch.zeros((3,), dtype=f32, device=dev)
        if overlap:
            red = psum(torch.cat([loss_in[None], clean_sq[None],
                                  noisy_sq[None]]
                                 + ([stats] if track else [])))
            loss_sum, clean_sq, noisy_sq = red[0], red[1], red[2]
            stats = red[3:6] if track else None
        else:
            loss_sum = psum(loss_in)
            if track:
                stats = psum(stats)

        # 5. the server update on the rank's resident slices; non-f32
        # leaves round-trip through their storage dtype (under the int8
        # downlink the master, regathered, never the broadcast)
        w_in = state.w
        if has_cast:
            w_in = storage_round_trip(
                spec, params, all_gather_slab(state.w, mesh, axes)
                if dl_int8 else None)[off:off + shard_len]
        alpha_hat, alpha_metric, opt, w, ef = server_step(
            state, g_slice, stats, w_in, ef_new, ok)
        metrics = RoundMetrics(
            loss=loss_sum / loss_div,
            grad_norm=torch.sqrt(psum(clean_sq) if not overlap
                                 else clean_sq) / den,
            noisy_grad_norm=torch.sqrt(psum(noisy_sq) if not overlap
                                       else noisy_sq),
            fading_mean=torch.mean(draws.h),
            alpha_hat=alpha_metric,
            n_participants=n_part)
        return SlabTrainState(state.step + 1, w, opt, alpha_hat, spec,
                              ef), metrics

    return body


# ---------------------------------------------------------------------------
# Checks, state boundaries and drivers.
# ---------------------------------------------------------------------------

def _validate_mesh(fl_cfg: FLConfig, mesh, dev: torch.device
                   ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    if not isinstance(mesh, DeviceMesh) or not dist.is_initialized():
        raise ValueError(
            "mesh= needs a torch.distributed DeviceMesh over an initialised "
            "process group (the launchers start one: "
            "repro_torch.launch.mesh.run_on_mesh)")
    if mesh.mesh_dim_names is None:
        raise ValueError("mesh has no dim names; name its dims (client "
                         "dims, and 'model' for any that carries none)")
    axes = client_axes_of(mesh)
    if not axes:
        raise ValueError("mesh has no client-carrying axes (all axes are "
                         "'model'); the sharded slab engine needs at least "
                         "one")
    n_shards = n_client_shards(mesh)
    n = fl_cfg.n_clients
    shape = {a: _axis_size(mesh, a) for a in mesh.mesh_dim_names}
    if n % n_shards != 0:
        raise ValueError(
            f"n_clients={n} must be divisible by the mesh's client-shard "
            f"count {n_shards} (axes {axes} of mesh shape {shape})")
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is a {mesh.device_type} mesh, the round "
                         f"runs on {dev}")
    want = BACKENDS[dev.type]
    for a in axes:
        got = dist.get_backend(mesh.get_group(a))
        if got != want:
            raise ValueError(
                f"a {dev.type} mesh runs its collectives over {want}, but "
                f"the group of mesh dim {a!r} is {got}: start the process "
                f"group with backend={want!r}")
    check_cards(mesh.size(), dev.type)
    return axes, tuple(_axis_size(mesh, a) for a in axes)


def _check_spec_shards(spec: SlabSpec, n_shards: int) -> None:
    if spec.shards != n_shards:
        raise ValueError(
            f"SlabTrainState was laid out for shards={spec.shards} but the "
            f"mesh has {n_shards} client shards; build the state with "
            f"init_train_state(..., shards={n_shards})")


def _check_rank_state(state: SlabTrainState, use_ef: bool, n_shards: int,
                      dev: torch.device) -> None:
    """The state must be this rank's slices (``shard_train_state``), on
    the round's device, with its transmitter's EF row when EF is on."""
    _check_spec_shards(state.spec, n_shards)
    if tuple(state.w.shape) != (state.spec.shard_len,):
        raise ValueError(
            f"SlabTrainState.w has shape {tuple(state.w.shape)}, a rank's "
            f"slice is ({state.spec.shard_len},): pass the rank's slices "
            "(shard_train_state)")
    check_state(state, dev, use_ef)
    if use_ef and tuple(state.ef.shape) != (1, state.spec.padded):
        raise ValueError(
            f"SlabTrainState.ef has shape {tuple(state.ef.shape)}; a rank "
            f"carries its transmitter's row, (1, {state.spec.padded}) "
            "(shard_train_state)")


def shard_train_state(state: SlabTrainState, mesh) -> SlabTrainState:
    """This rank's slices of a resident (full-width) state: ``w`` and
    the optimizer rows at its offset, its transmitter's EF row. The
    state must be laid out for the mesh's shard count."""
    axes = client_axes_of(mesh)
    _check_spec_shards(state.spec, n_client_shards(mesh))
    idx = linear_shard_index(mesh, axes)
    length = state.spec.shard_len
    sl = slice(idx * length, (idx + 1) * length)
    return SlabTrainState(
        step=state.step.clone(), w=state.w[sl].clone(),
        opt=tuple(o[sl].clone() for o in state.opt),
        alpha_hat=state.alpha_hat.clone(), spec=state.spec,
        ef=None if state.ef is None else state.ef[idx:idx + 1].clone())


def gather_train_state(state: SlabTrainState, mesh) -> SlabTrainState:
    """The resident (full-width) state from every rank's slices: a
    collective, called on every rank; each gets the whole state."""
    axes = client_axes_of(mesh)
    return SlabTrainState(
        step=state.step, w=all_gather_slab(state.w, mesh, axes),
        opt=tuple(all_gather_slab(o, mesh, axes) for o in state.opt),
        alpha_hat=state.alpha_hat, spec=state.spec,
        ef=None if state.ef is None else all_gather_slab(state.ef, mesh,
                                                         axes))


def make_shard_slab_step(loss_fn, channel_cfg: OTAChannelConfig,
                         adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig,
                         mesh, device: DeviceLike = None):
    """One resident round over ``mesh``: ``step(state, draws,
    client_batches) -> (state, metrics)``, called on every rank.
    ``state`` is the rank's slices (``shard_train_state``), ``draws`` its
    ``RoundDraws`` (the transmitter's own under a stochastically rounded
    uplink: ``TorchDraws(..., shard_index=...)``), ``client_batches``
    leaves with the global client axis N up front (the rank takes its
    N/P rows). The metrics are the same on every rank. No full-model
    regather: the round ends with the updated slices in place."""
    dev = resolve_device(device)
    axes, axis_sizes = _validate_mesh(fl_cfg, mesh, dev)
    n_shards = math.prod(axis_sizes)
    use_ef = channel_cfg.uplink.error_feedback
    idx = linear_shard_index(mesh, axes)
    n_local = fl_cfg.n_clients // n_shards
    # made here: a copy from the host, never inside a round
    weights = client_weight_array(fl_cfg, dev)
    bodies = {}

    def step(state: SlabTrainState, draws: RoundDraws, client_batches,
             w_full=None):
        _check_rank_state(state, use_ef, n_shards, dev)
        if state.spec not in bodies:
            bodies[state.spec] = _make_round_body(
                loss_fn, channel_cfg, adaptive_cfg, fl_cfg, mesh, axes,
                axis_sizes, state.spec, dev, weights)
        # the rank's clients' rows, sliced before they move
        draws, batches = round_inputs(
            dev, fl_cfg, draws,
            tree_map(lambda x: x[idx * n_local:(idx + 1) * n_local],
                     client_batches))
        return bodies[state.spec](state, draws, batches, w_full)

    return step


def make_shard_slab_runner(loss_fn, channel_cfg: OTAChannelConfig,
                           adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig,
                           mesh, device: DeviceLike = None):
    """R resident rounds over ``mesh`` as a host loop: ``run(state,
    draws, client_batches) -> (state, metrics)`` with ``draws`` the R
    rounds' ``RoundDraws`` of this rank and ``client_batches`` leaves
    shaped (R, N, ...); metrics come back stacked (R,). Usable with
    ``core.fl.run_rounds_slab``. On the overlap engine
    (``comm_buckets > 1``) round t's body is followed by round t+1's
    broadcast, left in flight across the round boundary."""
    step = make_shard_slab_step(loss_fn, channel_cfg, adaptive_cfg, fl_cfg,
                                mesh, device)
    prefetch = channel_cfg.comm_buckets > 1
    axes = client_axes_of(mesh)
    idx = linear_shard_index(mesh, axes)

    def run(state: SlabTrainState, draws: Sequence[RoundDraws],
            client_batches):
        ms: List[RoundMetrics] = []
        pending = None
        for r in range(len(draws)):
            if prefetch and pending is None:
                _, start = _make_bcast_fn(channel_cfg, state.spec, mesh,
                                          axes, idx)
                pending = start(state.w, draws[r].to(state.w.device))
            state, m = step(state, draws[r],
                            tree_map(lambda x: x[r], client_batches),
                            w_full=pending() if prefetch else None)
            if prefetch and r + 1 < len(draws):
                # round t+1's broadcast, issued with its own draws
                pending = start(state.w, draws[r + 1].to(state.w.device))
            ms.append(m)
        return state, RoundMetrics(*(torch.stack(f) for f in zip(*ms)))

    return run


def shard_round_step(loss_fn, channel_cfg: OTAChannelConfig,
                     adaptive_cfg: AdaptiveConfig, fl_cfg: FLConfig, mesh,
                     device: DeviceLike = None):
    """The per-round pytree API over the sharded engine:
    ``round_step(params, opt_state, draws, client_batches)`` with full
    pytrees in and out on every rank (``make_round_step(
    backend="pallas_sharded")``). It packs at the call boundary, gives
    each rank its slices, runs the resident round once and gathers the
    pytrees back; multi-round training should hold the rank's
    ``SlabTrainState`` and use the step or the runner instead."""
    if adaptive_cfg.track_alpha:
        raise ValueError(
            'AdaptiveConfig.alpha == "auto" needs the resident loop '
            '(make_shard_slab_step / make_shard_slab_runner): the pytree-'
            'per-round wrapper re-packs the state every call, which would '
            'reset the estimator EMA each round')
    if channel_cfg.uplink.error_feedback:
        raise ValueError(
            "error_feedback needs the resident loop (make_shard_slab_step "
            "/ make_shard_slab_runner): the pytree-per-round wrapper "
            "re-packs the state every call, which would zero the carried "
            "residual each round")
    inner = make_shard_slab_step(loss_fn, channel_cfg, adaptive_cfg, fl_cfg,
                                 mesh, device)
    n_shards = n_client_shards(mesh)

    def round_step(params, opt_state, draws: RoundDraws, client_batches):
        spec = make_slab_spec(params, shards=n_shards)
        state = shard_train_state(
            pack_train_state(adaptive_cfg, spec, params, opt_state), mesh)
        state, metrics = inner(state, draws, client_batches)
        new_params, new_state = unpack_train_state(
            adaptive_cfg, gather_train_state(state, mesh))
        return new_params, new_state, metrics

    return round_step
