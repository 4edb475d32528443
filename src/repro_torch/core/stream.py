"""Streamed client axis: O(chunk * d) rounds, participation, weights.

PyTorch counterpart of ``repro.core.stream``. The resident round stacks
all N client gradients into one (N, d) slab before the MAC. Here the
round walks the client population in chunks of ``FLConfig.client_chunk``
rows instead: each chunk's gradients are computed, faded and folded into
the running (d,) partial by the accumulating transmit kernel
(``ota_transmit_slab(..., acc=...)``), and only the completed partial
crosses the channel. Peak memory is O(chunk * d) whatever N is.

Two wireless extensions ride on the same stage, both folded into the
EFFECTIVE fading next to power control:

* **Partial participation** (``FLConfig.sample_rate``): the (N,) {0, 1}
  mask comes in with the round's draws (``RoundDraws.mask``), one full
  draw per round, sliced per chunk and never redrawn per chunk.
* **Per-client aggregation weights** (``FLConfig.client_weights``).

With either active the 1/N normaliser becomes ``1 / sum_n mask_n w_n``:
the transmit launches accumulate the raw weighted faded sum
(``n_total=1``) and the divisor is applied once to the completed
partial, guarded against the dead round (``norm_safe``; the round then
skips the server update, see ``core.fl``). Without them the static 1/N
stays in the kernel.

The finish stage pushes the completed partial through a single-row
launch of the resident round's kernels (``sum(1 * x) / 1 == x`` exactly
in f32). So with ``chunk >= N``, full participation and no weights, the
streamed round runs the resident round's operations: the transmit
kernel sums the rows in the channel kernel's order, and the round is
bitwise the resident one.

The JAX function's ``use_kernels`` flag has no twin: the device of the
tensors decides, as everywhere in the port.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.channel import OTAChannelConfig
from repro_torch.core.draws import RoundDraws, participation_mask
from repro_torch.core.ota import mac_slab
from repro_torch.core.slab import SlabSpec, stack_to_slab, tree_map
from repro_torch.kernels.ota_channel import ota_transmit_slab

PyTree = Any

__all__ = ["StreamParts", "client_weight_array", "participation_mask",
           "round_participation", "streamed_round_parts"]


def client_weight_array(fl_cfg, device=None) -> Optional[torch.Tensor]:
    """The (N,) f32 aggregation-weight vector, or None when uniform."""
    if fl_cfg.client_weights is None:
        return None
    return torch.tensor(fl_cfg.client_weights, dtype=torch.float32,
                        device=device)


def round_participation(draws: RoundDraws, fl_cfg,
                        weights: Optional[torch.Tensor] = None):
    """(mask, gain) of this round: the {0, 1} participation mask (from
    ``draws.mask`` under ``sample_rate < 1``, all-ones otherwise) and the
    per-client transmit gain (mask * weights) that multiplies the fading
    draw. ``weights`` is ``client_weight_array(fl_cfg)`` made once by
    the caller on the draws' device; None makes it here."""
    n = fl_cfg.n_clients
    dev = draws.h.device
    if fl_cfg.sample_rate < 1.0:
        mask = draws.mask
        if mask is None or tuple(mask.shape) != (n,):
            raise ValueError(
                f"sample_rate {fl_cfg.sample_rate} needs draws.mask of shape "
                f"({n},), got {None if mask is None else tuple(mask.shape)}; "
                "make the draws with TorchDraws(..., sample_rate=...)")
    elif draws.mask is not None:
        raise ValueError("draws.mask is set but FLConfig.sample_rate is 1: "
                         "every client takes part")
    else:
        mask = torch.ones((n,), dtype=torch.float32, device=dev)
    if weights is None:
        weights = client_weight_array(fl_cfg, dev)
    gain = mask if weights is None else mask * weights
    return mask, gain


class StreamParts(NamedTuple):
    """Everything one streamed uplink pass produces (single device)."""
    g_slab: torch.Tensor          # (padded,) noisy aggregate
    h: torch.Tensor               # (N,) raw fading draw (for metrics)
    mask: torch.Tensor            # (N,) participation mask
    n_participants: torch.Tensor  # 0-dim f32: sum(mask)
    norm: torch.Tensor            # 0-dim f32 normaliser: sum(mask * w)
    loss_sum: torch.Tensor        # sum of participating clients' losses
    clean_slab: torch.Tensor      # (padded,) unfaded participant sum
    stats: Optional[torch.Tensor]  # (3,) pilot log-moments
    ef_new: Optional[torch.Tensor] = None  # (padded,) fresh EF residual


@contextlib.contextmanager
def _f32_matmul():
    """Full-f32 matrix products for the double-buffered fold: TF32 (or
    bf16 passes on the CPU) would move it by ~1e-3, whatever the caller
    set globally."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def streamed_round_parts(draws: RoundDraws, channel_cfg: OTAChannelConfig,
                         fl_cfg, spec: SlabSpec, client_fn: Callable,
                         params: PyTree, client_batches: PyTree = None,
                         batch_gen: Optional[Callable] = None,
                         pilot_stats: bool = False,
                         ef: Optional[torch.Tensor] = None,
                         weights: Optional[torch.Tensor] = None
                         ) -> StreamParts:
    """One streamed uplink pass: walk the client axis in chunks, fold
    each chunk into the running partial through the accumulating
    transmit kernel, then push the completed partial through the
    single-row channel (or quantize + receive) launch.

    ``client_fn(params, batch) -> (grads, losses)`` is the vmapped
    client update (leaves with a leading client axis). ``client_batches``
    holds per-client batches on the device (leaves (N, ...), sliced per
    chunk); ``batch_gen(draws, idx)`` instead makes the batch of the
    client rows ``idx`` (an int64 tensor on the device), for populations
    too large to hold. Exactly one of the two.

    A chunk that does not divide N leaves a ragged final chunk: its rows
    past N re-read row N-1, and their zero fading and mask fold exactly
    0 into every sum. ``ef`` is the carried (padded,) error-feedback
    residual: it joins the completed partial before the finish stage's
    quantizer (quantized uplink only); the fresh one comes back as
    ``ef_new``. ``weights`` as in ``round_participation``.
    """
    cfg = channel_cfg
    n = fl_cfg.n_clients
    chunk = min(fl_cfg.client_chunk or n, n)
    if (client_batches is None) == (batch_gen is None):
        raise ValueError("pass exactly one of client_batches / batch_gen")
    if ef is not None and not cfg.uplink.quantized:
        raise ValueError("ef= (error feedback) needs a quantized uplink; "
                         'the "f32" payload has no residual')
    h = draws.h
    if tuple(h.shape) != (n,):
        raise ValueError(f"draws.h must be ({n},), got {tuple(h.shape)}")
    dev = h.device
    f32 = torch.float32

    mask, gain = round_participation(draws, fl_cfg, weights)
    dynamic_norm = fl_cfg.dynamic_norm
    # With neither sampling nor weights, h_eff is h and the static 1/N
    # divisor stays in the kernel.
    h_eff = h * gain if dynamic_norm else h
    n_div = 1 if dynamic_norm else n
    # Ragged final chunk: zero rows pad the per-row operands; the draws
    # were taken at full (N,) before padding.
    n_chunks = -(-n // chunk)
    n_padded = n_chunks * chunk
    ragged = n_padded != n
    if ragged:
        h_sched = F.pad(h_eff, (0, n_padded - n))
        mask_sched = F.pad(mask, (0, n_padded - n))
    else:
        h_sched, mask_sched = h_eff, mask

    def produce(c):
        """Chunk c's client compute and per-row operands: one slot of
        the double-buffered pipeline."""
        start = c * chunk
        if batch_gen is not None or ragged:
            idx = torch.arange(start, start + chunk, device=dev)
            if ragged:
                # padding rows re-read row N-1 (with zero gain and mask)
                idx = torch.clamp_max(idx, n - 1)
        if batch_gen is not None:
            batch = batch_gen(draws, idx)
        elif ragged:
            batch = tree_map(lambda b: b.index_select(0, idx),
                             client_batches)
        else:
            batch = tree_map(lambda b: b[start:start + chunk],
                             client_batches)
        grads, losses = client_fn(params, batch)
        g_stack = stack_to_slab(spec, grads)
        return (g_stack, h_sched[start:start + chunk],
                mask_sched[start:start + chunk], losses)

    def fold(acc, clean, loss_sum, slot):
        """Double-buffered fold: the faded and clean partials of a
        completed slot reduce together as one (2, chunk) @ (chunk, d)
        product (one read of the gradient stack), which reassociates the
        chunk's sum: the tolerance tier of ``FLConfig.double_buffer``."""
        g_stack, h_c, m_c, losses = slot
        coeff = torch.stack([h_c * (1.0 / n_div), m_c])
        with _f32_matmul():
            both = coeff @ g_stack
        return (acc + both[0], clean + both[1],
                loss_sum + torch.sum(m_c * losses))

    zeros = torch.zeros((spec.padded,), dtype=f32, device=dev)
    if n == chunk:
        # A single chunk: the resident compute feeding the transmit
        # kernel once, with no slicing.
        batch = (batch_gen(draws, torch.arange(n, device=dev))
                 if batch_gen is not None else client_batches)
        grads, losses = client_fn(params, batch)
        g_stack = stack_to_slab(spec, grads)
        acc = ota_transmit_slab(g_stack, h_eff, n_total=n_div, acc=zeros)
        clean = torch.sum(mask[:, None] * g_stack, dim=0)
        loss_sum = torch.sum(mask * losses)
    elif fl_cfg.double_buffer:
        # Chunk 0 fills the slot; then produce(c) is issued before
        # fold(c - 1), and the last slot drains after the loop. Same
        # draws, chunks and batches as the serial loop: only the order
        # of the accumulation moves.
        acc, clean = zeros, zeros
        loss_sum = torch.zeros((), dtype=f32, device=dev)
        slot = produce(0)
        for c in range(1, n_chunks):
            new_slot = produce(c)
            acc, clean, loss_sum = fold(acc, clean, loss_sum, slot)
            slot = new_slot
        acc, clean, loss_sum = fold(acc, clean, loss_sum, slot)
    else:
        acc, clean = zeros, zeros
        loss_sum = torch.zeros((), dtype=f32, device=dev)
        for c in range(n_chunks):
            g_stack, h_c, m_c, losses = produce(c)
            acc = ota_transmit_slab(g_stack, h_c, n_total=n_div, acc=acc)
            clean = clean + torch.sum(m_c[:, None] * g_stack, dim=0)
            loss_sum = loss_sum + torch.sum(m_c * losses)

    n_part = torch.sum(mask)
    norm = torch.sum(gain) if dynamic_norm else n_part
    if dynamic_norm:
        # Dead-round guard: divide by 1 (the partial is all zero anyway)
        # and let the round skip the update; max(norm, 1) would corrupt
        # rounds whose weights sum below 1.
        norm_safe = torch.where(norm > 0.0, norm, torch.ones_like(norm))
        g_pre = acc / norm_safe
    else:
        g_pre = acc

    # Finish: the completed partial crosses the channel through the
    # resident round's kernels as one transmitter row.
    one = torch.ones((1,), dtype=f32, device=dev)
    g_slab, stats, ef_new = mac_slab(draws, cfg, spec, g_pre[None], one,
                                     pilot_stats=pilot_stats, ef=ef,
                                     n_total=1)
    return StreamParts(g_slab=g_slab, h=h, mask=mask,
                       n_participants=n_part, norm=norm, loss_sum=loss_sum,
                       clean_slab=clean, stats=stats, ef_new=ef_new)
