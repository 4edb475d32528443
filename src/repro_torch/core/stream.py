"""Streamed client axis: O(chunk * d) rounds, participation, weights.

PyTorch counterpart of ``repro.core.stream``. The resident round stacks
all N client gradients into one (N, d) slab before the MAC. Here the
round walks the client population in chunks of ``FLConfig.client_chunk``
rows instead: each chunk's gradients are computed, faded and folded into
the running (d,) partial by the accumulating transmit kernel
(``ota_transmit_slab(..., acc=...)``, which in the serial loop also
carries the participants' clean sum from the same read of the stack),
and only the completed partial crosses the channel. Peak memory is
O(chunk * d) whatever N is.

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
from repro_torch.spans import span

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
def f32_matmul():
    """Full-f32 matrix products for a fold written as a GEMM: TF32 (or
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


def take_rows(batches: PyTree, rows) -> PyTree:
    """Rows of per-client batch leaves: ``rows`` a ``slice`` (views) or
    an int64 index tensor on the device."""
    if isinstance(rows, slice):
        return tree_map(lambda b: b[rows], batches)
    return tree_map(lambda b: b.index_select(0, rows), batches)


def fold_chunks(client_fn: Callable, params: PyTree, spec: SlabSpec,
                batch_rows: Callable, h_eff: torch.Tensor,
                mask: torch.Tensor, n_div: int, fl_cfg):
    """The streamed client axis over R rows (all N clients, or a rank's
    own) in chunks of ``fl_cfg.client_chunk``: each chunk's gradients,
    faded by its rows of ``h_eff``, fold into the running partial in the
    accumulating transmit, which carries the masked clean sum from the
    same read of the stack. Returns ``(acc, clean, loss_sum)``: the faded
    partial (over ``n_div``), the participants' clean sum and summed loss.

    ``batch_rows(rows)`` is the batch of ``rows``: a ``slice``, or for a
    ragged last chunk an index tensor whose rows past R re-read row R-1
    (their zero fading and mask fold in exactly 0). One chunk feeds the
    no-carry transmit once, in the channel kernel's row order.
    ``fl_cfg.double_buffer`` issues chunk c's clients before folding
    chunk c-1 as one (2, chunk) @ (chunk, d) product (its tolerance
    tier)."""
    n = h_eff.shape[0]
    dev = h_eff.device
    chunk = min(fl_cfg.client_chunk or n, n)
    n_chunks = -(-n // chunk)
    ragged = n_chunks * chunk != n
    if ragged:
        # the draws were taken at full width before this padding
        h_eff = F.pad(h_eff, (0, n_chunks * chunk - n))
        mask = F.pad(mask, (0, n_chunks * chunk - n))

    def produce(c):
        """Chunk c's client compute and per-row operands: one slot of
        the double-buffered pipeline."""
        start = c * chunk
        with span("clients"):
            rows = slice(start, start + chunk)
            if ragged:
                rows = torch.clamp_max(
                    torch.arange(start, start + chunk, device=dev), n - 1)
            grads, losses = client_fn(params, batch_rows(rows))
        return (stack_to_slab(spec, grads), h_eff[start:start + chunk],
                mask[start:start + chunk], losses)

    def fold(acc, clean, loss_sum, slot):
        g_stack, h_c, m_c, losses = slot
        coeff = torch.stack([h_c * (1.0 / n_div), m_c])
        with f32_matmul():
            both = coeff @ g_stack
        return (acc + both[0], clean + both[1],
                loss_sum + torch.sum(m_c * losses))

    if n_chunks == 1:
        g_stack, h_c, m_c, losses = produce(0)
        return (ota_transmit_slab(g_stack, h_c, n_total=n_div),
                torch.sum(m_c[:, None] * g_stack, dim=0),
                torch.sum(m_c * losses))
    acc = clean = torch.zeros((spec.padded,), dtype=torch.float32,
                              device=dev)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    if fl_cfg.double_buffer:
        slot = produce(0)
        for c in range(1, n_chunks):
            new_slot = produce(c)
            acc, clean, loss_sum = fold(acc, clean, loss_sum, slot)
            slot = new_slot
        return fold(acc, clean, loss_sum, slot)
    for c in range(n_chunks):
        g_stack, h_c, m_c, losses = produce(c)
        # one read of the stack for both carries (out of place: acc and
        # clean start as the one zeros tensor)
        acc, clean = ota_transmit_slab(g_stack, h_c, n_total=n_div,
                                       acc=acc, clean=clean, mask=m_c)
        loss_sum = loss_sum + torch.sum(m_c * losses)
    return acc, clean, loss_sum


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

    The chunks (a ragged last one included) are ``fold_chunks``'. ``ef``
    is the carried (padded,) error-feedback residual: it joins the
    completed partial before the finish stage's quantizer (quantized
    uplink only); the fresh one comes back as ``ef_new``. ``weights`` as
    in ``round_participation``.
    """
    cfg = channel_cfg
    n = fl_cfg.n_clients
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
    if batch_gen is not None:
        def batch_rows(rows):
            if isinstance(rows, slice):
                rows = torch.arange(rows.start, rows.stop, device=dev)
            return batch_gen(draws, rows)
    else:
        def batch_rows(rows):
            return take_rows(client_batches, rows)
    # With neither sampling nor weights, h_eff is h and the static 1/N
    # divisor stays in the kernel.
    acc, clean, loss_sum = fold_chunks(
        client_fn, params, spec, batch_rows,
        h * gain if dynamic_norm else h, mask,
        1 if dynamic_norm else n, fl_cfg)

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
