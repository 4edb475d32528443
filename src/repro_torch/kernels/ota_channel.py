"""OTA uplink kernels: the fused f32 channel and the quantized wire's
transmit / receive pair.

PyTorch counterpart of ``repro.kernels.ota_channel``:

* ``ota_channel_slab`` — the f32 uplink in one pass over the stacked
  (N, d) gradient slab:
  ``out = (1/n_total) sum_n h[n] G[n, :] + scale * CMS(u, e, alpha)``;
* ``ota_transmit_slab(quantize=True)`` — the transmitter: the faded
  partial sum (plus the error-feedback residual), quantized on write to
  an int8 or sign payload with one f32 scale per 128-block, and the
  fresh residual;
* ``ota_transmit_slab(quantize=False)`` — the f32 faded partial sum,
  optionally accumulated into a running (d,) carry ``acc`` over client
  row chunks (``row_chunk``): the streamed client axis's transmitter.
  Its kernel splits the rows into ``row_split`` segments across blocks
  and folds them in a fixed order (``ota_transmit_split_model``). With
  ``clean=`` and ``mask=`` the same launch also carries the round's
  unfaded masked sum;
* ``ota_receive_slab`` — the server's front end: dequantizes and sums R
  payload rows (the int8 container, or the packed sign words of
  ``pack_sign_slab``) and adds the CMS interference.

The channel and receive kernels carry the optional pilot-statistics
epilogue ``[count, sum log|r|, sum log^2|r|]`` over the nonzero
residuals r = scale * xi (the closed alpha loop's input); the receive
kernel folds its blocks' rows itself, in the same launch.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/ota_channel.cu``, ``csrc/ota_transmit.cu``,
``csrc/ota_transmit_stream.cu``, ``csrc/ota_receive.cu``) or raises. On
a CPU tensor it runs the plain version in ``kernels.ref``. Nothing else
selects between the two. ``ota_transmit_slab`` counts its two kernels
apart: ``launches`` for the quantize-on-write kernel, ``stream_launches``
for the f32 (accumulating) one, of which ``nocarry_launches`` are the
calls without a carry (the TPU package's separate no-carry kernel, B3a)
and ``clean_launches`` the calls that carry the clean sum.
``ota_receive_slab.stats_launches`` counts its launches that fold the
pilot statistics.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.channel import CMS_E_FLOOR, CMS_U_BOUND
from repro_torch.kernels import build
from repro_torch.kernels.ref import (INT8_MAX, LANE, ota_channel_ref,
                                     ota_receive_ref, ota_transmit_ref,
                                     pack_sign_slab, sign_words,
                                     unpack_sign_slab)

__all__ = ["CHANNEL_TILE", "INT8_MAX", "LANE", "RECEIVE_THREADS",
           "channel_blocks", "ota_channel_slab", "ota_receive_slab",
           "ota_transmit_slab", "ota_transmit_split_model", "pack_sign_slab",
           "receive_blocks", "row_split", "segment_rows", "sign_words",
           "unpack_sign_slab"]

# The channel kernel (csrc/ota_channel.cu): a block owns CHANNEL_TILE
# columns and streams every row through them (4 warps, 4 columns a
# thread) while 8 more warps compute the CMS term; one statistics row a
# block. The quantize transmit (csrc/ota_transmit.cu) takes the same
# tiles, channel_blocks(d) of them: its 4 walker warps are the tile's 4
# quantization blocks of LANE columns, and 4 more warps stage ef and the
# rounding uniforms.
CHANNEL_TILE = 512
# The receive kernel (csrc/ota_receive.cu): RECEIVE_THREADS a block, one
# column a thread, so that its whole grid is resident on the card at
# once.
RECEIVE_THREADS = 256
# Quant values of csrc/ota_transmit.cu.
_QUANT = {("int8", "host"): 0, ("int8", "kernel"): 1, ("int8", "rtn"): 2,
          ("sign", False): 3, ("sign", True): 4}
_PACKED = {None: 0, "fold": 1, "planes": 2}


def ota_channel_slab(grads: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                     e: torch.Tensor, *, alpha: float, scale: float,
                     n_total: Optional[int] = None,
                     pilot_stats: bool = False):
    """Fused f32 channel: grads (N, d) stacked client gradients, h (N,)
    fading, u (d,) angles, e (d,) Exp(1) draws. Returns the (d,) f32
    noisy aggregate, and with ``pilot_stats=True`` also the (3,)
    residual statistics as ``(out, stats)``. ``n_total`` overrides the
    1/N normalisation (defaults to N)."""
    if not (1.0 < alpha <= 2.0):
        raise ValueError(f"tail index alpha must be in (1, 2], got {alpha}")
    if grads.device.type == "cpu":
        return ota_channel_ref(grads, h, u, e, alpha=alpha, scale=scale,
                               n_total=n_total, pilot_stats=pilot_stats)
    if grads.device.type != "cuda":
        raise ValueError(f"ota_channel_slab takes cuda or cpu tensors, got "
                         f"{grads.device}")
    if grads.dim() != 2:
        raise ValueError(f"grads must be (N, d), got {tuple(grads.shape)}")
    n, d = grads.shape
    for name, t, shape in (("grads", grads, (n, d)), ("h", h, (n,)),
                           ("u", u, (d,)), ("e", e, (d,))):
        if t.device != grads.device or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {shape} tensor on "
                             f"{grads.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}")
    if n_total is None:
        n_total = n

    out = torch.empty((d,), dtype=torch.float32, device=grads.device)
    blocks = channel_blocks(d)
    rows = (torch.empty((blocks, 3), dtype=torch.float32, device=grads.device)
            if pilot_stats else None)
    a = float(alpha)
    lib = build.load_library()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream(grads.device).cuda_stream
        code = lib.repro_ota_channel(
            int(pilot_stats), grads.data_ptr(), h.data_ptr(),
            u.data_ptr(), e.data_ptr(), out.data_ptr(),
            rows.data_ptr() if pilot_stats else None, n, d, float(n_total),
            float(scale), a, 1.0 / a, 1.0 - a, (1.0 - a) / a, CMS_U_BOUND,
            CMS_E_FLOOR, blocks, stream)
    build.check(code, "ota_channel_slab")
    ota_channel_slab.launches += 1
    if pilot_stats:
        return out, torch.sum(rows, dim=0)
    return out


ota_channel_slab.launches = 0


def channel_blocks(d: int) -> int:
    """Blocks of a channel-kernel launch over d columns, one column tile
    each; also the rows of its (blocks, 3) statistics buffer."""
    return -(-d // CHANNEL_TILE)


def receive_blocks(d: int) -> int:
    """Blocks of a receive-kernel launch over d columns; also the rows of
    its (blocks, 3) statistics workspace."""
    return -(-d // RECEIVE_THREADS)


def _ptr(t: Optional[torch.Tensor]):
    """A C entry point's pointer argument: None for an absent operand."""
    return None if t is None else t.data_ptr()


def _check_operand(name: str, t: torch.Tensor, shape, dtype, dev,
                   align: int) -> None:
    if t.device != dev or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be a {tuple(shape)} tensor on {dev}, "
                         f"got {tuple(t.shape)} on {t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype}")
    if t.data_ptr() % align != 0:
        raise ValueError(f"{name} must be {align}-byte aligned")


def ota_transmit_slab(grads: torch.Tensor, h: torch.Tensor, *,
                      n_total: Optional[int] = None, quantize: bool = False,
                      r: Optional[torch.Tensor] = None,
                      stochastic: bool = True, qmode: str = "int8",
                      zero_fold: bool = False,
                      sr_seed: Optional[int] = None,
                      ef: Optional[torch.Tensor] = None,
                      return_residual: bool = False,
                      acc: Optional[torch.Tensor] = None,
                      row_chunk: Optional[int] = None,
                      clean: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None):
    """Transmit stage: the faded partial sum ``(1/n_total) sum_n h[n]
    grads[n]`` of grads (N, d) stacked client gradients and h (N,)
    effective fading.

    ``quantize=False`` returns the f32 partial (d,). ``acc`` (a (d,) f32
    carry, the partial of the chunks already sent) and ``row_chunk``
    (client rows per chunk, default all) make it the streamed
    transmitter: ``acc + sum_chunks (sum_{n in chunk} h[n] grads[n]) /
    n_total``, each chunk divided as it lands. Both are f32 only.
    ``clean`` (a (d,) f32 carry) with ``mask`` (N,) adds the carried
    unfaded sum ``clean + sum_n mask[n] grads[n]`` from the same read of
    grads, and the call returns ``(partial, clean_out)``; f32 only.

    ``quantize=True`` needs d a multiple of 128 and returns
    ``(payload int8 (d,), scales f32 (d // 128,) [, residual f32 (d,)])``
    as ``kernels.ref.ota_transmit_ref`` does:
    ``qmode`` "int8" (stochastic rounding with the (d,) uniforms ``r``,
    or round-to-nearest with ``stochastic=False``) or "sign"
    (``zero_fold`` for the 1-bit folded wire); ``ef`` joins the partial
    before the quantizer and ``return_residual`` appends the fresh
    residual.

    ``sr_seed`` (a 64-bit int; int8 with stochastic rounding only, in
    place of ``r``) makes the kernel draw its rounding uniforms itself
    (Philox4x32-10). Only the CUDA kernel draws them: on a CPU tensor it
    raises. Its rounding decisions differ from the host-drawn ones by at
    most one quantization step per entry.
    """
    if grads.dim() != 2:
        raise ValueError(f"grads must be (N, d), got {tuple(grads.shape)}")
    n, d = grads.shape
    if not quantize:
        return _transmit_f32(grads, h, n, d, n_total, acc, row_chunk, clean,
                             mask)
    if clean is not None or mask is not None:
        raise ValueError("clean=/mask= (the carried clean sum) is f32 only")
    if acc is not None or row_chunk is not None:
        raise ValueError(
            "quantize=True cannot stream/accumulate (acc=/row_chunk=): the "
            "quantize-on-write epilogue must see the COMPLETED partial sum "
            "(one quantization step per entry, the wire contract); "
            "accumulate the f32 partial across chunks first, then quantize "
            "it with a single-row quantize=True launch")
    if d % LANE != 0:
        raise ValueError(f"quantized transmit needs d to be a multiple of "
                         f"{LANE}, got {d}")
    if qmode not in ("int8", "sign"):
        raise ValueError(f'unknown qmode {qmode!r}; options: "int8", "sign"')
    if zero_fold and qmode != "sign":
        raise ValueError("zero_fold is a sign-quantizer variant; "
                         f"qmode is {qmode!r}")
    sr = qmode == "int8" and stochastic
    if sr_seed is not None:
        if not sr:
            raise ValueError("sr_seed selects in-kernel stochastic rounding: "
                             "it needs qmode='int8' with stochastic=True")
        if r is not None:
            raise ValueError("pass EITHER the host-drawn uniforms r OR the "
                             "in-kernel seed sr_seed, not both")
        if not 0 <= int(sr_seed) < 2 ** 64:
            raise ValueError(f"sr_seed must be in [0, 2^64), got {sr_seed}")
    elif sr and (r is None or tuple(r.shape) != (d,)):
        raise ValueError(f"stochastic rounding needs r of shape ({d},), got "
                         f"{None if r is None else tuple(r.shape)}")
    if ef is not None and tuple(ef.shape) != (d,):
        raise ValueError(f"ef must be the ({d},) carried residual, got "
                         f"{tuple(ef.shape)}")
    if n_total is None:
        n_total = n
    if grads.device.type == "cpu":
        if sr_seed is not None:
            raise ValueError(
                "sr_seed draws the rounding uniforms inside the CUDA "
                "kernel; on the CPU pass the host-drawn r")
        return ota_transmit_ref(grads, h, n_total=n_total, quantize=True,
                                r=r, stochastic=stochastic, qmode=qmode,
                                zero_fold=zero_fold, ef=ef,
                                return_residual=return_residual)
    if grads.device.type != "cuda":
        raise ValueError(f"ota_transmit_slab takes cuda or cpu tensors, got "
                         f"{grads.device}")
    dev = grads.device
    f32 = torch.float32
    _check_operand("grads", grads, (n, d), f32, dev, 16)
    _check_operand("h", h, (n,), f32, dev, 4)
    if sr and sr_seed is None:
        _check_operand("r", r, (d,), f32, dev, 16)
    if ef is not None:
        _check_operand("ef", ef, (d,), f32, dev, 16)
    q = torch.empty((d,), dtype=torch.int8, device=dev)
    s = torch.empty((d // LANE,), dtype=f32, device=dev)
    resid = (torch.empty((d,), dtype=f32, device=dev) if return_residual
             else None)
    if qmode == "sign":
        quant = _QUANT[("sign", zero_fold)]
    else:
        quant = _QUANT[("int8", "rtn" if not sr else
                        "kernel" if sr_seed is not None else "host")]

    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.repro_ota_transmit(
            quant, grads.data_ptr(), h.data_ptr(),
            _ptr(r) if quant == 0 else None, _ptr(ef), q.data_ptr(),
            s.data_ptr(), _ptr(resid), int(sr_seed or 0), n, d,
            float(n_total), stream)
    build.check(code, "ota_transmit_slab")
    ota_transmit_slab.launches += 1
    return (q, s) if resid is None else (q, s, resid)


ota_transmit_slab.launches = 0
ota_transmit_slab.stream_launches = 0
ota_transmit_slab.nocarry_launches = 0
ota_transmit_slab.clean_launches = 0


# The accumulating kernel (csrc/ota_transmit_stream.cu): a block owns
# TRANSMIT_TILE columns and one segment of the rows; row_split picks the
# number of segments so that the grid gives the card SPLIT_BLOCKS_PER_SM
# blocks an SM, and splits no call of more than MAX_SPLIT_CHUNKS row
# chunks (there the carry stays the running sum, as in the plain
# version: see the kernel's header).
TRANSMIT_TILE = 512
SPLIT_BLOCKS_PER_SM = 2
MAX_SPLIT_CHUNKS = 64
MAX_SEGMENTS = 32      # the kernel folds 32 partial rows a round trip


def _row_chunks(n_rows: int, row_chunk: Optional[int]):
    """(rows a chunk, chunks) of a call (one chunk by default)."""
    rc = max(1, n_rows if row_chunk is None else min(row_chunk, n_rows))
    return rc, -(-n_rows // rc)


def _split_units(n_rows: int, row_chunk: Optional[int]):
    """(rows a unit, units): segments are made of whole row chunks when
    there is more than one, else of single rows."""
    rc, chunks = _row_chunks(n_rows, row_chunk)
    return (rc, chunks) if chunks > 1 else (1, n_rows)


def row_split(n_rows: int, d: int, row_chunk: Optional[int],
              has_carry: bool, sm_count: int) -> int:
    """The number of row segments S the accumulating kernel splits a call
    into. 1 with no carry (the no-carry call then sums its rows in the
    channel kernel's order), whenever the column tiles alone give 2
    blocks an SM, and with more than MAX_SPLIT_CHUNKS row chunks; else
    enough segments to give the card SPLIT_BLOCKS_PER_SM blocks an SM,
    never more than the rows (or the row chunks, when there are
    several), and normalised so that every segment of ``segment_rows``
    rows holds at least one row."""
    tiles = -(-d // TRANSMIT_TILE)
    if not has_carry or n_rows < 2 or tiles >= 2 * sm_count:
        return 1
    if _row_chunks(n_rows, row_chunk)[1] > MAX_SPLIT_CHUNKS:
        return 1
    _, units = _split_units(n_rows, row_chunk)
    want = min(MAX_SEGMENTS,
               max(1, SPLIT_BLOCKS_PER_SM * sm_count // tiles))
    per = -(-units // min(want, units))
    return -(-units // per)


def segment_rows(n_rows: int, row_chunk: Optional[int], n_seg: int) -> int:
    """Rows a segment when a call is split into ``n_seg`` (from
    ``row_split``): a multiple of the row chunk when there are several."""
    unit, units = _split_units(n_rows, row_chunk)
    return -(-units // n_seg) * unit


def ota_transmit_split_model(grads: torch.Tensor, h: torch.Tensor, *,
                             n_total: Optional[int] = None,
                             acc: Optional[torch.Tensor] = None,
                             row_chunk: Optional[int] = None,
                             n_seg: int = 1,
                             clean: Optional[torch.Tensor] = None,
                             mask: Optional[torch.Tensor] = None):
    """The accumulating kernel's summation order, one f32 operation at a
    time (csrc/ota_transmit_stream.cu, its header): each piece (a row
    chunk within a segment) summed row by row from 0 and divided by
    n_total as it lands; with one segment onto the carry, with several
    onto the segment's partial, the partials then added in segment order
    and the carry last. ``clean`` with ``mask`` adds the clean sum in the
    same pieces and segments, with no division, and returns ``(out,
    clean_out)``. A model for the tests and the card check, not a route
    of the wrapper (that is ``ota_transmit_ref`` on the CPU): it loops
    over the rows."""
    n, d = grads.shape
    if n_total is None:
        n_total = n
    f32 = torch.float32
    rc = _row_chunks(n, row_chunk)[0]
    seg_rows = segment_rows(n, row_chunk, n_seg)
    zeros = torch.zeros((d,), dtype=f32, device=grads.device)
    # a full divisor: elementwise IEEE division, as the kernel divides
    div = torch.full((d,), float(n_total), dtype=f32, device=grads.device)
    g, hf = grads.float(), h.float()
    with_clean = clean is not None
    mf = mask.float() if with_clean else None
    carry = zeros if acc is None else acc.float()
    ccarry = clean.float() if with_clean else zeros
    total, ctotal = zeros, zeros
    for s in range(n_seg):
        r0, r1 = s * seg_rows, min(n, (s + 1) * seg_rows)
        seg, part = (carry if n_seg == 1 else zeros), zeros
        cseg, cpart = (ccarry if n_seg == 1 else zeros), zeros
        nxt = min(r1, (r0 // rc + 1) * rc)
        for r in range(r0, r1):
            if r == nxt:
                seg, part = seg + part / div, zeros
                if with_clean:
                    cseg, cpart = cseg + cpart, zeros
                nxt = min(r1, nxt + rc)
            part = part + hf[r] * g[r]
            if with_clean:
                cpart = cpart + mf[r] * g[r]
        if r1 > r0:
            seg = seg + part / div
            if with_clean:
                cseg = cseg + cpart
        if n_seg == 1:
            return (seg, cseg) if with_clean else seg
        total = total + seg
        if with_clean:
            ctotal = ctotal + cseg
    out = carry + total
    return (out, ccarry + ctotal) if with_clean else out


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (a host query,
    cached: no device sync)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> the ticket counters of the in-launch folds:
# one a column tile for the accumulating transmit's split fold (a split
# call has fewer than 2 sm_count column tiles, row_split), and the first
# one for the receive kernel's statistics fold. Zeroed once, and every
# launch leaves them at 0. Launches on one stream run in order, so they
# never share a counter at the same time.
_TILE_COUNTERS = {}


def _tile_counters(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _TILE_COUNTERS:
        _TILE_COUNTERS[key] = torch.zeros(2 * sm_count(dev.index),
                                          dtype=torch.int32, device=dev)
    return _TILE_COUNTERS[key]


def _transmit_f32(grads, h, n, d, n_total, acc, row_chunk, clean, mask):
    """The f32 route of ``ota_transmit_slab``: the accumulating kernel
    (one row chunk and a zero carry when neither is given), its rows
    split into ``row_split`` segments across blocks. The kernel reads G
    through bulk copies when d % 4 == 0 and G is 16-byte aligned, else
    with plain loads; with the clean carry, at few rows and one segment,
    with 16-byte loads of whole column groups instead (the kernel picks
    from the shape and alignment); all compute the same value."""
    if row_chunk is not None and row_chunk < 1:
        raise ValueError(f"row_chunk must be >= 1, got {row_chunk}")
    if acc is not None and tuple(acc.shape) != (d,):
        raise ValueError(f"acc must be the ({d},) running partial sum, got "
                         f"{tuple(acc.shape)}")
    if (clean is None) != (mask is None):
        raise ValueError("pass clean= and mask= together")
    if clean is not None and (tuple(clean.shape) != (d,)
                              or tuple(mask.shape) != (n,)):
        raise ValueError(f"clean must be ({d},) and mask ({n},), got "
                         f"{tuple(clean.shape)} and {tuple(mask.shape)}")
    if n_total is None:
        n_total = n
    if grads.device.type == "cpu":
        return ota_transmit_ref(grads, h, n_total=n_total, acc=acc,
                                row_chunk=row_chunk, clean=clean, mask=mask)
    if grads.device.type != "cuda":
        raise ValueError(f"ota_transmit_slab takes cuda or cpu tensors, got "
                         f"{grads.device}")
    dev = grads.device
    f32 = torch.float32
    _check_operand("grads", grads, (n, d), f32, dev, 4)
    _check_operand("h", h, (n,), f32, dev, 4)
    if acc is not None:
        _check_operand("acc", acc, (d,), f32, dev, 4)
    with_clean = clean is not None
    if with_clean:
        _check_operand("clean", clean, (d,), f32, dev, 4)
        _check_operand("mask", mask, (n,), f32, dev, 4)
    rc = _row_chunks(n, row_chunk)[0]
    n_seg = row_split(n, d, row_chunk, acc is not None, sm_count(dev.index))
    seg = segment_rows(n, row_chunk, n_seg)
    out = torch.empty((d,), dtype=f32, device=dev)
    clean_out = (torch.empty((d,), dtype=f32, device=dev) if with_clean
                 else None)
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        partials = counters = None
        if n_seg > 1:
            partials = torch.empty(((1 + with_clean) * n_seg,
                                    -(-d // 4) * 4), dtype=f32, device=dev)
            counters = _tile_counters(dev, stream)
        code = lib.repro_ota_transmit_stream(
            grads.data_ptr(), h.data_ptr(), _ptr(acc), out.data_ptr(),
            _ptr(mask), _ptr(clean), _ptr(clean_out), _ptr(partials),
            _ptr(counters), n, d, rc, seg, n_seg, float(n_total), stream)
    build.check(code, "ota_transmit_slab")
    ota_transmit_slab.stream_launches += 1
    if acc is None:
        ota_transmit_slab.nocarry_launches += 1
    if with_clean:
        ota_transmit_slab.clean_launches += 1
        return out, clean_out
    return out


def ota_receive_slab(payload: torch.Tensor, scales: torch.Tensor,
                     u: torch.Tensor, e: torch.Tensor, *, alpha: float,
                     scale: float, packed: Optional[str] = None,
                     pilot_stats: bool = False):
    """Receive stage: dequantize and superpose R payload rows, then add
    the CMS interference, in one pass.

    payload (R, d) int8, or with ``packed="fold"|"planes"`` the (R,
    sign_words(d, ...)) uint32 words of ``pack_sign_slab`` (d from
    ``scales``); scales (R, d // 128) f32; u, e (d,). Returns (d,) f32,
    plus the (3,) residual statistics as ``(out, stats)`` with
    ``pilot_stats=True`` (one launch either way).
    """
    if not (1.0 < alpha <= 2.0):
        raise ValueError(f"tail index alpha must be in (1, 2], got {alpha}")
    if packed not in _PACKED:
        raise ValueError(f'unknown packed wire {packed!r}; '
                         'options: "fold", "planes"')
    if payload.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"payload and scales must be 2-D, got "
                         f"{tuple(payload.shape)} and {tuple(scales.shape)}")
    rows, d = scales.shape[0], scales.shape[1] * LANE
    if packed is None:
        want = ((rows, d), torch.int8)
    else:
        want = ((rows, sign_words(d, planes=packed == "planes")),
                torch.uint32)
    if (tuple(payload.shape), payload.dtype) != want:
        raise ValueError(f"payload must be {want[0]} {want[1]} for scales "
                         f"{tuple(scales.shape)}, got "
                         f"{tuple(payload.shape)} {payload.dtype}")
    if payload.device.type == "cpu":
        return ota_receive_ref(payload, scales, u, e, alpha=alpha,
                               scale=scale, packed=packed,
                               pilot_stats=pilot_stats)
    if payload.device.type != "cuda":
        raise ValueError(f"ota_receive_slab takes cuda or cpu tensors, got "
                         f"{payload.device}")
    dev = payload.device
    f32 = torch.float32
    _check_operand("payload", payload, want[0], want[1], dev, 4)
    _check_operand("scales", scales, (rows, d // LANE), f32, dev, 4)
    _check_operand("u", u, (d,), f32, dev, 16)
    _check_operand("e", e, (d,), f32, dev, 16)
    out = torch.empty((d,), dtype=f32, device=dev)
    blocks = receive_blocks(d)
    a = float(alpha)
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        stats_rows = stats = counter = None
        if pilot_stats:
            stats_rows = torch.empty((blocks, 3), dtype=f32, device=dev)
            stats = torch.empty((3,), dtype=f32, device=dev)
            counter = _tile_counters(dev, stream)
        code = lib.repro_ota_receive(
            _PACKED[packed], int(pilot_stats), payload.data_ptr(),
            scales.data_ptr(), u.data_ptr(), e.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (stats_rows, stats, counter)), rows, d,
            float(scale), a, 1.0 / a, 1.0 - a, (1.0 - a) / a, CMS_U_BOUND,
            CMS_E_FLOOR, blocks, stream)
    build.check(code, "ota_receive_slab")
    ota_receive_slab.launches += 1
    if pilot_stats:
        ota_receive_slab.stats_launches += 1
    return (out, stats) if pilot_stats else out


ota_receive_slab.launches = 0
ota_receive_slab.stats_launches = 0
