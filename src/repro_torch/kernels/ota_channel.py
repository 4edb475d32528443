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
  row chunks (``row_chunk``): the streamed client axis's transmitter;
* ``ota_receive_slab`` — the server's front end: dequantizes and sums R
  payload rows (the int8 container, or the packed sign words of
  ``pack_sign_slab``) and adds the CMS interference.

The channel and receive kernels carry the optional pilot-statistics
epilogue ``[count, sum log|r|, sum log^2|r|]`` over the nonzero
residuals r = scale * xi (the closed alpha loop's input).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/ota_channel.cu``, ``csrc/ota_transmit.cu``,
``csrc/ota_transmit_stream.cu``, ``csrc/ota_receive.cu``) or raises. On
a CPU tensor it runs the plain version in ``kernels.ref``. Nothing else
selects between the two. ``ota_transmit_slab`` counts its two kernels
apart: ``launches`` for the quantize-on-write kernel, ``stream_launches``
for the f32 (accumulating) one.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.channel import CMS_E_FLOOR, CMS_U_BOUND
from repro_torch.kernels import build
from repro_torch.kernels.ref import (INT8_MAX, LANE, ota_channel_ref,
                                     ota_receive_ref, ota_transmit_ref,
                                     pack_sign_slab, sign_words,
                                     unpack_sign_slab)

__all__ = ["INT8_MAX", "LANE", "ota_channel_slab", "ota_receive_slab",
           "ota_transmit_slab", "pack_sign_slab", "sign_words",
           "unpack_sign_slab"]

THREADS = 128     # threads per block; each owns `vec` adjacent columns
# The transmit and receive kernels: 128 threads a block, 4 columns a
# thread (csrc/ota_transmit.cu, csrc/ota_receive.cu).
WIRE_COLS_PER_BLOCK = 512
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
    vec = 4 if (d % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in (grads, out))) else 1
    blocks = -(-d // (THREADS * vec))
    rows = (torch.empty((blocks, 3), dtype=torch.float32, device=grads.device)
            if pilot_stats else None)
    a = float(alpha)
    lib = build.load_library()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream(grads.device).cuda_stream
        code = lib.repro_ota_channel(
            vec, int(pilot_stats), grads.data_ptr(), h.data_ptr(),
            u.data_ptr(), e.data_ptr(), out.data_ptr(),
            rows.data_ptr() if pilot_stats else None, n, d, float(n_total),
            float(scale), a, 1.0 / a, 1.0 - a, (1.0 - a) / a, CMS_U_BOUND,
            CMS_E_FLOOR, THREADS, blocks, stream)
    build.check(code, "ota_channel_slab")
    ota_channel_slab.launches += 1
    if pilot_stats:
        return out, torch.sum(rows, dim=0)
    return out


ota_channel_slab.launches = 0


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
                      row_chunk: Optional[int] = None):
    """Transmit stage: the faded partial sum ``(1/n_total) sum_n h[n]
    grads[n]`` of grads (N, d) stacked client gradients and h (N,)
    effective fading.

    ``quantize=False`` returns the f32 partial (d,). ``acc`` (a (d,) f32
    carry, the partial of the chunks already sent) and ``row_chunk``
    (client rows per chunk, default all) make it the streamed
    transmitter: ``acc + sum_chunks (sum_{n in chunk} h[n] grads[n]) /
    n_total``, each chunk divided as it lands. Both are f32 only.

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
        return _transmit_f32(grads, h, n, d, n_total, acc, row_chunk)
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

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.repro_ota_transmit(
            quant, grads.data_ptr(), h.data_ptr(),
            ptr(r) if quant == 0 else None, ptr(ef), q.data_ptr(),
            s.data_ptr(), ptr(resid), int(sr_seed or 0), n, d,
            float(n_total), stream)
    build.check(code, "ota_transmit_slab")
    ota_transmit_slab.launches += 1
    return (q, s) if resid is None else (q, s, resid)


ota_transmit_slab.launches = 0
ota_transmit_slab.stream_launches = 0


def _transmit_f32(grads, h, n, d, n_total, acc, row_chunk):
    """The f32 route of ``ota_transmit_slab``: the accumulating kernel
    (one row chunk and a zero carry when neither is given)."""
    if row_chunk is not None and row_chunk < 1:
        raise ValueError(f"row_chunk must be >= 1, got {row_chunk}")
    if acc is not None and tuple(acc.shape) != (d,):
        raise ValueError(f"acc must be the ({d},) running partial sum, got "
                         f"{tuple(acc.shape)}")
    if n_total is None:
        n_total = n
    if grads.device.type == "cpu":
        return ota_transmit_ref(grads, h, n_total=n_total, acc=acc,
                                row_chunk=row_chunk)
    if grads.device.type != "cuda":
        raise ValueError(f"ota_transmit_slab takes cuda or cpu tensors, got "
                         f"{grads.device}")
    dev = grads.device
    f32 = torch.float32
    _check_operand("grads", grads, (n, d), f32, dev, 4)
    _check_operand("h", h, (n,), f32, dev, 4)
    if acc is not None:
        _check_operand("acc", acc, (d,), f32, dev, 4)
    rc = n if row_chunk is None else min(row_chunk, n)
    out = torch.empty((d,), dtype=f32, device=dev)
    vec = 4 if d % 4 == 0 and grads.data_ptr() % 16 == 0 else 1
    blocks = -(-d // (THREADS * vec))
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.repro_ota_transmit_stream(
            vec, grads.data_ptr(), h.data_ptr(),
            None if acc is None else acc.data_ptr(), out.data_ptr(), n, d,
            max(rc, 1), float(n_total), THREADS, blocks, stream)
    build.check(code, "ota_transmit_slab")
    ota_transmit_slab.stream_launches += 1
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
    ``pilot_stats=True``.
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
    blocks = -(-d // WIRE_COLS_PER_BLOCK)
    stats_rows = (torch.empty((blocks, 3), dtype=f32, device=dev)
                  if pilot_stats else None)
    a = float(alpha)
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.repro_ota_receive(
            _PACKED[packed], int(pilot_stats), payload.data_ptr(),
            scales.data_ptr(), u.data_ptr(), e.data_ptr(), out.data_ptr(),
            stats_rows.data_ptr() if pilot_stats else None, rows, d,
            float(scale), a, 1.0 / a, 1.0 - a, (1.0 - a) / a, CMS_U_BOUND,
            CMS_E_FLOOR, blocks, stream)
    build.check(code, "ota_receive_slab")
    ota_receive_slab.launches += 1
    if pilot_stats:
        return out, torch.sum(stats_rows, dim=0)
    return out


ota_receive_slab.launches = 0
