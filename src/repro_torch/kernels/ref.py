"""Plain PyTorch versions of the port's kernels.

Counterparts of ``repro.kernels.ref`` (``adaptive_update_ref``,
``ota_channel_ref``, ``ota_transmit_ref``, ``ota_receive_ref``,
``flash_attention_ref``) and of
the sign-wire packing of ``repro.kernels.ota_channel`` (``sign_words``,
``pack_sign_slab``, ``unpack_sign_slab``). ``log_moment_stats`` lives in
``core.tail_index`` and is re-exported here. They are the CPU path of
the kernel wrappers, the versions the tests hold against the JAX
package, and the versions ``chip_smoke.py`` holds each CUDA kernel
against on the card. The expressions are written out op for op as in
the JAX oracles.

Packed sign words are uint32, as in the JAX package; the bit arithmetic
runs on their int32 view (PyTorch has no shifts or sums on uint32).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.channel import CMS_E_FLOOR, CMS_U_BOUND, cms_transform
from repro_torch.core.tail_index import log_moment_stats

LANE = 128       # per-block scale width of the quantized wire
INT8_MAX = 127.0


def adaptive_update_ref(g: torch.Tensor, delta, nu, w: torch.Tensor, *,
                        lr: float, beta1: float, beta2: float, alpha,
                        eps: float, mode: str, nu_max=None
                        ) -> Tuple[torch.Tensor, ...]:
    """One fused server update on a flat parameter slab (paper Eq. 8-11).

    mode: "adagrad" -> v += |Delta|^a ; "adam" -> v = b2 v + (1-b2)|Delta|^a ;
    "amsgrad" -> adam v plus non-decreasing vmax denominator ; "yogi" ->
    sign-controlled additive v ; "momentum" -> FedAvgM (Delta = b1 Delta + g,
    no v; beta1 is the momentum coefficient) ; "sgd" -> plain FedAvg.
    State is f32; w keeps its dtype. ``alpha`` is a float or a 0-dim f32
    tensor. Returns ``(*updated_state, w')`` in (delta, nu, nu_max) order.
    """
    gf = g.float()
    wf = w.float()
    if mode == "sgd":
        return ((wf - lr * gf).to(w.dtype),)
    gain = 1.0 if mode == "momentum" else (1.0 - beta1)
    delta = beta1 * delta + gain * gf
    if mode == "momentum":
        return delta, (wf - lr * delta).to(w.dtype)
    ad = torch.abs(delta)
    da = torch.where(ad == 0.0, torch.zeros_like(ad), ad ** alpha)
    if mode == "adagrad":
        nu = nu + da
    elif mode == "adam":
        nu = beta2 * nu + (1.0 - beta2) * da
    elif mode == "amsgrad":
        nu = beta2 * nu + (1.0 - beta2) * da
        nu_max = torch.maximum(nu_max, nu)
    elif mode == "yogi":
        nu = nu - (1.0 - beta2) * torch.sign(nu - da) * da
    else:
        raise ValueError(mode)
    denom_v = nu_max if mode == "amsgrad" else nu
    denom = torch.clamp_min(denom_v + eps, 0.0) ** (1.0 / alpha)
    w_new = (wf - lr * delta / denom).to(w.dtype)
    if mode == "amsgrad":
        return delta, nu, nu_max, w_new
    return delta, nu, w_new


def ota_channel_ref(grads: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                    e: torch.Tensor, *, alpha: float, scale: float,
                    n_total: Optional[int] = None,
                    pilot_stats: bool = False):
    """Fused OTA MAC on a slab: (1/n_total) sum_n h_n grads[n] + scale*xi,
    xi the guarded CMS transform of (u, e).

    grads: (N, d); h: (N,); u, e: (d,). ``n_total`` overrides the 1/N
    normalisation (defaults to N). Returns (d,) f32, plus the (3,)
    residual log-moment statistics when ``pilot_stats=True``.
    """
    n = grads.shape[0]
    if n_total is None:
        n_total = n
    agg = torch.einsum("n,nd->d", h.float(), grads.float()) / n_total
    a = alpha
    u = torch.clamp(u, -CMS_U_BOUND, CMS_U_BOUND)
    e = torch.clamp_min(e, CMS_E_FLOOR)
    xi = (torch.sin(a * u) / torch.cos(u) ** (1.0 / a)
          * (torch.cos((1.0 - a) * u) / e) ** ((1.0 - a) / a))
    out = agg + scale * xi
    if pilot_stats:
        return out, log_moment_stats(scale * xi)
    return out


def ota_transmit_ref(grads: torch.Tensor, h: torch.Tensor, *,
                     n_total: Optional[int] = None, quantize: bool = False,
                     r: Optional[torch.Tensor] = None,
                     stochastic: bool = True, qmode: str = "int8",
                     zero_fold: bool = False,
                     ef: Optional[torch.Tensor] = None,
                     return_residual: bool = False,
                     acc: Optional[torch.Tensor] = None,
                     row_chunk: Optional[int] = None):
    """Transmit stage: the faded partial sum ``(1/n_total) sum_n h[n]
    grads[n]``, optionally quantized per 128-block.

    ``qmode="int8"``: scale max|x|/127 (1 for an all-zero block),
    payload ``floor(x/s + r)`` (stochastic, ``r`` the (d,) uniforms) or
    ``round(x/s)`` half to even, clipped to +-127. ``qmode="sign"``:
    payload sign(x), scale mean|x| (1 for an all-zero block);
    ``zero_fold=True`` folds zeros to +1 and keeps scale 0 for an
    all-zero block. ``ef`` joins the partial before the quantizer;
    ``return_residual=True`` appends ``x - q * s``.

    ``acc`` / ``row_chunk`` select the streamed client axis: start from
    the (d,) f32 carry ``acc`` (zeros if None) and fold the client rows
    in per ``row_chunk``-sized chunk (default: all rows), each chunk's
    faded partial divided by ``n_total`` as it lands. f32 only, like
    the kernel.

    Returns (d,) f32, or ``(payload int8 (d,), scales f32 (d // 128,)
    [, residual f32 (d,)])`` when ``quantize=True``. Agreement with a
    kernel that sums in another order is one quantization step per
    entry (a one-ulp change of x can flip a rounding decision), as in
    the JAX oracle.
    """
    n, d = grads.shape
    if n_total is None:
        n_total = n
    streamed = acc is not None or row_chunk is not None
    if streamed and quantize:
        raise ValueError("quantize=True cannot stream/accumulate "
                         "(acc=/row_chunk=); quantize the completed f32 "
                         "partial in a separate single-row call")
    h2 = h.reshape(n, 1).float()
    if streamed:
        rc = n if row_chunk is None else min(row_chunk, n)
        if rc < 1:
            raise ValueError(f"row_chunk must be >= 1, got {row_chunk}")
        gf = grads.float()
        agg = (torch.zeros((d,), dtype=torch.float32, device=grads.device)
               if acc is None else acc.float())
        for s in range(0, n, rc):
            agg = agg + torch.sum(h2[s:s + rc] * gf[s:s + rc],
                                  dim=0) / n_total
        return agg
    agg = torch.sum(h2 * grads.float(), dim=0) / n_total
    if not quantize:
        return agg
    if d % LANE != 0:
        raise ValueError(f"quantized transmit needs d % {LANE} == 0, got {d}")
    if qmode not in ("int8", "sign"):
        raise ValueError(f'unknown qmode {qmode!r}; options: "int8", "sign"')
    if zero_fold and qmode != "sign":
        raise ValueError("zero_fold is a sign-quantizer variant; "
                         f"qmode is {qmode!r}")
    if ef is not None:
        agg = agg + ef.float()
    a = agg.reshape(d // LANE, LANE)
    if qmode == "sign":
        meanabs = torch.mean(torch.abs(a), dim=1, keepdim=True)
        if zero_fold:
            s = meanabs
            q = torch.where(a < 0.0, -1, 1).to(torch.int8)
        else:
            s = torch.where(meanabs > 0.0, meanabs, torch.ones_like(meanabs))
            q = torch.sign(a).to(torch.int8)
    else:
        maxabs = torch.amax(torch.abs(a), dim=1, keepdim=True)
        s = torch.where(maxabs > 0.0, maxabs / INT8_MAX,
                        torch.ones_like(maxabs))
        y = a / s
        if stochastic:
            if r is None or tuple(r.shape) != (d,):
                raise ValueError("stochastic rounding needs r of shape "
                                 f"({d},), got "
                                 f"{None if r is None else tuple(r.shape)}")
            y = torch.floor(y + r.float().reshape(d // LANE, LANE))
        else:
            y = torch.round(y)
        q = torch.clamp(y, -INT8_MAX, INT8_MAX).to(torch.int8)
    ret = (q.reshape(-1), s.reshape(-1))
    if return_residual:
        resid = a - q.float() * s
        ret = ret + (resid.reshape(-1),)
    return ret


def sign_words(d: int, *, planes: bool = False) -> int:
    """Packed word count of a d-coordinate sign payload: d // 32 for the
    1-bit folded wire, twice that for the sign + nonzero planes."""
    if d % 32 != 0:
        raise ValueError(f"packing needs d to be a multiple of 32, got {d}")
    return (2 if planes else 1) * (d // 32)


def _bit_pos(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def pack_sign_slab(payload: torch.Tensor, *,
                   planes: bool = False) -> torch.Tensor:
    """Pack a {-1, 0, +1} int8 sign payload (..., d) into uint32 words
    (..., sign_words(d, planes)). Bit j of word w is 1 iff
    ``payload[32 w + j] < 0``; with ``planes=True`` the nonzero-mask
    words follow the sign words along the last axis."""
    d = payload.shape[-1]
    nw = sign_words(d, planes=False)
    pos = _bit_pos(payload.device)

    def plane(mask):
        b = mask.to(torch.int32).reshape(*payload.shape[:-1], nw, 32)
        # distinct bits never carry, so the int32 sum is the bitwise OR
        return torch.sum(b << pos, dim=-1, dtype=torch.int32)

    words = plane(payload < 0)
    if planes:
        words = torch.cat([words, plane(payload != 0)], dim=-1)
    return words.view(torch.uint32)


def unpack_sign_slab(words: torch.Tensor, d: int, *,
                     planes: bool = False) -> torch.Tensor:
    """Inverse of ``pack_sign_slab``: uint32 words back to the (..., d)
    int8 payload. The 1-bit wire decodes to {-1, +1}; the two-plane wire
    restores {-1, 0, +1} exactly."""
    nw = sign_words(d, planes=planes)
    if words.shape[-1] != nw:
        raise ValueError(f"expected {nw} packed words for d={d} "
                         f"(planes={planes}), got {words.shape[-1]}")
    w32 = words.view(torch.int32)
    pos = _bit_pos(words.device)

    def bits(w):
        b = (w[..., None] >> pos) & 1
        return (b > 0).reshape(*w.shape[:-1], w.shape[-1] * 32)

    one = torch.ones((), dtype=torch.int8, device=words.device)
    if not planes:
        return torch.where(bits(w32), -one, one)
    neg = bits(w32[..., :nw // 2])
    nz = bits(w32[..., nw // 2:])
    return torch.where(nz, torch.where(neg, -one, one), 0 * one)


def ota_receive_ref(payload: torch.Tensor, scales: torch.Tensor,
                    u: torch.Tensor, e: torch.Tensor, *, alpha: float,
                    scale: float, packed: Optional[str] = None,
                    pilot_stats: bool = False):
    """Receive stage: dequantize and superpose R payload rows, then add
    the CMS interference: ``sum_r q[r] * s[r, block] + scale * xi``.

    payload: (R, d) int8, or with ``packed="fold"|"planes"`` the (R,
    sign_words(d, ...)) uint32 words (d from ``scales``); scales: (R,
    d // 128) f32; u, e: (d,). Returns (d,) f32, plus the (3,) residual
    statistics when ``pilot_stats=True``.
    """
    if packed is not None:
        if packed not in ("fold", "planes"):
            raise ValueError(f'unknown packed wire {packed!r}; '
                             'options: "fold", "planes"')
        payload = unpack_sign_slab(payload, scales.shape[1] * LANE,
                                   planes=(packed == "planes"))
    rows, d = payload.shape
    deq = (payload.float().reshape(rows, d // LANE, LANE)
           * scales[..., None])
    agg = torch.sum(deq, dim=0).reshape(-1)
    xi = cms_transform(u, e, alpha)
    out = agg + scale * xi
    if pilot_stats:
        return out, log_moment_stats(scale * xi)
    return out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Masked GQA attention over positions 0..S-1. q: (B,Sq,H,D); k, v:
    (B,Sk,K,D) with H % K == 0. f32 scores, masked entries set to -1e30
    (finite, as in the TPU kernel), f32 softmax and ``p @ v``; the
    output in q's dtype."""
    b, sq, hn, d = q.shape
    kheads = k.shape[2]
    g = hn // kheads
    qg = q.reshape(b, sq, kheads, g, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    scores = scores / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    dpos = qpos[:, None] - kpos[None, :]
    ok = torch.ones_like(dpos, dtype=torch.bool)
    if causal:
        ok &= dpos >= 0
    if window is not None:
        ok &= dpos < window
    scores = scores.masked_fill(~ok, -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, hn, d).to(q.dtype)
