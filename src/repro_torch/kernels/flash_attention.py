"""Blocked causal / sliding-window GQA flash attention.

PyTorch counterpart of ``repro.kernels.flash_attention``: attention over
positions 0..S-1 with an online softmax,

    out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h // G] / sqrt(D))
                   v[b, j, h // G],

over the keys j < Sk that the causal (i >= j) and window (i - j <
window) masks leave visible; G = H // K query heads share a kv head.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/flash_attention.cu`` or raises. On a CPU tensor it runs the plain
version, ``kernels.ref.flash_attention_ref``. Nothing else selects
between the two. The kernel has no backward (the TPU kernel has none),
so the wrapper refuses inputs that require grad.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 256
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0, all f32 or
    all bf16, contiguous, D <= 256. Returns (B, Sq, H, D) in q.dtype.

    ``bq`` and ``bk`` are the TPU kernel's tile sizes; they are accepted
    for the JAX signature and ignored (the CUDA kernel's tiles are its
    own, and the result does not depend on them).
    """
    del bq, bk
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.requires_grad:
            raise ValueError(f"flash_attention has no backward: {name} "
                             "requires grad")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, heads, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPE_ID or t.dtype != q.dtype:
            raise ValueError(f"q, k and v must share one dtype of "
                             f"{tuple(_DTYPE_ID)}, got {q.dtype}, {k.dtype}, "
                             f"{v.dtype}")
        if t.device != q.device:
            raise ValueError(f"q, k and v must lie on one device, got "
                             f"{q.device}, {k.device}, {v.device}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, Sk, K, D) = ({b}, Sk, K, {d}),"
                         f" got {tuple(k.shape)} and {tuple(v.shape)}")
    kh = k.shape[2]
    if kh == 0 or h % kh != 0:
        raise ValueError(f"query heads {h} must be a multiple of kv heads "
                         f"{kh}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in [1, {MAX_HEAD_DIM}], got {d}")
    if k.shape[1] == 0:
        raise ValueError("k and v hold no keys")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes cuda or cpu tensors, got "
                         f"{q.device}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.repro_flash_attention(
            _DTYPE_ID[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, sq, k.shape[1], h, kh, d, int(causal),
            0 if window is None else int(window), 1.0 / math.sqrt(d), stream)
    build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
