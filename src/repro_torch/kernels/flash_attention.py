"""Blocked causal / sliding-window GQA flash attention.

PyTorch counterpart of ``repro.kernels.flash_attention``: attention over
positions 0..S-1 with an online softmax,

    out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h // G] / sqrt(D))
                   v[b, j, h // G],

over the keys j < Sk that the causal (i >= j) and window (i - j <
window) masks leave visible; G = H // K query heads share a kv head.

On a CUDA tensor the wrapper launches one of two hand-written kernels
or raises; ``flash_variant`` picks which from dtype and shape alone,
never on a failure:

* ``"hopper"``, ``csrc/flash_attention_sm90.cu`` (TMA, a shared-memory
  ring, ``wgmma``): bf16 with a head dimension in ``HOPPER_HEAD_DIMS``
  (64, and 80 to 128 in steps of 16, which the kernel pads to 128 in
  shared memory: Kimi-K2's 112 among them) at addresses TMA takes. Its
  ``p @ v`` rounds p to bf16 (the TPU kernel's is f32), so its tier
  against the plain version is ``flash_tolerance``'s.
* ``"scalar"``, ``csrc/flash_attention.cu`` (scalar f32 FMAs): all
  else, f32 and every other head dimension (below 64, not a multiple of
  16, or above 128); it agrees with the plain version to 2e-5 in f32.

On a CPU tensor it runs the plain version,
``kernels.ref.flash_attention_ref``. Nothing else selects among the
three. ``flash_attention.launches`` counts the kernel launches of both
variants, ``hopper_launches`` and ``scalar_launches`` each one's, and
``shape_launches`` (a ``collections.Counter``) counts them by the call's
(B, Sq, Sk, H, K, D, causal, window). The
kernels have no backward (the TPU kernel has none), so the wrapper
refuses, on either device and before it picks a path, inputs that
require grad or lie under a ``torch.func`` transform (``grad``,
``vmap``): on the CPU the plain version could be differentiated and
batched, and a test there would pass a call the card refuses.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 256
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
HOPPER_HEAD_DIMS = (64, 80, 96, 112, 128)
HOPPER_MAX_SEQ_Q = 65535 * 128     # the q tiles of 128 rows on grid.y


def flash_variant(dtype: torch.dtype, head_dim: int, seq_q: int,
                  data_ptrs: Sequence[int]) -> str:
    """The kernel a CUDA call of ``flash_attention`` gets: ``"hopper"``
    for bf16 with a head dimension in ``HOPPER_HEAD_DIMS``, at most
    ``HOPPER_MAX_SEQ_Q`` query rows and every address in ``data_ptrs``
    (q, k, v, out) 16-byte aligned, which TMA needs; else ``"scalar"``.
    TMA also needs global strides in multiples of 16 bytes: the wrapper
    takes contiguous (B, S, heads, D) tensors only, whose row strides in
    bf16 are 2 D bytes: 128 and 256 at D = 64 and 128, and 160, 192 and
    224 at D = 80, 96 and 112, which the kernel pads to 128 columns in
    shared memory."""
    if (dtype == torch.bfloat16 and head_dim in HOPPER_HEAD_DIMS
            and seq_q <= HOPPER_MAX_SEQ_Q
            and all(p % 16 == 0 for p in data_ptrs)):
        return "hopper"
    return "scalar"


def flash_tolerance(variant: str, ref: torch.Tensor,
                    ref_abs_v: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The tier a variant's output is held to against the plain version,
    an element at a time (f32). ``ref`` is the plain version's output;
    ``ref_abs_v``, the plain version run on |v| in f32, only for
    ``"hopper"``.

    * ``"hopper"``: ``2^-7 |ref| + 2^-8 attn(q, k, |v|) + 2e-5``. One bf16
      step of the element's own value (both sides round an f32 result to
      bf16); then sum_j |dp_j| |v_j| / l for p rounded to bf16 for the
      ``wgmma`` (at most 2^-9 relative a term, so 2^-9 attn(q, k, |v|))
      with a 2x margin; then the f32 tier.
    * ``"scalar"``: 2e-5 in f32 (sums in another order, with FMAs); in
      bf16 one bf16 step of the element's own value plus that."""
    if variant == "hopper":
        return (2.0 ** -7 * ref.float().abs() + 2.0 ** -8 * ref_abs_v.float()
                + 2e-5)
    if variant != "scalar":
        raise ValueError(f"unknown variant {variant!r}; options: "
                         '"hopper", "scalar"')
    if ref.dtype == torch.float32:
        return torch.full_like(ref, 2e-5)
    return 2.0 ** -7 * ref.float().abs() + 2e-5


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
        if torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise ValueError(f"flash_attention has no backward and no batch "
                             f"rule: {name} lies under a torch.func "
                             "transform (grad, vmap)")
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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    variant = flash_variant(q.dtype, d, sq, ptrs)
    # a window of at least Sq hides no key: the same as none
    w = 0 if window is None or window >= sq else int(window)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (*ptrs, b, sq, k.shape[1], h, kh, d, int(causal), w,
                1.0 / math.sqrt(d), stream)
        if variant == "hopper":
            code = lib.repro_flash_attention_sm90(*args)
        else:
            code = lib.repro_flash_attention(_DTYPE_ID[q.dtype], *args)
    build.check(code, f"flash_attention ({variant})")
    counter = f"{variant}_launches"
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    flash_attention.launches += 1
    flash_attention.shape_launches[
        (b, sq, k.shape[1], h, kh, d, bool(causal), window)] += 1
    return out


flash_attention.launches = 0
flash_attention.hopper_launches = 0
flash_attention.scalar_launches = 0
flash_attention.shape_launches = collections.Counter()
