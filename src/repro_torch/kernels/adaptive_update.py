"""Fused ADOTA server update: the six server optimizers in one kernel.

PyTorch counterpart of ``repro.kernels.adaptive_update``. The update
(Eq. 8-11) is elementwise over every parameter:

    Delta <- b1*Delta + (1-b1)*g
    v     <- f(v, |Delta|^a)          (mode-dependent)
    w     <- w - lr * Delta / max(v+eps, 0)^{1/a}

Modes, as in the JAX kernel:

    adagrad   v += |Delta|^a                       (AdaGrad-OTA, Eq. 9)
    adam      v = b2 v + (1-b2)|Delta|^a           (Adam-OTA,    Eq. 10)
    amsgrad   adam v, plus vmax = max(vmax, v); step divides by vmax
    yogi      v -= (1-b2) sign(v - |Delta|^a)|Delta|^a
    momentum  Delta = b1 Delta + g; w -= lr Delta  (FedAvgM; no v)
    sgd       w -= lr g                            (FedAvg; stateless)

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/adaptive_update.cu`` (one read-modify-write pass) or raises. On a
CPU tensor it runs the plain version, ``kernels.ref.adaptive_update_ref``.
Nothing else selects between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import adaptive_update_ref


MODES = ("adagrad", "adam", "amsgrad", "yogi", "momentum", "sgd")
_ALPHA_MODES = ("adagrad", "adam", "amsgrad", "yogi")
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}


def _state_names(mode: str) -> Tuple[str, ...]:
    if mode == "sgd":
        return ()
    if mode == "momentum":
        return ("delta",)
    if mode == "amsgrad":
        return ("delta", "nu", "nu_max")
    return ("delta", "nu")


def adaptive_update_slab(g: torch.Tensor, delta: Optional[torch.Tensor],
                         nu: Optional[torch.Tensor], w: torch.Tensor, *,
                         lr: float, beta1: float, beta2: float, alpha,
                         eps: float, mode: str,
                         nu_max: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """Fused server update on a 1-D parameter slab.

    g/w may be bf16 or f32; delta/nu/nu_max are f32 state (pass None for
    modes that do not carry them). For ``momentum``, ``beta1`` is the
    server momentum coefficient (g enters with gain 1). ``alpha`` is a
    float or a 0-dim f32 tensor on g's device (the tracked tail index):
    the kernel then reads it from device memory and computes 1/alpha in
    f32, so nothing is read back to the host. Returns the updated slabs
    in ``(delta', nu', nu_max', w')`` order, dropping the entries the
    mode does not own; ``w'`` is always last.
    """
    if mode not in MODES:
        raise ValueError(f"unknown update mode {mode!r}; options: {MODES}")
    if g.device.type == "cpu":
        return adaptive_update_ref(g, delta, nu, w, lr=lr, beta1=beta1,
                                   beta2=beta2, alpha=alpha, eps=eps,
                                   mode=mode, nu_max=nu_max)
    if g.device.type != "cuda":
        raise ValueError(f"adaptive_update_slab takes cuda or cpu tensors, "
                         f"got {g.device}")

    state = dict(zip(("delta", "nu", "nu_max"), (delta, nu, nu_max)))
    names = _state_names(mode)
    n = g.shape[0]
    for name, t in (("g", g), ("w", w)) + tuple((k, state[k]) for k in names):
        if t is None:
            raise ValueError(f"mode {mode!r} needs {name}")
        if t.device != g.device or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be a ({n},) tensor on {g.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = (tuple(_DTYPE_ID) if name in ("g", "w") else (torch.float32,))
        if t.dtype not in want:
            raise ValueError(f"{name} must have dtype in {want}, got {t.dtype}")

    outs = {k: torch.empty_like(state[k]) for k in names}
    w_out = torch.empty_like(w)
    ptrs = [g, w] + [state[k] for k in names] + list(outs.values()) + [w_out]
    vec = int(all(t.data_ptr() % 16 == 0 for t in ptrs))

    def ptr(t):
        return None if t is None else t.data_ptr()

    alpha_dev = None
    a = 2.0
    if mode in _ALPHA_MODES and isinstance(alpha, torch.Tensor):
        if (alpha.device != g.device or alpha.dim() != 0
                or alpha.dtype != torch.float32):
            raise ValueError(f"a tensor alpha must be a 0-dim float32 "
                             f"tensor on {g.device}, got {alpha.dtype} "
                             f"{tuple(alpha.shape)} on {alpha.device}")
        alpha_dev = alpha.contiguous()
    elif mode in _ALPHA_MODES:
        a = float(alpha)
    gain = 1.0 if mode == "momentum" else 1.0 - beta1
    lib = build.load_library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        code = lib.repro_adaptive_update(
            MODES.index(mode), _DTYPE_ID[g.dtype], _DTYPE_ID[w.dtype], vec,
            ptr(g), ptr(state["delta"] if "delta" in names else None),
            ptr(state["nu"] if "nu" in names else None),
            ptr(state["nu_max"] if "nu_max" in names else None), ptr(w),
            ptr(outs.get("delta")), ptr(outs.get("nu")),
            ptr(outs.get("nu_max")), ptr(w_out), n, lr, beta1, gain, beta2,
            1.0 - beta2, a, 1.0 / a, eps, ptr(alpha_dev), stream)
    build.check(code, "adaptive_update_slab")
    adaptive_update_slab.launches += 1
    return tuple(outs[k] for k in names) + (w_out,)


adaptive_update_slab.launches = 0
