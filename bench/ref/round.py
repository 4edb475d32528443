"""The plain reference of one ADOTA-FL round on a flat f32 slab.

Plain torch, no import of the program. It works out again, from the
seed, everything the program derives:

* the round's draws: a frozen copy of the law of
  ``repro_torch/core/draws.py:TorchDraws`` (a Philox generator on the
  device reseeded from ``splitmix64((seed << 32) | t)``; the fading,
  then the CMS angles and exponentials over the model's entries, then
  the uplink's rounding uniforms), so the same calls on the same device
  give the same numbers;
* the MAC (paper Eq. 7): ``(1/N) sum_n h_n g_n`` plus
  ``xi_scale * CMS(u, e)``, or on the int8 wire the faded sum plus the
  carried residual quantized per 128-entry block (scale max|x|/127,
  ``floor(x/s + r)``), dequantized, plus the interference, with the
  fresh residual ``x - q s`` carried on;
* the server update, Adam-OTA (Eq. 8, 10, 11), on w as the clients see
  it: the slab's bf16 leaves rounded to bf16 at the start of every
  round, as the stated bf16 weights are.

Clients run the family's loss (``bench/ref/<family>.py``) in float32
with TF32 off. ``variant`` selects the readings the limits are set
from: ``"f32"`` is the reference; ``"control"`` computes the same in
the next precision down (the bf16 weights held in fp8 e4m3 with a scale
a leaf and every projection computed on fp8 operands; the f32 MAC
output and optimizer slabs in bf16); ``"half"``
and ``"frozen"`` plant a fault: each client's loss taken over the first
half of its rows only, or a round that returns its state unchanged.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

LANE = 128
INT8_MAX = 127.0
TINY = torch.finfo(torch.float32).tiny
CMS_U_BOUND = math.pi / 2 - 1e-6
CMS_E_FLOOR = 1e-7
_M64 = (1 << 64) - 1


class Leaf(NamedTuple):
    """One parameter tensor's place in the slab."""
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: tuple            # ("normal", std), ("ones",) or ("zeros",)
    offset: int
    size: int


def flatten_layout(tree: dict) -> list:
    """The leaves of a family's layout (nested dicts of ``(shape,
    dtype name, init)``) in slab order: dict keys sorted, depth first."""
    out, off = [], 0

    def walk(node, path):
        nonlocal off
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
            return
        shape, dtype, init = node
        size = math.prod(shape)
        out.append(Leaf(path, tuple(shape), getattr(torch, dtype), init, off,
                        size))
        off += size

    walk(tree, ())
    return out


def mix64(x: int) -> int:
    """splitmix64's finalizer."""
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def round_draws(tr: dict, seed: int, t: int, n: int, total: int,
                padded: int, device) -> dict:
    """Round t's draws: h (n,), u and e (padded,), and r_up (padded,)
    on the int8 wire with stochastic rounding (rayleigh fading, no power
    control, interference on: what the cells run)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(mix64((seed << 32) | int(t)))
    u0 = torch.rand((n,), generator=gen, device=device).clamp_min_(TINY)
    s = tr["mu_c"] / math.sqrt(math.pi / 2.0)
    h = s * torch.sqrt(-2.0 * torch.log(u0))
    pad = padded - total
    u = torch.rand((total,), generator=gen, device=device)
    u = u * (2.0 * CMS_U_BOUND) - CMS_U_BOUND
    r = torch.rand((total,), generator=gen, device=device)
    e = (-torch.log(r.clamp_min_(TINY))).clamp_min_(CMS_E_FLOOR)
    u = torch.nn.functional.pad(u, (0, pad))
    e = torch.nn.functional.pad(e, (0, pad), value=1.0)
    r_up = None
    if tr["uplink"] == "int8":
        r_up = torch.rand((padded,), generator=gen, device=device)
    return {"h": h, "u": u, "e": e, "r_up": r_up}


def interference(u: torch.Tensor, e: torch.Tensor, alpha: float,
                 scale: float) -> torch.Tensor:
    """scale * X, X the symmetric Chambers-Mallows-Stuck transform."""
    a = alpha
    u = torch.clamp(u, -CMS_U_BOUND, CMS_U_BOUND)
    e = torch.clamp_min(e, CMS_E_FLOOR)
    x = (torch.sin(a * u) / torch.cos(u) ** (1.0 / a)
         * (torch.cos((1.0 - a) * u) / e) ** ((1.0 - a) / a))
    return scale * x


def quantize_int8(x: torch.Tensor, r: torch.Tensor):
    """(dequantized payload, residual) of the int8 wire."""
    d = x.shape[0]
    a = x.reshape(d // LANE, LANE)
    maxabs = torch.amax(torch.abs(a), dim=1, keepdim=True)
    s = torch.where(maxabs > 0.0, maxabs / torch.full_like(maxabs, INT8_MAX),
                    torch.ones_like(maxabs))
    q = torch.clamp(torch.floor(a / s + r.reshape(d // LANE, LANE)),
                    -INT8_MAX, INT8_MAX)
    deq = q * s
    return deq.reshape(-1), (a - deq).reshape(-1)


def adam_ota(g, delta, nu, w, tr: dict):
    """One Adam-OTA step on slabs; returns (delta, nu, w)."""
    delta = tr["beta1"] * delta + (1.0 - tr["beta1"]) * g
    ad = torch.abs(delta)
    da = torch.where(ad == 0.0, torch.zeros_like(ad), ad ** tr["alpha"])
    nu = tr["beta2"] * nu + (1.0 - tr["beta2"]) * da
    denom = torch.clamp_min(nu + tr["eps"], 0.0) ** (1.0 / tr["alpha"])
    return delta, nu, w - tr["lr"] * delta / denom


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x held in fp8 e4m3 with one scale for the leaf."""
    amax = float(x.abs().max())
    if amax == 0.0:
        return x
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def clients_view(w: torch.Tensor, leaves, variant: str) -> torch.Tensor:
    """w as the clients and the server update see it: every bf16 leaf
    rounded to its storage (fp8 under the control)."""
    out = w.clone()
    for lf in leaves:
        if lf.dtype != torch.bfloat16:
            continue
        seg = out[lf.offset:lf.offset + lf.size]
        if variant == "control":
            seg.copy_(_fp8(seg))
        else:
            seg.copy_(seg.to(torch.bfloat16).float())
    return out


def leaf_norms(slab: torch.Tensor, leaves) -> list:
    return [float(torch.linalg.vector_norm(slab[lf.offset:lf.offset + lf.size]
                                           .float()))
            for lf in leaves]


def run_rounds(family, mcfg: dict, tr: dict, leaves, w0: torch.Tensor,
               tokens, draw_seed: int, rounds: int = 3,
               variant: str = "f32") -> dict:
    """``rounds`` rounds from the f32 slab ``w0`` (the weights as made),
    client batches ``tokens`` (rounds, N, B, S). Returns the readings
    the check compares: each round's mean client loss and clean-gradient
    norm, the per-leaf norms of the first moment after round 1 and of
    the clean gradient of round 1, the per-leaf change of w after the
    last round as the next round would see it, and the per-leaf norms of
    the carried residual on the int8 wire."""
    dev = w0.device
    padded = w0.shape[0]
    total = sum(lf.size for lf in leaves)
    n = tr["clients"]
    half = variant == "half"
    low = variant == "control"
    w = w0.clone()
    delta = torch.zeros_like(w)
    nu = torch.zeros_like(w)
    ef = torch.zeros_like(w) if tr["uplink"] == "int8" else None
    out = {"loss": [], "grad_norm": []}
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    if low:
        mcfg = dict(mcfg, precision="fp8")
    try:
        for t in range(rounds):
            dr = round_draws(tr, draw_seed, t, n, total, padded, dev)
            xi = interference(dr["u"], dr["e"], tr["alpha"], tr["xi_scale"])
            del dr["u"], dr["e"]
            wc = clients_view(w, leaves, "control" if low else "f32")
            agg = torch.zeros_like(w)
            clean = torch.zeros_like(w)
            loss_sum = 0.0
            for c in range(n):
                toks = torch.as_tensor(tokens[t][c], device=dev).long()
                if half:
                    toks = toks[:toks.shape[0] // 2]
                wg = wc.detach().requires_grad_(True)
                loss = family.loss(wg, leaves, toks, mcfg)
                (g,) = torch.autograd.grad(loss, wg)
                agg.add_(dr["h"][c] * g)
                clean.add_(g)
                loss_sum += float(loss.detach())
                del g, wg, loss
            agg.div_(n)
            clean.div_(n)
            out["loss"].append(loss_sum / n)
            out["grad_norm"].append(float(torch.linalg.vector_norm(clean)))
            if t == 0:
                out["clean1"] = leaf_norms(clean, leaves)
            del clean
            if ef is None:
                g = agg + xi
            else:
                deq, ef_new = quantize_int8(agg + ef, dr["r_up"])
                if variant != "frozen":
                    ef = ef_new
                g = deq + xi
                del deq, ef_new
            del agg, xi
            if low:
                g = g.to(torch.bfloat16).float()
            if variant != "frozen":
                delta, nu, w = adam_ota(g, delta, nu, wc, tr)
            if low:
                delta = delta.to(torch.bfloat16).float()
                nu = nu.to(torch.bfloat16).float()
            del g, wc
            if t == 0:
                out["delta1"] = leaf_norms(delta, leaves)
        seen = clients_view(w, leaves, "control" if low else "f32")
        out["change"] = leaf_norms(seen - clients_view(w0, leaves, "f32"),
                                   leaves)
        out["ef"] = None if ef is None else leaf_norms(ef, leaves)
    finally:
        torch.set_float32_matmul_precision(prev)
    return out
