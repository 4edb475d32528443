#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line(s) before the last line:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   matrix products and convolutions (the reference computes in f32);
2. build: nvcc builds the kernels from src/repro_torch/csrc;
3. kernel adaptive_update_slab against its plain version at the main
   path's slab (175,104 entries): six modes, f32 and bf16 g/w,
   alpha in {1.2, 1.5, 2.0};
4. kernel ota_channel_slab against its plain version at 50 x 175,104,
   pilot statistics on and off, alpha in {1.2, 1.5, 2.0};
5. reference: small inputs through the round on the card and on the CPU
   (plain versions), same draws: logistic regression and a small
   ResNet-tiny agree within their tiers;
6. main path: ResNet-tiny at full width (channels 16/32/64, 2 blocks
   per stage; 175,066 parameters), 50 clients, batch 8 of 32x32x3,
   adam_ota then adagrad_ota, 5 rounds each, through
   make_slab_round_runner + run_rounds_slab with the port's own draws.
   Every launch counter is set to 0 just before and read just after:
   each kernel must have launched exactly once per round;
7. times: CUDA events, median of 50 launches, each after an L2 flush,
   of each kernel and its plain version at the main path's shapes,
   beside the least time the card needs to move the bytes;
then one JSON line listing the kernels, and the result line.

Exits non-zero, and prints no result, without a CUDA device, without the
repository beside it, or when any phase fails.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: device memory rate and f32 rate outside
# the tensor cores (at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

D_MAIN = 175104          # ResNet-tiny's padded slab (175,066 parameters)
N_CLIENTS = 50
BATCH = 8
ROUNDS = 5
TIMED_LAUNCHES = 50


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def phase_kernel_update(torch, dev):
    from repro_torch.kernels.adaptive_update import (MODES,
                                                     adaptive_update_slab)
    from repro_torch.kernels.ref import adaptive_update_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    worst_f32 = worst_rel = worst_bf16 = 0.0
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn(D_MAIN, generator=gen, device=dev).to(dtype)
        w = torch.randn(D_MAIN, generator=gen, device=dev).to(dtype)
        delta = 0.1 * torch.randn(D_MAIN, generator=gen, device=dev)
        delta[::17] = 0.0
        nu = 0.01 * torch.rand(D_MAIN, generator=gen, device=dev)
        nu_max = nu + 0.01 * torch.rand(D_MAIN, generator=gen, device=dev)
        for mode in MODES:
            for alpha in (1.2, 1.5, 2.0):
                kw = dict(lr=0.01, beta1=0.9, beta2=0.3, alpha=alpha,
                          eps=1e-8, mode=mode,
                          nu_max=nu_max if mode == "amsgrad" else None)
                got = adaptive_update_slab(g, delta, nu, w, **kw)
                want = adaptive_update_ref(g, delta, nu, w, **kw)
                torch.cuda.synchronize()
                cases += 1
                for i, (a, b) in enumerate(zip(got, want)):
                    a, b = a.float(), b.float()
                    err = (a - b).abs()
                    if dtype == torch.bfloat16 and i == len(got) - 1:
                        steps = err / (2.0 ** -7 * b.abs().clamp_min(
                            2.0 ** -126))
                        worst_bf16 = max(worst_bf16, float(steps.max()))
                        continue
                    tol = 1e-6 * b.abs() + 1e-6 * float(b.abs().max())
                    check(bool(torch.all(err <= tol)),
                          f"adaptive_update_slab {mode} {dtype} a={alpha} "
                          f"output {i}: max err {float(err.max())}")
                    worst_f32 = max(worst_f32, float(err.max()))
                    worst_rel = max(worst_rel, float(
                        (err / b.abs().clamp_min(1e-30)).max()))
    check(worst_bf16 <= 1.0, f"bf16 w off by {worst_bf16} steps")
    print(f"[kernel adaptive_update_slab] d={D_MAIN} {cases} cases (6 modes x "
          f"f32/bf16 x alpha 1.2/1.5/2.0): max_abs_err={worst_f32:.3e} "
          f"max_rel_err={worst_rel:.3e} (tol 1e-6 rel + 1e-6 of scale); "
          f"bf16 w within {worst_bf16:.2f} bf16 steps (tol 1) ok")
    return worst_f32


def phase_kernel_channel(torch, dev, total):
    from repro_torch.core.channel import CMS_U_BOUND
    from repro_torch.kernels.ota_channel import ota_channel_slab
    from repro_torch.kernels.ref import ota_channel_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    grads = torch.randn(N_CLIENTS, D_MAIN, generator=gen, device=dev)
    h = 0.5 + torch.rand(N_CLIENTS, generator=gen, device=dev)
    u = (2 * torch.rand(D_MAIN, generator=gen, device=dev) - 1) * CMS_U_BOUND
    e = -torch.log(torch.rand(D_MAIN, generator=gen, device=dev))
    # the slab's padding tail: no gradient, the CMS fixed point (0, 1)
    grads[:, total:], u[total:], e[total:] = 0.0, 0.0, 1.0
    worst = worst_stats = 0.0
    for alpha in (1.2, 1.5, 2.0):
        for stats in (False, True):
            kw = dict(alpha=alpha, scale=0.1, pilot_stats=stats)
            got = ota_channel_slab(grads, h, u, e, **kw)
            want = ota_channel_ref(grads, h, u, e, **kw)
            torch.cuda.synchronize()
            if stats:
                (got, gs), (want, ws) = got, want
                check(float(gs[0]) == float(ws[0]) == total,
                      f"stats count {float(gs[0])} vs {float(ws[0])}")
                rel = float(((gs - ws).abs() / ws.abs().clamp_min(1)).max())
                check(rel <= 1e-5, f"stats rel err {rel}")
                worst_stats = max(worst_stats, rel)
            err = (got - want).abs()
            scale = float(want.abs().max())
            check(bool(torch.all(err <= 1e-6 * want.abs() + 1e-6 * scale)),
                  f"ota_channel_slab a={alpha} stats={stats}: max err "
                  f"{float(err.max())}")
            check(bool(torch.all(got[total:] == 0.0)), "padding not 0")
            worst = max(worst, float(err.max()))
    print(f"[kernel ota_channel_slab] N={N_CLIENTS} d={D_MAIN} 6 cases "
          f"(alpha 1.2/1.5/2.0 x stats on/off): max_abs_err={worst:.3e} "
          f"(tol 1e-6 rel + 1e-6 of scale); padding "
          f"{D_MAIN - total} entries exactly 0; stats max_rel_err="
          f"{worst_stats:.3e} (tol 1e-5), count exact; ok")
    return worst


def phase_reference(torch, np):
    """The round on the card against the round on the CPU (plain
    versions), same inputs and draws."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import FLConfig, make_slab_round_step
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.models.vision import logistic_regression, resnet_tiny

    rng = np.random.default_rng(0)
    cases = [("logreg", logistic_regression(16, 4), (16,), 4, 3, 1e-5),
             ("resnet_tiny(8,16)x1", resnet_tiny(
                 10, channels=(8, 16), blocks_per_stage=1), (8, 8, 3), 10, 2,
              1e-4)]
    worst = {}
    for name, model, xshape, n_classes, rounds, tol in cases:
        params = model.init(seed=1, device="cpu")
        ch, ad, fl = (OTAChannelConfig(), AdaptiveConfig(optimizer="adam_ota",
                                                         lr=0.01),
                      FLConfig(n_clients=4))
        states = {d: init_train_state(ad, params, device=d)
                  for d in ("cpu", "cuda")}
        steps = {d: make_slab_round_step(model.loss_fn, ch, ad, fl, device=d)
                 for d in states}
        draws = TorchDraws(ch, states["cpu"].spec, 4, seed=3, device="cpu")
        for t in range(rounds):
            batch = {"x": rng.normal(size=(4, 3) + xshape).astype(np.float32),
                     "y": rng.integers(0, n_classes, (4, 3)).astype(np.int64)}
            for d in states:
                states[d], _ = steps[d](states[d], draws(t), batch)
        a, b = states["cuda"].w.cpu(), states["cpu"].w
        check(bool(torch.allclose(a, b, rtol=tol, atol=tol)),
              f"{name}: card vs CPU w differ by {float((a - b).abs().max())}")
        worst[name] = float((a - b).abs().max())
    print("[reference] the round on the card vs on the CPU (plain versions),"
          " same draws: " + ", ".join(f"{k} max|dw|={v:.3e}" for k, v in
                                      worst.items())
          + " (tiers 1e-5 logreg, 1e-4 conv); ok")


def phase_main_path(torch, np, dev, counters):
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    data = synthetic_images(3000, 32, 3, 10, seed=0)
    ch = OTAChannelConfig()
    fl = FLConfig(n_clients=N_CLIENTS)
    runs = {}
    for opt in ("adam_ota", "adagrad_ota"):
        ad = AdaptiveConfig(optimizer=opt, lr=0.01)
        state = init_train_state(ad, model.init(seed=0, device=dev),
                                 device=dev)
        check(state.spec.padded == D_MAIN, f"slab {state.spec.padded}")
        run = make_slab_round_runner(model.loss_fn, ch, ad, fl, device=dev)
        runs[opt] = (state, run, TorchDraws(ch, state.spec, N_CLIENTS,
                                            seed=0, device=dev),
                     FederatedBatcher(data, N_CLIENTS, BATCH, seed=0))
    # One warm-up round (cuDNN and vmap set-up) outside the counted run.
    state, run, draws, batcher = runs["adam_ota"]
    run_rounds_slab(run, state, draws, batcher, 1)
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    out = {}
    for opt, (state, run, draws, batcher) in runs.items():
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        state, hist = run_rounds_slab(run, state, draws, batcher, ROUNDS,
                                      chunk=ROUNDS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / ROUNDS
        deltas = [c.launches - b for c, b in zip(counters, before)]
        check(deltas == [ROUNDS] * len(counters),
              f"{opt}: launches per kernel {deltas}, want {ROUNDS} each")
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(x) for x in losses), f"{opt}: losses "
              f"{losses}")
        check(bool(torch.isfinite(state.w).all()), f"{opt}: w not finite")
        check(tuple(state.w.shape) == (D_MAIN,) and int(state.step) == ROUNDS,
              f"{opt}: state shape {tuple(state.w.shape)} step "
              f"{int(state.step)}")
        out[opt] = (losses, ms)
    launches = {c.__name__: c.launches for c in counters}
    for opt, (losses, ms) in out.items():
        print(f"[main path] resnet_tiny full width (175,066 params, slab "
              f"{D_MAIN}), {N_CLIENTS} clients x batch {BATCH} of 32x32x3, "
              f"{opt}, {ROUNDS} rounds: losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; {ms:.2f} ms/round (host clock, synchronized)")
    print(f"[main path] launches over both runs: {launches} "
          f"(want {2 * ROUNDS} each: one per round); ok")
    return launches


def _median_ms(torch, fn, flush):
    """Median of per-launch CUDA-event times, each launch after an L2
    flush (the round finds its operands cold: ~40 MB of other traffic
    runs between two launches of one kernel)."""
    fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def phase_times(torch, dev):
    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.ota_channel import ota_channel_slab
    from repro_torch.kernels.ref import adaptive_update_ref, ota_channel_ref

    flush = torch.empty(64 * 2 ** 20, device=dev)      # 256 MB > 50 MB L2
    gen = torch.Generator(device=dev).manual_seed(2)
    d, n = D_MAIN, N_CLIENTS
    g, w = (torch.randn(d, generator=gen, device=dev) for _ in range(2))
    delta = 0.1 * torch.randn(d, generator=gen, device=dev)
    nu = 0.01 * torch.rand(d, generator=gen, device=dev)
    kw = dict(lr=0.01, beta1=0.9, beta2=0.3, alpha=1.5, eps=1e-8, mode="adam")
    grads = torch.randn(n, d, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    u = torch.rand(d, generator=gen, device=dev) - 0.5
    e = torch.rand(d, generator=gen, device=dev) + 0.5
    ckw = dict(alpha=1.5, scale=0.1)

    rows = {}
    # adam: reads g, delta, nu, w and writes delta, nu, w (f32); about 16
    # f32 operations an element, counting each powf as one.
    bytes_u, ops_u = 7 * 4 * d, 16 * d
    rows["adaptive_update_slab"] = (
        _median_ms(torch, lambda: adaptive_update_slab(g, delta, nu, w, **kw),
                   flush),
        _median_ms(torch, lambda: adaptive_update_ref(g, delta, nu, w, **kw),
                   flush), bytes_u, ops_u)
    # channel: reads G, h, u, e and writes out; 2 N d for the faded sum
    # and about 12 an entry for the CMS transform.
    bytes_c, ops_c = 4 * (n * d + n + 3 * d), 2 * n * d + 12 * d
    rows["ota_channel_slab"] = (
        _median_ms(torch, lambda: ota_channel_slab(grads, h, u, e, **ckw),
                   flush),
        _median_ms(torch, lambda: ota_channel_ref(grads, h, u, e, **ckw),
                   flush), bytes_c, ops_c)
    out = {}
    for name, (ms, plain_ms, nbytes, ops) in rows.items():
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * ops / F32_FLOPS_PER_S
        bound = max(t_bytes, t_ops)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes" if t_bytes >= t_ops else
                         "operations", bytes=nbytes)
        print(f"[times] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.5f} ms ({out[name]['bound_by']}: {nbytes} B at "
              f"3.35 TB/s; {ops} f32 ops at 67 TFLOP/s), share of bound "
              f"{bound / ms:.3f}; library_ms null: no single PyTorch call "
              "computes this function")
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.ota_channel import ota_channel_slab

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(nvidia_smi())
    print(f"[device] {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    print(f"[build] {', '.join(build.SOURCES)} -> {lib_path.name} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(build.NVCC_FLAGS)})")

    from repro_torch.core.slab import make_slab_spec
    from repro_torch.models.vision import resnet_tiny
    spec = make_slab_spec(resnet_tiny(10).init(seed=0, device="cpu"))
    check(spec.padded == D_MAIN, f"ResNet-tiny slab {spec.padded}")

    err_update = phase_kernel_update(torch, dev)
    err_channel = phase_kernel_channel(torch, dev, spec.total)
    phase_reference(torch, np)
    counters = (adaptive_update_slab, ota_channel_slab)
    launches = phase_main_path(torch, np, dev, counters)
    times = phase_times(torch, dev)

    src = "src/repro_torch/csrc/"
    kernels = [
        dict(name="adaptive_update_slab", route="cuda",
             source=src + "adaptive_update.cu",
             replaces="src/repro/kernels/adaptive_update.py:188",
             launches=launches["adaptive_update_slab"],
             max_abs_err=err_update, **{k: times["adaptive_update_slab"][k]
                                        for k in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by")},
             library_ms=None),
        dict(name="ota_channel_slab", route="cuda",
             source=src + "ota_channel.cu",
             replaces="src/repro/kernels/ota_channel.py:222",
             launches=launches["ota_channel_slab"],
             max_abs_err=err_channel, **{k: times["ota_channel_slab"][k]
                                         for k in ("ms", "plain_ms",
                                                   "bound_ms", "bound_by")},
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
