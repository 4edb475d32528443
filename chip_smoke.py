#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line(s) before the last line:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   matrix products and convolutions (the reference computes in f32);
2. build: nvcc builds the kernels from src/repro_torch/csrc, each source
   by its own nvcc, all started together; the update (B1), channel (B2),
   accumulating transmit (B3b), quantize transmit (B3c) and receive (B4)
   kernels as compiled: registers, shared memory and spills from the
   compiler's report (-Xptxas -v), which must show no spill; then the
   Hopper flash-attention kernel
   (D = 64 and 128): the same report (registers, which must be 168 for
   setmaxnreg's balance, spills), its dynamic shared memory, and a
   cuobjdump -sass count that must show wgmma (HGMMA) and TMA loads
   (UTMALDG);
3. kernel adaptive_update_slab against its plain version: six modes,
   f32 and bf16 g/w, alpha in {1.2, 1.5, 2.0}, at the main path's slab
   (175,104 entries), at the same slab 3 elements off 16-byte alignment,
   and at the million-client stream's (4096);
4. kernel ota_channel_slab against its plain version at 50 x 175,104,
   alpha in {1.2, 1.5, 2.0}, then at alpha 1.5 at 1 x 175,104 and
   1 x 4096 (the streamed finishes), 2000 x 4096 (h in two chunks) and
   37 x 4097 (d % 4 != 0: plain loads), each with pilot statistics on
   and off (count exact, padding exactly 0); the bulk-copy ring and the
   plain loads bitwise equal;
5. kernel ota_transmit_slab against its plain version at 50 x 175,104
   (the last 38 columns zero, as the slab's padding): int8 with host
   stochastic rounding and round-to-nearest, sign and folded sign, each
   with and without error feedback; the in-kernel Philox rounding held
   to one quantization step and to zero bias; then the plain quantizer
   applied to the kernel's own sum (the accumulating transmit's no-carry
   call + ef) at 50 x 175,104, 1 x 175,104 (the streamed finish: h = 1,
   n_total = 1) and 7 x 640 (a last tile of one quantization block):
   the int8 payload, scales and residual (host rounding, RTN) and the
   sign payload bitwise, the sign scales and residuals at 1e-6;
6. kernel ota_receive_slab against its plain version: R in {1, 3}, the
   int8 container and the fold / planes sign words, alpha in
   {1.2, 1.5, 2.0}, pilot statistics on and off; its grid resident in
   one wave (blocks an SM from the occupancy API); with statistics one
   launch (torch.profiler sees one kernel), the same bits in two runs;
   1 x 640 with statistics;
7. runtime alpha: adaptive_update_slab with alpha a device tensor,
   launched under torch.cuda.set_sync_debug_mode("error"), against its
   plain version, and the server half of a tracked round (the MAC with
   statistics, the EMA, the update) under the same mode: no read back
   to the host;
8. reference: small inputs through the round on the card and on the CPU
   (plain versions), same draws: logistic regression and a small
   ResNet-tiny agree within their tiers; then quantized rounds (int8 +
   error feedback, folded sign + error feedback) of logistic regression;
9. main path: ResNet-tiny at full width (channels 16/32/64, 2 blocks
   per stage; 175,066 parameters), 50 clients, batch 8 of 32x32x3,
   adam_ota then adagrad_ota, 5 rounds each, through
   make_slab_round_runner + run_rounds_slab with the port's own draws.
   Every launch counter is set to 0 just before and read just after:
   each kernel must have launched exactly once per round. Then four
   wire runs of adam_ota, 5 rounds each, the counters set to 0 before
   and read after each: f32 uplink with alpha="auto"; int8 uplink with
   error feedback and the int8 downlink, alpha="auto"; folded sign with
   error feedback, static alpha 1.5; int8 with in-kernel rounding
   (sr_inkernel) and error feedback, static alpha 1.5;
10. kernel ota_transmit_slab(acc=, row_chunk=), the accumulating
   transmit of the streamed client axis, against its plain version:
   row_chunk None / 1 / 7 / N, the carry absent or random, n_total != N,
   at 50 x 175,104 and 37 x 4,097 (random rows) and at 2000 x 4096 (the
   million-client path's own gradient rows, and row_chunk 64 and 1999);
   the f32 transmit without a carry (the same kernel) too; then, with a
   carry, 2001 x 4,100 (a last column tile of 4 columns and a ragged last
   segment; row_chunk None and 64) and 5 x 4096 (fewer rows than
   segments the grid would like). 37 x 4,097 runs the scalar path. Every
   case where the rows split across blocks (S > 1) is also bitwise its
   summation order (ota_transmit_split_model) and itself run to run;
   each case's S is printed. The bulk-copy ring and the plain loads (G
   off a 16-byte boundary) agree bitwise. One chunk with no carry is
   bitwise the channel kernel's faded sum (scale 0) at 50 x 175,104,
   2000 x 4096 and 1 x 4096;
11. reference: streamed logistic-regression rounds on the card against
   the same rounds on the CPU: serial, double-buffered, ragged, weighted;
12. streamed equals resident: ResNet-tiny at full width, 50 clients,
   chunk 50, 3 rounds of adam_ota, bitwise the resident round's state;
13. streamed runs S1-S3 of ResNet-tiny at full width: 200 clients,
   batch 8, sample_rate 0.25, Dirichlet data-size weights, alpha="auto",
   3 rounds each (S1 chunk 50 serial f32; S2 chunk 50 double-buffered
   f32; S3 chunk 64, ragged, int8 + EF + int8 downlink), every counter
   set to 0 before and read after each; then a dead round (an all-zero
   mask) on S3's state under set_sync_debug_mode("error");
14. the million-client stream: d = 4096, the quadratic loss of the JAX
   package's streamed benchmark, batches made from the client index,
   1,000,000 clients in chunks of 2000, 2 rounds serial and 2
   double-buffered, with launch counts and peak memory; one more serial
   round under set_sync_debug_mode("error"); one more round of the same
   step under torch.profiler: the card time of its accumulating-transmit
   launches, which the counter and the profiler must both count 500;
14a. the per-round pytree API at full width: ResNet-tiny, 50 clients,
   batch 8, init_server + make_round_step + run_rounds for each of the
   six optimizers on the f32 uplink, then adam_ota on the int8 uplink,
   5 rounds each, beside the resident runner (make_slab_round_runner +
   run_rounds_slab) on the same draws and batches: every counter set to
   0 before each run and read after (one channel and one update launch
   a f32 round; one transmit, one receive and one update an int8
   round), the final params, optimizer state and history bitwise the
   resident runner's, ms per round of both on the host clock; then the
   quickstart twin (examples/quickstart_torch.py) on the card:
   logistic regression, 20 clients, xi_scale 0.5, 60 rounds, adam_ota
   and fedavgm, both accuracies printed, the losses finite;
14b. checkpoint and resume on the card: ResNet-tiny at full width,
   adam_ota, int8 uplink with error feedback, the int8 downlink and
   alpha="auto", 6 rounds with chunk_hook writing save_slab_state
   (blocking=False) at round 3 beside a blocking save, then
   load_slab_state onto the card and run_rounds_slab(start_round=3):
   the final state bitwise the uninterrupted run's, the async file's
   bytes the blocking file's; the file's size and both saves' host
   times printed;
15. kernel flash_attention against its plain version: the six
   FLASH_CASES of tests/test_kernels.py in f32 and bf16, then the
   prefill shapes of Qwen3-14B (1 x 4096, 40 heads, 8 kv heads, D 128,
   causal) and StarCoder2-15B (1 x 6144, 48 heads, 4 kv heads, D 128,
   causal, window 4096), then two cases with query rows that see no key,
   each in f32 and bf16 through the variant the wrapper picks (printed,
   and checked against flash_variant): the Hopper kernel (bf16, D 64 or
   128) per element at 2^-7 |ref| + 2^-8 attn(q, k, |v|) + 2e-5, the
   scalar one at 2e-5 in f32 and 2^-7 |ref| + 2e-5 in bf16; before any
   language model is on the card;
16. serve qwen3-14b: full width and depth (40 layers, 14.8 B parameters,
   bf16, random from seed 0) through repro_torch.launch.serve.generate,
   greedy: (a) the serve CLI's defaults, batch 4 x prompt 64, 32 tokens;
   (b) batch 1 x prompt 4096, 8 tokens. Each shape runs cold (its
   first run), then warm (the timed run), with the same ids; the flash
   counters are set to 0 before and read after each run: one launch per
   layer in the prefill, all of the Hopper variant, and none in decode;
   logits finite; then one prefill and one decode step under
   torch.profiler, each printed with its own host-clock time and the
   card's busy and idle shares;
17. serve starcoder2-15b: full width (40 layers, 16.0 B parameters),
   batch 1 x prompt 6144 (past the 4096 window: the ring cache and the
   window mask both run), 8 tokens, the same checks;
18. reference serve: the qwen3 and starcoder2 smoke configs in f32 on the
   card against the same parameters on the CPU (plain versions):
   prefill logits, caches and 8 greedy ids; the f32 path of the scalar
   flash kernel, one launch a layer in each prefill, none of the Hopper
   one;
19. times: the launch floor (a near-empty launch, timed as the kernels
   are); then CUDA events, median of 50 launches, each after an L2 flush
   and a device sleep that covers the host's enqueue, of each kernel and
   its plain version at the main path's shapes (B1 also at d = 4096; B2
   at 50 x 175,104 in turns with B3b's no-carry call, with pilot
   statistics, and at the streamed finishes 1 x 175,104 and 1 x 4096;
   B3c at 50 x 175,104 in turns with B3b's no-carry call, with in-kernel
   rounding, and at S3's finish 1 x 175,104; B4 with pilot statistics),
   beside the least time the card needs for the bytes or the operations
   and the launch floor (and, where one
   PyTorch call computes the same function, that call: torch.addmv for
   the accumulating transmit, scaled_dot_product_attention for flash
   attention: the Hopper variant at both prefill shapes in bf16, with its
   TFLOP/s and its ratio to scaled_dot_product_attention, and the scalar
   one at Qwen3-14B's in f32); the accumulating transmit's S, and at the
   million-client chunk the same kernel on the same grid without a fold,
   to show what the fold costs;
then one JSON line listing the kernels (and the launch floor), and the
result line.

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

# NVIDIA H100 SXM data sheet: device memory rate, f32 rate outside the
# tensor cores and the dense bf16 tensor-core rate (at the full 700 W
# power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

D_MAIN = 175104          # ResNet-tiny's padded slab (175,066 parameters)
N_CLIENTS = 50
BATCH = 8
ROUNDS = 5
N_STREAM = 200           # the streamed runs S1-S3
STREAM_ROUNDS = 3
SAMPLE_RATE = 0.25
# The JAX package's million-client streamed benchmark
# (benchmarks/train_loop_bench.py, bench_streamed_loop).
N_MILLION = 1_000_000
D_MILLION = 4096
CHUNK_MILLION = 2000
TIMED_LAUNCHES = 50
# Flash attention (B5): tests/test_kernels.py's cases, (B, Sq, Sk, H, K,
# D, causal, window), and the two models' prefill shapes.
FLASH_CASES = [
    (1, 32, 32, 2, 2, 16, True, None),
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 100, 100, 8, 8, 64, True, 48),
    (2, 1, 96, 4, 2, 32, False, None),
    (1, 80, 80, 6, 3, 16, True, 16),
    (1, 33, 65, 2, 1, 8, False, None),
]
FLASH_MODEL_SHAPES = {
    "qwen3-14b": (1, 4096, 4096, 40, 8, 128, True, None),
    "starcoder2-15b": (1, 6144, 6144, 48, 4, 128, True, 4096),
}
# serve runs: (name, arch, batch, prompt, tokens generated)
SERVE_RUNS = (("qwen3-14b a", "qwen3-14b", 4, 64, 32),
              ("qwen3-14b b", "qwen3-14b", 1, 4096, 8),
              ("starcoder2-15b", "starcoder2-15b", 1, 6144, 8))
SERVE_PRESET = "full"
FLASH = "flash_attention"
# Query rows that see no key (a window, Sq > Sk + window - 1): each
# variant must give them the plain version's mean of v over all keys.
FLASH_KEYLESS = [(1, 300, 100, 4, 2, 128, False, 64),
                 (1, 300, 100, 4, 2, 64, True, 64)]
HOPPER_KERNEL = "flash_attention_sm90_kernel"
HOPPER_REGS = 168       # 65,536 / 384 threads, what setmaxnreg rebalances
SLEEP_CYCLES = 4_000_000   # ~2 ms at the H100's 1.98 GHz boost clock


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


class Counter:
    """One launch counter of a kernel wrapper (an attribute of it), with
    the ``launches`` / ``__name__`` interface of a wrapper itself."""

    def __init__(self, fn, attr: str, name: str):
        self.fn, self.attr, self.__name__ = fn, attr, name

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.fn, self.attr, value)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _ptxas_report(lib_path):
    """The compiler's -Xptxas -v report by kernel (mangled name):
    {"regs": "Used N registers, ... smem ...", "spill": "N bytes stack
    frame, N bytes spill stores, N bytes spill loads"}."""
    import re

    # "Used N registers" follows its entry function's "Compiling entry
    # function" line, a spill line its "Function properties for" line
    # (a kernel's own, or a callee's such as the sinf slow path).
    report, entry, props = {}, None, None
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '?([\w]+)", line)
        if m:
            entry = props = m.group(1)
            continue
        m = re.search(r"Function properties for '?([\w]+)", line)
        if m:
            props = m.group(1)
        elif entry and "registers" in line:
            report.setdefault(entry, {})["regs"] = line.split(":", 1)[-1].strip()
        elif props and "spill" in line:
            report.setdefault(props, {})["spill"] = line.strip()
    return report


def phase_build_report(build, lib_path):
    """The kernels as compiled. B1 (adaptive_update_kernel, 24
    instances), B2 (ota_channel_kernel, 4), B3b
    (ota_transmit_stream_kernel, 2), B3c (ota_transmit_kernel, 5) and B4
    (ota_receive_kernel, 6): registers, shared memory and spills from the
    compiler's report (-Xptxas -v), which must show no spill. The Hopper
    flash-attention kernels: the same report, their
    dynamic shared memory, and their SASS, which must hold wgmma (HGMMA)
    and TMA loads (UTMALDG); a register count other than HOPPER_REGS
    would unbalance setmaxnreg, so it fails here, before any launch."""
    import re

    full = _ptxas_report(lib_path)
    for kernel in ("adaptive_update_kernel", "ota_channel_kernel",
                   "ota_transmit_stream_kernel", "ota_transmit_kernel",
                   "ota_receive_kernel"):
        found = {fn: r for fn, r in full.items() if kernel in fn}
        check(len(found) > 0 and all("regs" in r for r in found.values()),
              f"no compiler report for {kernel}")
        regs = sorted({int(re.search(r"Used (\d+) registers",
                                     r["regs"]).group(1))
                       for r in found.values()})
        smem = sorted({m.group(0) for r in found.values()
                       for m in [re.search(r"[\d+]+ bytes smem", r["regs"])]
                       if m})
        spills = sum(int(n) for r in found.values() for n in re.findall(
            r"(\d+) bytes spill", r.get("spill", "")))
        check(spills == 0, f"{kernel}: {spills} bytes of spill stores and "
              "loads")
        print(f"[build] {kernel}: {len(found)} instances, registers "
              f"{regs[0]}-{regs[-1]}, static shared memory "
              f"{', '.join(smem) or 'none'}, 0 bytes spilled; e.g. "
              + "; ".join(f"{r['regs']} / {r.get('spill', '')}"
                          for r in list(found.values())[:2]) + "; ok")
    report = {fn: r for fn, r in full.items() if HOPPER_KERNEL in fn}
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops, fn = {}, None     # SASS instructions by kernel: wgmma, TMA
    for line in sass.splitlines():   # loads, setmaxnreg, local memory
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if HOPPER_KERNEL in fn:
                ops[fn] = dict.fromkeys(("HGMMA", "UTMALDG", "USETMAXREG",
                                         "LDL", "STL"), 0)
        elif fn in ops:
            for op in ops[fn]:
                ops[fn][op] += f" {op}" in line
    lib = build.load_library()
    check(len(report) == 2 and len(ops) == 2,
          f"{HOPPER_KERNEL}: {len(report)} compiler reports and {len(ops)} "
          "SASS listings, want 2 each (D = 64, 128)")
    for fn in sorted(report):
        d = 128 if "ILi128E" in fn else 64
        regs = int(re.search(r"Used (\d+) registers",
                             report[fn]["regs"]).group(1))
        check(regs == HOPPER_REGS, f"{HOPPER_KERNEL}<{d}>: {regs} registers "
              f"at entry, want {HOPPER_REGS}")
        count = ops[fn]
        check(count["HGMMA"] > 0 and count["UTMALDG"] > 0,
              f"{HOPPER_KERNEL}<{d}> SASS: {count}")
        print(f"[build] {HOPPER_KERNEL}<D={d}>: {report[fn]['regs']}; "
              f"{report[fn].get('spill', '')}; dynamic shared memory "
              f"{lib.repro_flash_attention_sm90_smem(d)} B; SASS "
              + ", ".join(f"{op} x{n}" for op, n in count.items()) + "; ok")


def phase_kernel_update(torch, dev):
    """B1 against its plain version: six modes x f32 / bf16 g and w x
    alpha 1.2 / 1.5 / 2.0, at the main path's slab, at the same slab
    three elements off its allocation (no operand 16-byte aligned), and
    at the million-client stream's slab. Returns the worst f32 error by
    slab length."""
    from repro_torch.kernels.adaptive_update import (MODES,
                                                     adaptive_update_slab)
    from repro_torch.kernels.ref import adaptive_update_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    worst_f32, worst_rel, worst_bf16 = {}, 0.0, 0.0
    cases = 0
    for d, offset in ((D_MAIN, 0), (D_MAIN, 3), (D_MILLION, 0)):
        def r(scale=1.0):
            return (scale * torch.randn(d + offset, generator=gen,
                                        device=dev))[offset:]
        for dtype in (torch.float32, torch.bfloat16):
            g, w = r().to(dtype), r().to(dtype)
            delta = r(0.1)
            delta[::17] = 0.0
            nu = r(0.01).abs()
            nu_max = nu + r(0.01).abs()
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
                              f"adaptive_update_slab d={d}+{offset} {mode} "
                              f"{dtype} a={alpha} output {i}: max err "
                              f"{float(err.max())}")
                        worst_f32[d] = max(worst_f32.get(d, 0.0),
                                           float(err.max()))
                        worst_rel = max(worst_rel, float(
                            (err / b.abs().clamp_min(1e-30)).max()))
    check(worst_bf16 <= 1.0, f"bf16 w off by {worst_bf16} steps")
    print(f"[kernel adaptive_update_slab] {cases} cases (6 modes x f32/bf16 "
          f"x alpha 1.2/1.5/2.0 at d={D_MAIN}, at d={D_MAIN} 3 elements off "
          f"16-byte alignment, and at d={D_MILLION}): max_abs_err="
          f"{max(worst_f32.values()):.3e} max_rel_err={worst_rel:.3e} (tol "
          f"1e-6 rel + 1e-6 of scale); bf16 w within {worst_bf16:.2f} bf16 "
          f"steps (tol 1) ok")
    return worst_f32


# B2's shapes: (N, d) -> what runs it. The streamed finishes are one row
# (h = 1, n_total = 1); 2000 x 4096 stages h in two chunks; 37 x 4097
# (d % 4 != 0) takes the plain-load path.
CHANNEL_SHAPES = {(N_CLIENTS, D_MAIN): "the resident round",
                  (1, D_MAIN): "the streamed finish, S1-S3",
                  (1, D_MILLION): "the million-client finish",
                  (CHUNK_MILLION, D_MILLION): "h in two chunks",
                  (37, 4097): "d % 4 != 0: plain loads"}


def phase_kernel_channel(torch, dev, total):
    """B2 against its plain version: at the main path's 50 x 175,104
    alpha 1.2 / 1.5 / 2.0, then every CHANNEL_SHAPES entry at alpha 1.5,
    each with pilot statistics on and off; the padding exactly 0 and the
    statistics' count exact. The bulk-copy ring and the plain loads (the
    same rows 4 bytes off a 16-byte boundary) agree bitwise. Returns the
    worst error by shape."""
    from repro_torch.core.channel import CMS_U_BOUND
    from repro_torch.kernels.ota_channel import ota_channel_slab
    from repro_torch.kernels.ref import ota_channel_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    worst, worst_stats, cases = {}, 0.0, 0
    for n, d in CHANNEL_SHAPES:
        grads = torch.randn(n, d, generator=gen, device=dev)
        h = (torch.ones(n, device=dev) if n == 1 else
             0.5 + torch.rand(n, generator=gen, device=dev))
        u = (2 * torch.rand(d, generator=gen, device=dev) - 1) * CMS_U_BOUND
        e = -torch.log(torch.rand(d, generator=gen, device=dev))
        # the slab's padding tail: no gradient, the CMS fixed point (0, 1)
        pad = D_MAIN - total if d == D_MAIN else 38
        grads[:, d - pad:], u[d - pad:], e[d - pad:] = 0.0, 0.0, 1.0
        n_total = 1 if n == 1 else None
        alphas = (1.2, 1.5, 2.0) if (n, d) == (N_CLIENTS, D_MAIN) else (1.5,)
        for alpha in alphas:
            for stats in (False, True):
                kw = dict(alpha=alpha, scale=0.1, pilot_stats=stats,
                          n_total=n_total)
                got = ota_channel_slab(grads, h, u, e, **kw)
                want = ota_channel_ref(grads, h, u, e, **kw)
                torch.cuda.synchronize()
                what = f"ota_channel_slab {n}x{d} a={alpha} stats={stats}"
                if stats:
                    (got, gs), (want, ws) = got, want
                    check(float(gs[0]) == float(ws[0]) == d - pad,
                          f"{what}: count {float(gs[0])} vs {float(ws[0])}")
                    rel = float(((gs - ws).abs()
                                 / ws.abs().clamp_min(1)).max())
                    check(rel <= 1e-5, f"{what}: stats rel err {rel}")
                    worst_stats = max(worst_stats, rel)
                err = (got - want).abs()
                scale = float(want.abs().max())
                check(bool(torch.all(err <= 1e-6 * want.abs()
                                     + 1e-6 * scale)),
                      f"{what}: max err {float(err.max())}")
                check(bool(torch.all(got[d - pad:] == 0.0)),
                      f"{what}: padding not 0")
                worst[(n, d)] = max(worst.get((n, d), 0.0), float(err.max()))
                cases += 1
        if d % 4 == 0 and n > 1:
            off = torch.empty(grads.numel() + 1, device=dev)[1:].view(n, d)
            off.copy_(grads)
            check(torch.equal(ota_channel_slab(grads, h, u, e, alpha=1.5,
                                               scale=0.1),
                              ota_channel_slab(off, h, u, e, alpha=1.5,
                                               scale=0.1)),
                  f"ota_channel_slab {n}x{d}: the load paths disagree")
            del off
    print(f"[kernel ota_channel_slab] {cases} cases ({N_CLIENTS}x{D_MAIN} "
          f"alpha 1.2/1.5/2.0, then " + ", ".join(
              f"{n}x{d} ({what})" for (n, d), what in CHANNEL_SHAPES.items()
              if (n, d) != (N_CLIENTS, D_MAIN))
          + " at alpha 1.5; stats on/off): max_abs_err="
          f"{max(worst.values()):.3e} (tol 1e-6 rel + 1e-6 of scale); "
          f"padding exactly 0; stats max_rel_err={worst_stats:.3e} (tol "
          f"1e-5), count exact; the bulk-copy ring and plain loads bitwise "
          f"equal at {N_CLIENTS}x{D_MAIN} and {CHUNK_MILLION}x{D_MILLION}; ok")
    return worst


def _wire_inputs(torch, dev, total, seed):
    """50 x 175,104 gradients, fading, SR uniforms and a residual carry,
    the padding tail zero as the round's slab has it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = torch.randn(N_CLIENTS, D_MAIN, generator=gen, device=dev)
    h = 0.5 + torch.rand(N_CLIENTS, generator=gen, device=dev)
    r = torch.rand(D_MAIN, generator=gen, device=dev)
    ef = 0.01 * torch.randn(D_MAIN, generator=gen, device=dev)
    grads[:, total:], ef[total:] = 0.0, 0.0
    return grads, h, r, ef


def _check_transmit(torch, got, want, x, what):
    """Payload equal on >= 99.9 % of entries and within one step on the
    rest; scales within 1e-6 rel + 1e-6 of their largest; the residual
    within 1e-6 rel + 1e-6 of max|x| where the payloads agree and within
    one step where an entry flipped. Returns the largest error."""
    q, s = got[0].float(), got[1]
    qw, sw = want[0].float(), want[1]
    same = q == qw
    check(float(same.float().mean()) >= 0.999, f"{what}: payload equal on "
          f"{float(same.float().mean()):.5f} of entries")
    check(bool(torch.all((q - qw).abs() <= 1.0)), f"{what}: payload off "
          "by more than one step")
    err_s = (s - sw).abs()
    check(bool(torch.all(err_s <= 1e-6 * sw.abs() + 1e-6 * float(
        sw.abs().max()))), f"{what}: scales err {float(err_s.max())}")
    worst = float(err_s.max())
    if len(got) == 3:
        err = (got[2] - want[2]).abs()
        tol = 1e-6 * want[2].abs() + 1e-6 * float(x.abs().max())
        step = sw.repeat_interleave(128)
        check(bool(torch.all(torch.where(same, err <= tol,
                                         err <= step * (1 + 1e-6)))),
              f"{what}: residual err {float(err.max())}")
        worst = max(worst, float(torch.where(same, err,
                                             torch.zeros_like(err)).max()))
    return worst, int((~same).sum())


def phase_kernel_transmit(torch, dev, total):
    from repro_torch.kernels.ota_channel import ota_transmit_slab
    from repro_torch.kernels.ref import ota_transmit_ref

    grads, h, r, ef = _wire_inputs(torch, dev, total, 4)
    worst, flips, cases = 0.0, 0, 0
    modes = [("int8", True, False), ("int8", False, False),
             ("sign", False, False), ("sign", False, True)]
    for qmode, stochastic, zero_fold in modes:
        for use_ef in (False, True):
            kw = dict(quantize=True, r=r if stochastic else None,
                      stochastic=stochastic, qmode=qmode, zero_fold=zero_fold,
                      ef=ef if use_ef else None, return_residual=use_ef)
            got = ota_transmit_slab(grads, h, **kw)
            want = ota_transmit_ref(grads, h, **kw)
            x = ota_transmit_ref(grads, h) + (ef if use_ef else 0.0)
            torch.cuda.synchronize()
            what = f"ota_transmit_slab {qmode} sr={stochastic} " \
                   f"fold={zero_fold} ef={use_ef}"
            w, f = _check_transmit(torch, got, want, x, what)
            worst, flips, cases = max(worst, w), flips + f, cases + 1
            check(bool(torch.all(got[0][total:] == (1 if zero_fold else 0))),
                  f"{what}: padding payload")
            if use_ef and not zero_fold:
                # (under fold the round re-masks the tail afterwards)
                check(bool(torch.all(got[2][total:] == 0.0)),
                      f"{what}: padding residual")
    # In-kernel Philox rounding: another uniform stream, so held to one
    # step of x/s on every entry and to zero bias over the slab.
    x = ota_transmit_ref(grads, h) + ef
    q, s, res = ota_transmit_slab(grads, h, quantize=True, sr_seed=12345,
                                  ef=ef, return_residual=True)
    torch.cuda.synchronize()
    sb = s.repeat_interleave(128)
    y = x / sb
    dev_steps = (q.float() - y)[:total]
    check(bool(torch.all(dev_steps.abs() < 1.0 + 1e-5)),
          f"in-kernel SR: {float(dev_steps.abs().max())} steps from x/s")
    frac = (y - torch.floor(y))[:total].double()
    se = float(torch.sqrt((frac * (1 - frac)).sum())) / total
    bias = float(dev_steps.double().mean())
    check(abs(bias) <= 3 * se, f"in-kernel SR bias {bias} vs 3 se "
          f"{3 * se}")
    check(bool(torch.all((res - (x - q.float() * sb)).abs()
                         <= 1e-6 * x.abs().max())), "in-kernel SR residual")
    check(bool(torch.all(q[total:] == 0)), "in-kernel SR padding")
    print(f"[kernel ota_transmit_slab] N={N_CLIENTS} d={D_MAIN} {cases} cases "
          f"(int8 SR/RTN, sign, sign fold x EF on/off): scales and residual "
          f"max_abs_err={worst:.3e} (tol 1e-6 rel + 1e-6 of scale); payload "
          f"entries one step apart: {flips} of {cases * D_MAIN} (tol 0.1 %); "
          f"padding exact; in-kernel SR within one step, mean (q - x/s) = "
          f"{bias:.3e} vs 3 se {3 * se:.3e}; ok")
    _check_transmit_composition(torch, dev, grads, h, r, ef)
    return worst


def _check_transmit_composition(torch, dev, grads, h, r, ef):
    """The kernel's output against the plain quantizer applied to its own
    sum: x = the accumulating transmit's no-carry call + ef, and
    ota_transmit_ref(x[None], 1, n_total=1) must give the kernel's int8
    payload, scales and residual (host rounding, RTN) and its sign
    payload bit for bit; the sign scales and residuals within 1e-6 rel +
    1e-6 of scale (the warp sums |x| in another order than torch.mean).
    At 50 x 175,104, at 1 x 175,104 as the streamed finish calls it
    (h = 1, n_total = 1), and at 7 x 640 (a last tile of one
    quantization block)."""
    from repro_torch.kernels.ota_channel import ota_transmit_slab
    from repro_torch.kernels.ref import ota_transmit_ref

    one = torch.ones(1, device=dev)
    small = slice(D_MAIN - 640, None)     # 640 columns, the padding last
    shapes = ((f"{N_CLIENTS}x{D_MAIN}", grads, h, None, r, ef),
              (f"1x{D_MAIN}", grads[:1], one, 1, r, ef),
              ("7x640", grads[:7, small].contiguous(), h[:7], None,
               r[small].contiguous(), ef[small].contiguous()))
    modes = [("int8", True, False), ("int8", False, False),
             ("sign", False, False), ("sign", False, True)]
    worst, cases = 0.0, 0
    for shape, g, hh, n_total, rr, ee in shapes:
        x = ota_transmit_slab(g, hh, n_total=n_total) + ee
        for qmode, stochastic, zero_fold in modes:
            sr = qmode == "int8" and stochastic
            kw = dict(quantize=True, r=rr if sr else None,
                      stochastic=stochastic, qmode=qmode,
                      zero_fold=zero_fold, return_residual=True)
            got = ota_transmit_slab(g, hh, n_total=n_total, ef=ee, **kw)
            want = ota_transmit_ref(x[None], one, n_total=1, **kw)
            torch.cuda.synchronize()
            what = (f"ota_transmit_slab {shape} {qmode} sr={stochastic} "
                    f"fold={zero_fold}: the plain quantizer on its sum")
            check(torch.equal(got[0], want[0]), f"{what}: payload differs "
                  f"on {int((got[0] != want[0]).sum())} entries")
            if qmode == "int8":
                check(torch.equal(got[1], want[1]), f"{what}: scales")
                check(torch.equal(got[2], want[2]), f"{what}: residual")
            else:
                scale = float(x.abs().max())
                for a, b, name in ((got[1], want[1], "scales"),
                                   (got[2], want[2], "residual")):
                    err = (a - b).abs()
                    check(bool(torch.all(err <= 1e-6 * b.abs()
                                         + 1e-6 * scale)),
                          f"{what}: {name} err {float(err.max())}")
                    worst = max(worst, float(err.max()))
            cases += 1
    print(f"[kernel ota_transmit_slab] the plain quantizer on the kernel's "
          f"own sum (the accumulating transmit's no-carry call + ef), at "
          f"{', '.join(s[0] for s in shapes)}, {cases} cases: int8 payload, "
          f"scales and residual and the sign payload bitwise; sign scales "
          f"and residuals max_abs_err={worst:.3e} (tol 1e-6 rel + 1e-6 of "
          f"scale); ok")


def phase_kernel_receive(torch, dev, total):
    from repro_torch.core.channel import CMS_U_BOUND
    from repro_torch.kernels.ota_channel import (ota_receive_slab,
                                                 pack_sign_slab)
    from repro_torch.kernels.ref import ota_receive_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    u = (2 * torch.rand(D_MAIN, generator=gen, device=dev) - 1) * CMS_U_BOUND
    e = -torch.log(torch.rand(D_MAIN, generator=gen, device=dev))
    u[total:], e[total:] = 0.0, 1.0
    worst = worst_stats = 0.0
    cases = 0
    for rows in (1, 3):
        s = torch.rand(rows, D_MAIN // 128, generator=gen, device=dev)
        q8 = torch.randint(-127, 128, (rows, D_MAIN), generator=gen,
                           device=dev, dtype=torch.int8)
        q3 = torch.randint(-1, 2, (rows, D_MAIN), generator=gen, device=dev,
                           dtype=torch.int8)
        q8[:, total:], q3[:, total:] = 0, 0
        payloads = {None: q8,
                    "fold": pack_sign_slab(torch.where(q3 < 0, -1, 1).to(
                        torch.int8)),
                    "planes": pack_sign_slab(q3, planes=True)}
        for packed, payload in payloads.items():
            for alpha in (1.2, 1.5, 2.0):
                for stats in (False, True):
                    kw = dict(alpha=alpha, scale=0.1, packed=packed,
                              pilot_stats=stats)
                    got = ota_receive_slab(payload, s, u, e, **kw)
                    want = ota_receive_ref(payload, s, u, e, **kw)
                    torch.cuda.synchronize()
                    cases += 1
                    what = f"ota_receive_slab R={rows} {packed} a={alpha}"
                    if stats:
                        (got, gs), (want, ws) = got, want
                        check(float(gs[0]) == float(ws[0]) == total,
                              f"{what}: stats count {float(gs[0])}")
                        rel = float(((gs - ws).abs()
                                     / ws.abs().clamp_min(1)).max())
                        check(rel <= 1e-5, f"{what}: stats rel err {rel}")
                        worst_stats = max(worst_stats, rel)
                    err = (got - want).abs()
                    check(bool(torch.all(err <= 1e-6 * want.abs() + 1e-6
                                         * float(want.abs().max()))),
                          f"{what}: max err {float(err.max())}")
                    if packed != "fold":
                        check(bool(torch.all(got[total:] == 0.0)),
                              f"{what}: padding not 0")
                    worst = max(worst, float(err.max()))
    print(f"[kernel ota_receive_slab] d={D_MAIN} {cases} cases (R 1/3 x int8"
          f"/fold/planes x alpha 1.2/1.5/2.0 x stats on/off): max_abs_err="
          f"{worst:.3e} (tol 1e-6 rel + 1e-6 of scale); padding exactly 0 on "
          f"int8 and planes; stats max_rel_err={worst_stats:.3e} (tol 1e-5), "
          "count exact; ok")
    return max(worst, _check_receive_grid(torch, dev, u, e, total))


def _check_receive_grid(torch, dev, u, e, total):
    """The receive kernel's grid and its statistics fold: every instance
    resident in one wave at the main path's slab (blocks an SM x SMs >=
    receive_blocks); with pilot statistics one launch (the profiler sees
    one kernel: no second launch sums the blocks' rows), the same bits in
    two runs, the ticket counter back at 0; and 640 columns (R = 1, two
    quantization blocks of padding) against the plain version. Returns
    the largest output error."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ota_channel import (_PACKED, _TILE_COUNTERS,
                                                 RECEIVE_THREADS,
                                                 ota_receive_slab,
                                                 pack_sign_slab,
                                                 receive_blocks, sm_count)
    from repro_torch.kernels.ref import ota_receive_ref

    lib = build.load_library()
    sms, blocks = sm_count(dev.index), receive_blocks(D_MAIN)
    per_sm = {(p, st): lib.repro_ota_receive_blocks_per_sm(_PACKED[p], st)
              for p in _PACKED for st in (0, 1)}
    check(all(n * sms >= blocks for n in per_sm.values()),
          f"receive grid of {blocks} blocks not resident on {sms} SMs: "
          f"blocks an SM {per_sm}")
    gen = torch.Generator(device=dev).manual_seed(7)
    s = torch.rand(1, D_MAIN // 128, generator=gen, device=dev)
    q = torch.randint(-127, 128, (1, D_MAIN), generator=gen, device=dev,
                      dtype=torch.int8)
    q[:, total:] = 0
    worst = 0.0
    for packed, payload in ((None, q), ("fold", pack_sign_slab(
            torch.where(q < 0, -1, 1).to(torch.int8)))):
        kw = dict(alpha=1.5, scale=0.1, packed=packed, pilot_stats=True)
        first = ota_receive_slab(payload, s, u, e, **kw)
        n0 = ota_receive_slab.launches
        _, dev_ev = _profile_run(torch, lambda: ota_receive_slab(
            payload, s, u, e, **kw))
        names = [a.key for a in dev_ev for _ in range(a.count)]
        check(ota_receive_slab.launches == n0 + 1 and len(names) == 1
              and "ota_receive_kernel" in names[0],
              f"receive with statistics ({packed}): kernels {names}")
        again = ota_receive_slab(payload, s, u, e, **kw)
        torch.cuda.synchronize()
        check(torch.equal(first[0], again[0])
              and torch.equal(first[1], again[1]),
              f"receive with statistics ({packed}): runs differ")
        check(all(int(c.abs().sum()) == 0 for c in _TILE_COUNTERS.values()),
              "receive: ticket counter not back at 0")
    d = 640
    cols = slice(D_MAIN - d, None)
    for packed in (None, "fold", "planes"):
        q3 = torch.randint(-1, 2, (1, d), generator=gen, device=dev,
                           dtype=torch.int8)
        q3[:, d - 38:] = 0
        payload = (torch.randint(-127, 128, (1, d), generator=gen,
                                 device=dev, dtype=torch.int8)
                   if packed is None else pack_sign_slab(
                       torch.where(q3 < 0, -1, 1).to(torch.int8)
                       if packed == "fold" else q3,
                       planes=packed == "planes"))
        if packed is None:
            payload[:, d - 38:] = 0
        sd = s[:, :d // 128].contiguous()
        ud, ed = u[cols].contiguous(), e[cols].contiguous()
        kw = dict(alpha=1.5, scale=0.1, packed=packed, pilot_stats=True)
        (got, gs), (want, ws) = (ota_receive_slab(payload, sd, ud, ed, **kw),
                                 ota_receive_ref(payload, sd, ud, ed, **kw))
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(bool(torch.all(err <= 1e-6 * want.abs() + 1e-6
                             * float(want.abs().max()))),
              f"ota_receive_slab 1x{d} {packed}: max err {float(err.max())}")
        rel = float(((gs - ws).abs() / ws.abs().clamp_min(1)).max())
        check(float(gs[0]) == float(ws[0]) and rel <= 1e-5,
              f"ota_receive_slab 1x{d} {packed}: stats {gs.tolist()} vs "
              f"{ws.tolist()}")
        worst = max(worst, float(err.max()))
    print(f"[kernel ota_receive_slab] grid: {blocks} blocks of "
          f"{RECEIVE_THREADS} threads at d={D_MAIN}, resident in one wave "
          f"({min(per_sm.values())}-"
          f"{max(per_sm.values())} blocks an SM x {sms} SMs); with pilot "
          f"statistics one launch (int8, fold), the same bits in two runs, "
          f"the ticket counter back at 0; 1x640 int8 / fold / planes with "
          f"statistics max_abs_err={worst:.3e} (tol 1e-6 rel + 1e-6 of "
          f"scale); ok")
    return worst


def phase_runtime_alpha(torch, dev, total):
    """The update with alpha a device tensor, and the server half of a
    tracked round with host syncs made errors."""
    from repro_torch.core.adaptive import AdaptiveConfig, slab_update_slabs
    from repro_torch.core.tail_index import effective_alpha, update_alpha_ema
    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.ota_channel import ota_channel_slab
    from repro_torch.kernels.ref import adaptive_update_ref

    gen = torch.Generator(device=dev).manual_seed(6)
    g, w = (torch.randn(D_MAIN, generator=gen, device=dev) for _ in range(2))
    delta = 0.1 * torch.randn(D_MAIN, generator=gen, device=dev)
    delta[::17] = 0.0
    nu = 0.01 * torch.rand(D_MAIN, generator=gen, device=dev)
    nu_max = nu + 0.01 * torch.rand(D_MAIN, generator=gen, device=dev)
    worst = 0.0
    for mode in ("adagrad", "adam", "amsgrad", "yogi"):
        for a in (1.2, 1.5, 1.83, 2.0):
            kw = dict(lr=0.01, beta1=0.9, beta2=0.3, eps=1e-8, mode=mode,
                      nu_max=nu_max if mode == "amsgrad" else None,
                      alpha=torch.tensor(a, device=dev))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:    # the kernel reads alpha where it lies: no host sync
                got = adaptive_update_slab(g, delta, nu, w, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = adaptive_update_ref(g, delta, nu, w, **kw)
            torch.cuda.synchronize()
            for i, (x, y) in enumerate(zip(got, want)):
                err = (x - y).abs()
                check(bool(torch.all(err <= 1e-6 * y.abs() + 1e-6 * float(
                    y.abs().max()))), f"runtime alpha {mode} a={a} output "
                      f"{i}: max err {float(err.max())}")
                worst = max(worst, float(err.max()))
    grads, h, _, _ = _wire_inputs(torch, dev, total, 7)
    # the CMS draws of a real round: u uniform on the open half-circle,
    # e ~ Exp(1); the residual is then alpha-stable with alpha = 1.5
    u = (2 * torch.rand(D_MAIN, generator=gen, device=dev) - 1) * 1.5707
    e = -torch.log(torch.rand(D_MAIN, generator=gen, device=dev))
    u[total:], e[total:] = 0.0, 1.0
    cfg = AdaptiveConfig(optimizer="adam_ota", lr=0.01, alpha="auto")
    alpha_hat = torch.zeros((), device=dev)
    state = (delta.clone(), nu.clone())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            g_slab, stats = ota_channel_slab(grads, h, u, e, alpha=1.5,
                                             scale=0.1, pilot_stats=True)
            alpha_hat = update_alpha_ema(alpha_hat, stats, cfg.alpha_ema)
            state, w = slab_update_slabs(cfg, g_slab, state, w,
                                         alpha=effective_alpha(alpha_hat))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(abs(float(alpha_hat) - 1.5) < 0.1, f"alpha_hat {float(alpha_hat)}")
    check(bool(torch.isfinite(w).all()), "tracked update: w not finite")
    print(f"[runtime alpha] adaptive_update_slab with a device alpha, 16 "
          f"cases (4 modes x alpha 1.2/1.5/1.83/2.0), each launched under "
          f"sync_debug_mode='error': max_abs_err="
          f"{worst:.3e} (tol 1e-6 rel + 1e-6 of scale); 3 tracked server "
          f"steps (MAC + stats, EMA, update) under sync_debug_mode='error' "
          f"with no host sync, alpha_hat={float(alpha_hat):.4f}; ok")
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


def phase_reference_wire(torch, np):
    """Quantized rounds on the card against the same rounds on the CPU
    (plain versions), same draws: logistic regression, 3 rounds."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import FLConfig, make_slab_round_step
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.models.vision import logistic_regression

    rng = np.random.default_rng(1)
    model = logistic_regression(16, 4)
    params = model.init(seed=2, device="cpu")
    worst = {}
    for name, up in (("int8+EF", UplinkConfig(mode="int8",
                                              error_feedback=True)),
                     ("sign fold+EF", UplinkConfig(mode="sign",
                                                   error_feedback=True))):
        ch = OTAChannelConfig(uplink=up)
        ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01)
        fl = FLConfig(n_clients=4)
        states = {d: init_train_state(ad, params, error_feedback=True,
                                      device=d) for d in ("cpu", "cuda")}
        steps = {d: make_slab_round_step(model.loss_fn, ch, ad, fl, device=d)
                 for d in states}
        draws = TorchDraws(ch, states["cpu"].spec, 4, seed=5, device="cpu")
        for t in range(3):
            batch = {"x": rng.normal(size=(4, 3, 16)).astype(np.float32),
                     "y": rng.integers(0, 4, (4, 3)).astype(np.int64)}
            for d in states:
                states[d], _ = steps[d](states[d], draws(t), batch)
        err = 0.0
        for a, b in ((states["cuda"].w, states["cpu"].w),
                     (states["cuda"].ef, states["cpu"].ef),
                     *zip(states["cuda"].opt, states["cpu"].opt)):
            a = a.cpu()
            check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)),
                  f"{name}: card vs CPU differ by {float((a - b).abs().max())}")
            err = max(err, float((a - b).abs().max()))
        check(float(states["cuda"].ef.abs().max()) > 0.0, f"{name}: ef zero")
        worst[name] = err
    print("[reference] quantized rounds on the card vs on the CPU (plain "
          "versions), same draws, logreg 3 rounds: "
          + ", ".join(f"{k} max|d(w, opt, ef)|={v:.3e}"
                      for k, v in worst.items()) + " (tier 1e-5); ok")


WIRE_RUNS = ("f32-auto", "int8-ef-dl8-auto", "sign-fold-ef", "int8-srk-ef")


def phase_wire_runs(torch, np, dev, counters):
    """Four runs of the main path on the wire's configurations. Every
    counter is set to 0 just before each run and read just after.
    Returns the launches over all of them and those of each run."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    data = synthetic_images(3000, 32, 3, 10, seed=0)
    fl = FLConfig(n_clients=N_CLIENTS)
    configs = {
        "f32-auto": (OTAChannelConfig(), "auto",
                     {"ota_channel_slab", "adaptive_update_slab"}),
        "int8-ef-dl8-auto": (
            OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                                 error_feedback=True),
                             downlink="int8"), "auto",
            {"ota_transmit_slab", "ota_receive_slab",
             "adaptive_update_slab"}),
        "sign-fold-ef": (
            OTAChannelConfig(uplink=UplinkConfig(mode="sign",
                                                 error_feedback=True,
                                                 sign_pack="fold")), 1.5,
            {"ota_transmit_slab", "ota_receive_slab",
             "adaptive_update_slab"}),
        # the transmit kernel draws its own rounding uniforms (Philox)
        "int8-srk-ef": (
            OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                                 error_feedback=True,
                                                 sr_inkernel=True)), 1.5,
            {"ota_transmit_slab", "ota_receive_slab",
             "adaptive_update_slab"}),
    }
    totals = {c.__name__: 0 for c in counters}
    by_run = {}
    for name in WIRE_RUNS:
        ch, alpha, launched = configs[name]
        ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01, alpha=alpha)
        ef = ch.uplink.error_feedback
        state = init_train_state(ad, model.init(seed=0, device=dev),
                                 error_feedback=ef, device=dev)
        run = make_slab_round_runner(model.loss_fn, ch, ad, fl, device=dev)
        draws = TorchDraws(ch, state.spec, N_CLIENTS, seed=1, device=dev)
        batcher = FederatedBatcher(data, N_CLIENTS, BATCH, seed=1)
        # one warm-up round outside the counted run
        run_rounds_slab(run, state, lambda t: draws(1000 + t), batcher, 1)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        state, hist = run_rounds_slab(run, state, draws, batcher, ROUNDS,
                                      chunk=ROUNDS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / ROUNDS
        counts = {c.__name__: c.launches for c in counters}
        want = {k: ROUNDS if k in launched else 0 for k in counts}
        check(counts == want, f"{name}: launches {counts}, want {want}")
        by_run[name] = counts
        for k, v in counts.items():
            totals[k] += v
        losses = [x["loss"] for x in hist]
        check(all(math.isfinite(x) for x in losses), f"{name}: losses "
              f"{losses}")
        check(bool(torch.isfinite(state.w).all()), f"{name}: w not finite")
        check(int(state.step) == ROUNDS, f"{name}: step {int(state.step)}")
        extra = ""
        if alpha == "auto":
            a_hat = float(state.alpha_hat)
            check(abs(a_hat - ch.alpha) <= 0.1, f"{name}: alpha_hat {a_hat}")
            extra += f"; alpha_hat {a_hat:.4f} (channel 1.5, tol 0.1)"
        if ef:
            check(bool(torch.isfinite(state.ef).all())
                  and float(state.ef.abs().max()) > 0.0, f"{name}: ef")
            extra += f"; max|ef| {float(state.ef.abs().max()):.3e}"
        if ch.uplink.zero_fold:
            check(bool(torch.all(state.w[state.spec.total:] == 0.0)),
                  f"{name}: w padding tail not 0")
            extra += "; w padding tail exactly 0"
        print(f"[main path] {name}: resnet_tiny full width, {N_CLIENTS} "
              f"clients x batch {BATCH}, adam_ota, {ROUNDS} rounds: losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; {ms:.2f} ms/round (host clock, synchronized); launches "
              f"{counts}{extra}; ok")
    return totals, by_run


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


def _quad_loss(p, b):
    """The JAX package's streamed benchmark loss: each client pulls w
    towards sin(phase) of its own index."""
    return (p["w"] - b["phase"].sin()).square().mean()


def _phase_batch(draws, idx):
    """A client's data is a function of its index: nothing of size N is
    ever materialised."""
    return {"phase": idx.float() * 1e-3}


def _million_rows(torch, dev):
    """The million-client path's first chunk: its 2000 x 4096 gradient
    rows (the port's vmap of the quadratic loss at a random w) and its
    fading draw."""
    from torch.func import grad, vmap

    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.slab import make_slab_spec

    gen = torch.Generator(device=dev).manual_seed(10)
    w = {"w": torch.randn(D_MILLION, generator=gen, device=dev)}
    idx = torch.arange(CHUNK_MILLION, device=dev)
    g = vmap(grad(_quad_loss), in_dims=(None, 0))(w, _phase_batch(None, idx))
    draws = TorchDraws(OTAChannelConfig(), make_slab_spec(w), N_MILLION,
                       seed=2, device=dev)(0)
    return g["w"].contiguous(), draws.h[:CHUNK_MILLION].contiguous()


def phase_kernel_stream(torch, dev, total):
    """The accumulating transmit (B3b; B3a through it) against its plain
    version; where the rows split across blocks (S > 1), also bitwise
    against the kernel's summation order written out in torch
    (ota_transmit_split_model) and against itself run to run; one chunk
    with no carry against the channel kernel."""
    from repro_torch.kernels.ota_channel import (ota_channel_slab,
                                                 ota_transmit_slab,
                                                 ota_transmit_split_model,
                                                 row_split, sm_count)
    from repro_torch.kernels.ref import ota_transmit_ref

    sms = sm_count(dev.index)
    gen = torch.Generator(device=dev).manual_seed(9)
    carry_all = (None, 1, 7, "N")
    # (n, d, padding columns, row chunks; the carry cases' only, when
    # the case is there for the split)
    shapes = [(N_CLIENTS, D_MAIN, D_MAIN - total, carry_all, False),
              (37, 4097, 38, carry_all, False),
              (CHUNK_MILLION, D_MILLION, 0, carry_all + (64, 1999), False),
              (2001, 4100, 0, (None, 64), True),
              (5, D_MILLION, 0, (None,), True)]
    worst, cases, splits, seen = 0.0, 0, 0, []
    for n, d, pad, chunks, split_only in shapes:
        if n == CHUNK_MILLION:
            grads, h = _million_rows(torch, dev)
        else:
            grads = torch.randn(n, d, generator=gen, device=dev)
            h = 0.5 + torch.rand(n, generator=gen, device=dev)
        acc = torch.randn(d, generator=gen, device=dev)
        if pad:
            grads[:, d - pad:], acc[d - pad:] = 0.0, 0.0
        kws = [] if split_only else [dict()]
        for rc in chunks:
            rc = n if rc == "N" else rc
            kws += [dict(n_total=n + 3, acc=a, row_chunk=rc)
                    for a in ((acc,) if split_only else (None, acc))]
        for kw in kws:
            n_seg = row_split(n, d, kw.get("row_chunk"),
                              kw.get("acc") is not None, sms)
            n0 = ota_transmit_slab.stream_launches
            got = ota_transmit_slab(grads, h, **kw)
            want = ota_transmit_ref(grads, h, **kw)
            torch.cuda.synchronize()
            check(ota_transmit_slab.stream_launches == n0 + 1,
                  "stream transmit did not launch its kernel")
            err = (got - want).abs()
            scale = float(want.abs().max())
            what = (f"ota_transmit_slab {n}x{d} carry="
                    f"{kw.get('acc') is not None} "
                    f"row_chunk={kw.get('row_chunk')} S={n_seg}")
            check(bool(torch.all(err <= 1e-6 * want.abs() + 1e-6 * scale)),
                  f"{what}: max err {float(err.max())} (scale {scale})")
            if pad:
                check(bool(torch.all(got[d - pad:] == 0.0)),
                      f"{what}: padding not 0")
            if n_seg > 1:
                model = ota_transmit_split_model(grads, h, n_seg=n_seg,
                                                 **kw)
                again = ota_transmit_slab(grads, h, **kw)
                torch.cuda.synchronize()
                check(torch.equal(got, model), f"{what}: differs from its "
                      f"summation order by {float((got - model).abs().max())}")
                check(torch.equal(got, again), f"{what}: differs run to run")
                splits += 1
            worst, cases = max(worst, float(err.max())), cases + 1
            if kw.get("acc") is not None:
                seen.append(f"{n}x{d} rc={kw['row_chunk']}: S={n_seg}")
    # The kernel's two ways of reading G give the same bits: the
    # bulk-copy ring (16-byte aligned G) and plain loads (the same rows
    # 4 bytes off a 16-byte boundary).
    grads, h = _million_rows(torch, dev)
    off = torch.empty(grads.numel() + 1, device=dev)[1:].view(grads.shape)
    off.copy_(grads)
    acc = torch.randn(D_MILLION, generator=gen, device=dev)
    for a in (None, acc):
        check(torch.equal(ota_transmit_slab(grads, h, acc=a),
                          ota_transmit_slab(off, h, acc=a)),
              "the transmit kernel's load paths disagree")
    del off
    # One chunk and no carry: bitwise the channel kernel's faded sum
    # (u = 0, e = 1 synthesize no interference), at the streamed runs'
    # width (the column tiles fill the card) and at the million-client
    # chunk (they do not: the no-carry call takes one segment anyway).
    bitwise = []
    for n, d in ((N_CLIENTS, D_MAIN), (CHUNK_MILLION, D_MILLION),
                 (1, D_MILLION)):
        if n == CHUNK_MILLION:
            grads, h = _million_rows(torch, dev)
        else:
            grads = torch.randn(n, d, generator=gen, device=dev)
            h = 0.5 + torch.rand(n, generator=gen, device=dev)
        chan = ota_channel_slab(grads, h, torch.zeros(d, device=dev),
                                torch.ones(d, device=dev), alpha=1.5,
                                scale=0.0)
        kws = [dict(), dict(row_chunk=n)]
        if row_split(n, d, None, True, sms) == 1:
            kws.append(dict(acc=torch.zeros(d, device=dev)))
        for kw in kws:
            check(torch.equal(ota_transmit_slab(grads, h, **kw), chan),
                  f"one-chunk stream transmit {n}x{d} {sorted(kw)} differs "
                  f"from the channel kernel")
        bitwise.append(f"{n}x{d} ({len(kws)} calls)")
    print(f"[kernel ota_transmit_slab stream] {cases} cases (50x{D_MAIN} and "
          f"37x4097 random rows (the scalar path), {CHUNK_MILLION}x"
          f"{D_MILLION} the million-"
          f"client path's gradient rows; no carry and no row_chunk (the f32 "
          f"transmit), then row_chunk None/1/7/N (and 64, 1999 at the "
          f"million chunk) x carry absent/random, n_total = N + 3; then "
          f"with a carry 2001x4100 (a 4-column last tile, a ragged last "
          f"segment) "
          f"row_chunk None/64 and 5x{D_MILLION}, fewer rows than the grid "
          f"would like): max_abs_err={worst:.3e} (tol 1e-6 rel + 1e-6 of "
          f"scale); padding exact; the {splits} split cases bitwise their "
          f"summation order (ota_transmit_split_model) and themselves run "
          f"to run; the bulk-copy ring and plain loads bitwise equal at "
          f"{CHUNK_MILLION}x{D_MILLION}; no carry bitwise the "
          f"channel kernel's faded sum at {', '.join(bitwise)}; ok")
    print(f"[kernel ota_transmit_slab stream] segments S on {sms} SMs, "
          f"the carry cases (no carry: S = 1): " + "; ".join(seen))
    return worst


def phase_reference_stream(torch, np):
    """Streamed logistic-regression rounds on the card against the same
    rounds on the CPU (plain versions), same draws."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import FLConfig, make_slab_round_step
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.models.vision import logistic_regression

    n = 10
    rng = np.random.default_rng(3)
    model = logistic_regression(16, 4)
    params = {"w": torch.from_numpy(
        0.1 * rng.normal(size=(16, 4)).astype(np.float32)),
        "b": torch.zeros(4)}
    cases = {
        "serial chunk 5": dict(client_chunk=5),
        "double-buffered chunk 5": dict(client_chunk=5, double_buffer=True),
        "ragged chunk 4": dict(client_chunk=4),
        "weighted sampled chunk 4": dict(
            client_chunk=4, sample_rate=0.5,
            client_weights=tuple(float(i + 1) for i in range(n))),
    }
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha="auto")
    batches = [{"x": rng.normal(size=(n, 3, 16)).astype(np.float32),
                "y": rng.integers(0, 4, (n, 3)).astype(np.int64)}
               for _ in range(3)]
    worst = {}
    for name, kw in cases.items():
        fl = FLConfig(n_clients=n, **kw)
        states = {d: init_train_state(ad, params, device=d)
                  for d in ("cpu", "cuda")}
        steps = {d: make_slab_round_step(model.loss_fn, ch, ad, fl, device=d)
                 for d in states}
        draws = TorchDraws(ch, states["cpu"].spec, n, seed=6, device="cpu",
                           sample_rate=fl.sample_rate)
        for t in range(3):
            for d in states:
                states[d], _ = steps[d](states[d], draws(t), batches[t])
        err = 0.0
        for a, b in ((states["cuda"].w, states["cpu"].w),
                     (states["cuda"].alpha_hat, states["cpu"].alpha_hat),
                     *zip(states["cuda"].opt, states["cpu"].opt)):
            a = a.cpu()
            check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)),
                  f"{name}: card vs CPU differ by {float((a - b).abs().max())}")
            err = max(err, float((a - b).abs().max()))
        worst[name] = err
    print("[reference] streamed rounds on the card vs on the CPU (plain "
          "versions), same draws, logreg 10 clients, alpha auto, 3 rounds: "
          + ", ".join(f"{k} max|d(w, opt, alpha_hat)|={v:.3e}"
                      for k, v in worst.items()) + " (tier 1e-5); ok")


def phase_stream_equals_resident(torch, np, dev):
    """chunk = N, full participation, no weights: the streamed round's
    state is bitwise the resident round's, on the same draws."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import FLConfig, make_slab_round_step
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    batcher = FederatedBatcher(synthetic_images(3000, 32, 3, 10, seed=0),
                               N_CLIENTS, BATCH, seed=3)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in batcher(t).items()} for t in range(3)]
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01)
    runs = (("resident", FLConfig(n_clients=N_CLIENTS)),
            ("resident again", FLConfig(n_clients=N_CLIENTS)),
            ("streamed", FLConfig(n_clients=N_CLIENTS,
                                  client_chunk=N_CLIENTS)))
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = {}
        for name, fl in runs:
            state = init_train_state(ad, model.init(seed=0, device=dev),
                                     device=dev)
            step = make_slab_round_step(model.loss_fn, ch, ad, fl, device=dev)
            draws = TorchDraws(ch, state.spec, N_CLIENTS, seed=3, device=dev)
            for t in range(3):
                state, _ = step(state, draws(t), batches[t])
            states[name] = state
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prev

    def same(a, b):
        return (torch.equal(a.w, b.w) and torch.equal(a.alpha_hat, b.alpha_hat)
                and all(torch.equal(x, y) for x, y in zip(a.opt, b.opt)))

    check(same(states["resident"], states["resident again"]),
          "the resident round is not deterministic run to run")
    diff = float((states["streamed"].w - states["resident"].w).abs().max())
    check(same(states["streamed"], states["resident"]),
          f"streamed (chunk = N) differs from resident: max|dw| {diff}")
    print(f"[stream == resident] resnet_tiny full width, {N_CLIENTS} clients,"
          f" chunk {N_CLIENTS}, adam_ota, 3 rounds, cudnn deterministic: w, "
          f"opt and alpha_hat bitwise equal to the resident round's (and the "
          f"resident round to itself run to run); ok")


STREAM_RUNS = ("S1", "S2", "S3")
STREAM = "ota_transmit_slab(acc=)"     # the accumulating kernel's counter


def phase_streamed_runs(torch, np, dev, counters):
    """S1-S3 on ResNet-tiny at full width; every counter set to 0 just
    before each run and read just after. Then a dead round on S3's
    state under sync_debug_mode("error")."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import RoundDraws, TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     make_slab_round_step, run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    # 10,000 images: with 3,000, Dir(0.1) over 200 clients leaves some
    # client without an example
    data = synthetic_images(10000, 32, 3, 10, seed=0)
    # --client-weights datasize: a client's weight is its shard's size
    weights = tuple(float(len(p)) for p in
                    FederatedBatcher(data, N_STREAM, BATCH, seed=2).parts)
    f32_up = OTAChannelConfig()
    int8_up = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                                   error_feedback=True),
                               downlink="int8")
    configs = {
        "S1": (dict(client_chunk=50), f32_up,
               {STREAM: 4, "ota_channel_slab": 1, "adaptive_update_slab": 1}),
        "S2": (dict(client_chunk=50, double_buffer=True), f32_up,
               {"ota_channel_slab": 1, "adaptive_update_slab": 1}),
        "S3": (dict(client_chunk=64), int8_up,
               {STREAM: 4, "ota_transmit_slab": 1, "ota_receive_slab": 1,
                "adaptive_update_slab": 1}),
    }
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01, alpha="auto")
    totals = {c.__name__: 0 for c in counters}
    for name in STREAM_RUNS:
        flkw, ch, per_round = configs[name]
        fl = FLConfig(n_clients=N_STREAM, sample_rate=SAMPLE_RATE,
                      client_weights=weights, **flkw)
        ef = ch.uplink.error_feedback
        state = init_train_state(ad, model.init(seed=0, device=dev),
                                 error_feedback=ef, device=dev)
        run = make_slab_round_runner(model.loss_fn, ch, ad, fl, device=dev)
        draws = TorchDraws(ch, state.spec, N_STREAM, seed=1, device=dev,
                           sample_rate=SAMPLE_RATE)
        batcher = FederatedBatcher(data, N_STREAM, BATCH, seed=2)
        # one warm-up round outside the counted run
        run_rounds_slab(run, state, lambda t: draws(1000 + t), batcher, 1)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        state, hist = run_rounds_slab(run, state, draws, batcher,
                                      STREAM_ROUNDS, chunk=STREAM_ROUNDS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / STREAM_ROUNDS
        counts = {c.__name__: c.launches for c in counters}
        want = {k: STREAM_ROUNDS * per_round.get(k, 0) for k in counts}
        check(counts == want, f"{name}: launches {counts}, want {want}")
        for k, v in counts.items():
            totals[k] += v
        losses = [x["loss"] for x in hist]
        parts = [int(x["n_participants"]) for x in hist]
        check(all(math.isfinite(x) for x in losses), f"{name}: losses "
              f"{losses}")
        check(all(0 < p < N_STREAM for p in parts), f"{name}: participants "
              f"{parts}")
        check(bool(torch.isfinite(state.w).all()), f"{name}: w not finite")
        a_hat = float(state.alpha_hat)
        check(abs(a_hat - ch.alpha) <= 0.1, f"{name}: alpha_hat {a_hat}")
        print(f"[streamed] {name}: resnet_tiny full width, {N_STREAM} clients"
              f" x batch {BATCH}, chunk {fl.client_chunk}"
              f"{' double-buffered' if fl.double_buffer else ' serial'}, "
              f"uplink {ch.uplink.mode}{' + EF' if ef else ''} / downlink "
              f"{ch.downlink}, sample_rate {SAMPLE_RATE}, data-size weights, "
              f"adam_ota alpha auto, {STREAM_ROUNDS} rounds: losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; n_participants {parts}; alpha_hat {a_hat:.4f}; "
              f"{ms:.2f} ms/round (host clock, synchronized); launches "
              f"{counts}; ok")
    # A dead round on S3's state: an all-zero mask through the draws.
    step = make_slab_round_step(model.loss_fn, ch, ad, fl, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in batcher(99).items()}
    dead = RoundDraws(**{**draws(99).__dict__,
                         "mask": torch.zeros(N_STREAM, device=dev)})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, m = step(state, dead, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(torch.equal(new.w, state.w) and torch.equal(new.ef, state.ef)
          and torch.equal(new.alpha_hat, state.alpha_hat)
          and all(torch.equal(a, b) for a, b in zip(new.opt, state.opt)),
          "dead round moved the state")
    check(int(new.step) == int(state.step) + 1, "dead round: step")
    check(float(m.n_participants) == 0.0 and math.isfinite(float(m.loss)),
          f"dead round metrics {float(m.n_participants)} {float(m.loss)}")
    print(f"[dead round] S3's state (int8 + EF, alpha auto), an all-zero "
          f"mask, under sync_debug_mode='error': w, opt, alpha_hat and ef "
          f"bitwise unchanged, step {int(state.step)} -> {int(new.step)}, "
          f"n_participants 0, loss {float(m.loss)}; ok")
    return totals


def phase_million(torch, dev, counters):
    """The million-client stream, serial and double-buffered; every
    counter set to 0 before each run and read after. One more serial
    round under sync_debug_mode("error")."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     make_slab_round_step, run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state

    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.02, alpha=1.5)
    w0 = {"w": torch.randn(D_MILLION,
                           generator=torch.Generator().manual_seed(0))}
    rounds = 2
    chunks = N_MILLION // CHUNK_MILLION
    resident_bytes = 4 * N_MILLION * D_MILLION
    totals = {c.__name__: 0 for c in counters}
    out = {}
    for name, dbuf in (("serial", False), ("double-buffered", True)):
        fl = FLConfig(n_clients=N_MILLION, client_chunk=CHUNK_MILLION,
                      double_buffer=dbuf)
        state = init_train_state(ad, w0, device=dev)
        run = make_slab_round_runner(_quad_loss, ch, ad, fl, device=dev,
                                     batch_gen=_phase_batch)
        draws = TorchDraws(ch, state.spec, N_MILLION, seed=2, device=dev)
        # warm-up outside the counted run: the same chunk shapes over two
        # chunks of clients
        small = FLConfig(n_clients=2 * CHUNK_MILLION,
                         client_chunk=CHUNK_MILLION, double_buffer=dbuf)
        warm = make_slab_round_runner(_quad_loss, ch, ad, small, device=dev,
                                      batch_gen=_phase_batch)
        run_rounds_slab(warm, state, TorchDraws(ch, state.spec,
                                                2 * CHUNK_MILLION,
                                                device=dev),
                        lambda t: None, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        state, hist = run_rounds_slab(run, state, draws, lambda t: None,
                                      rounds, chunk=rounds)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / rounds
        peak = torch.cuda.max_memory_allocated(dev)
        counts = {c.__name__: c.launches for c in counters}
        want = {k: 0 for k in counts}
        want.update({"ota_channel_slab": rounds,
                     "adaptive_update_slab": rounds,
                     STREAM: 0 if dbuf else rounds * chunks})
        check(counts == want, f"million {name}: launches {counts}, want "
              f"{want}")
        for k, v in counts.items():
            totals[k] += v
        losses = [x["loss"] for x in hist]
        check(all(math.isfinite(x) for x in losses), f"million {name}: "
              f"losses {losses}")
        check(bool(torch.isfinite(state.w).all()) and int(state.step) ==
              rounds, f"million {name}: state")
        check(all(x["n_participants"] == N_MILLION for x in hist),
              f"million {name}: participants")
        out[name] = state
        print(f"[million] {name}: {N_MILLION} clients, d={D_MILLION}, chunk "
              f"{CHUNK_MILLION} ({chunks} chunks a round), adam_ota lr 0.02 "
              f"alpha 1.5 xi_scale 0.1, {rounds} rounds: losses "
              + " ".join(f"{x:.6f}" for x in losses)
              + f"; {1e3 * sec:.1f} ms/round, {N_MILLION / sec:.0f} clients/s "
              f"(host clock, synchronized); peak memory allocated "
              f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB above the "
              f"state) vs {resident_bytes / 1e9:.1f} GB for a resident "
              f"({N_MILLION}, {D_MILLION}) f32 stack; launches {counts}; ok")
    dw = float((out["serial"].w - out["double-buffered"].w).abs().max())
    check(dw <= 1e-5, f"million: serial vs double-buffered max|dw| {dw}")
    # one more serial round with host syncs made errors
    fl = FLConfig(n_clients=N_MILLION, client_chunk=CHUNK_MILLION)
    step = make_slab_round_step(_quad_loss, ch, ad, fl, device=dev,
                                batch_gen=_phase_batch)
    state = out["serial"]
    d = TorchDraws(ch, state.spec, N_MILLION, seed=2, device=dev)(rounds)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, d, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(math.isfinite(float(m.loss)) and int(state.step) == rounds + 1,
          "million: sync-checked round")
    print(f"[million] serial vs double-buffered after {rounds} rounds: "
          f"max|dw|={dw:.3e} (tier 1e-5: the fold reassociates each chunk's "
          f"sum); one more serial round ({chunks} chunks, the finish, the "
          f"update) under sync_debug_mode='error' with no host sync; ok")
    # one more round of the same step, on its own under torch.profiler:
    # the card time of its transmits (they hide under the host clock)
    from repro_torch.kernels.ota_channel import ota_transmit_slab
    d = TorchDraws(ch, state.spec, N_MILLION, seed=2, device=dev)(rounds + 1)
    ota_transmit_slab.stream_launches = 0
    wall_ms, dev_ev = _profile_run(torch, lambda: step(state, d, None))
    tx = [a for a in dev_ev if "ota_transmit_stream" in a.key]
    tx_n = sum(a.count for a in tx)
    check(ota_transmit_slab.stream_launches == chunks and tx_n == chunks,
          f"million profiled round: {ota_transmit_slab.stream_launches} "
          f"transmit launches counted, {tx_n} seen by the profiler, want "
          f"{chunks}")
    busy_ms = sum(a.self_device_time_total for a in dev_ev) / 1e3
    tx_ms = sum(a.self_device_time_total for a in tx) / 1e3
    check(tx_ms > 0, "million profiled round: no transmit card time")
    print(f"[million] one more serial round ({chunks} chunks) under "
          f"torch.profiler: host clock {wall_ms:.1f} ms (under the "
          f"profiler), card busy {busy_ms:.2f} ms; the accumulating "
          f"transmit {tx_ms:.3f} ms of card time over {tx_n} launches "
          f"({1e3 * tx_ms / tx_n:.2f} us each, {tx_ms / busy_ms:.1%} of "
          f"busy); ok")
    return totals


ROUND_API_OPTIMIZERS = ("adagrad_ota", "adam_ota", "amsgrad_ota",
                        "yogi_ota", "fedavgm", "fedavg")
CKPT_ROUNDS, CKPT_AT = 6, 3


def _state_bitwise(torch, a, b) -> bool:
    """Two SlabTrainStates hold the same bits in every slot."""
    same_ef = (a.ef is None and b.ef is None) or (
        a.ef is not None and b.ef is not None and torch.equal(a.ef, b.ef))
    return (torch.equal(a.step, b.step) and torch.equal(a.w, b.w)
            and len(a.opt) == len(b.opt)
            and all(torch.equal(x, y) for x, y in zip(a.opt, b.opt))
            and torch.equal(a.alpha_hat, b.alpha_hat) and same_ef)


def phase_round_api(torch, np, dev, counters):
    """The per-round pytree API (init_server + make_round_step +
    run_rounds) at full width: each optimizer on the f32 uplink, then
    adam_ota on the int8 uplink, 5 rounds each, beside the resident
    runner (make_slab_round_runner + run_rounds_slab) on the same draws
    and batches; every counter set to 0 before each run and read after.
    Both start from the same slab (the per-round API from its pytrees,
    an exact f32 round trip) and launch the same kernels on the same
    inputs, so their final states must agree bitwise. Then the
    quickstart twin on the card. Returns the launches of all the
    counted runs."""
    import importlib.util

    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, init_server, make_round_step,
                                     make_slab_round_runner, run_rounds,
                                     run_rounds_slab)
    from repro_torch.core.slab_state import (init_train_state,
                                             pack_train_state,
                                             unpack_train_state)
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    batcher = FederatedBatcher(synthetic_images(3000, 32, 3, 10, seed=0),
                               N_CLIENTS, BATCH, seed=4)
    # keyed by the absolute round, as both loops take them
    batches = [batcher(t) for t in range(ROUNDS)]
    fl = FLConfig(n_clients=N_CLIENTS)
    f32 = OTAChannelConfig()
    int8 = OTAChannelConfig(uplink=UplinkConfig(mode="int8"))
    runs = [(opt, "f32", f32) for opt in ROUND_API_OPTIMIZERS]
    runs.append(("adam_ota", "int8", int8))
    kernels = {"f32": {"ota_channel_slab", "adaptive_update_slab"},
               "int8": {"ota_transmit_slab", "ota_receive_slab",
                        "adaptive_update_slab"}}
    totals = {c.__name__: 0 for c in counters}

    def counted(fn, wire, what):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / ROUNDS
        counts = {c.__name__: c.launches for c in counters}
        want = {k: ROUNDS if k in kernels[wire] else 0 for k in counts}
        check(counts == want, f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            totals[k] += v
        return out, ms

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for opt, wire, ch in runs:
            what = f"round API {opt} {wire}"
            ad = AdaptiveConfig(optimizer=opt, lr=0.01)
            state0 = init_train_state(ad, model.init(seed=0, device=dev),
                                      device=dev)
            draws = TorchDraws(ch, state0.spec, N_CLIENTS, seed=5,
                               device=dev)
            step = make_round_step(model.loss_fn, ch, ad, fl, device=dev)
            runner = make_slab_round_runner(model.loss_fn, ch, ad, fl,
                                            device=dev)
            params, _ = unpack_train_state(ad, state0)
            opt_state = init_server(params, ad)
            # one warm-up round of each outside the counted runs
            run_rounds(step, params, opt_state, lambda t: draws(1000 + t),
                       batches.__getitem__, 1)
            run_rounds_slab(runner, state0, lambda t: draws(1000 + t),
                            batches.__getitem__, 1)
            torch.cuda.synchronize()
            (params, opt_state, hist), ms_api = counted(
                lambda: run_rounds(step, params, opt_state, draws,
                                   batches.__getitem__, ROUNDS), wire, what)
            (state, rhist), ms_res = counted(
                lambda: run_rounds_slab(runner, state0, draws,
                                        batches.__getitem__, ROUNDS,
                                        chunk=ROUNDS), wire,
                f"resident {opt} {wire}")
            packed = pack_train_state(ad, state.spec, params, opt_state)
            check(_state_bitwise(torch, packed, state),
                  f"{what}: the final state differs from the resident "
                  f"runner's: max|dw| "
                  f"{float((packed.w - state.w).abs().max())}")
            check(hist == rhist, f"{what}: history differs from the "
                  f"resident runner's")
            losses = [h["loss"] for h in hist]
            check(all(math.isfinite(x) for x in losses),
                  f"{what}: losses {losses}")
            print(f"[round API] resnet_tiny full width, {N_CLIENTS} clients "
                  f"x batch {BATCH}, {opt}, {wire} uplink, {ROUNDS} rounds: "
                  "losses " + " ".join(f"{x:.4f}" for x in losses)
                  + f"; {ms_api:.2f} ms/round (per-round API) vs "
                  f"{ms_res:.2f} (resident runner), host clock, "
                  f"synchronized; one launch a round of each of "
                  f"{sorted(kernels[wire])}; params, optimizer state and "
                  "history bitwise the resident runner's; ok")
    finally:
        torch.backends.cudnn.deterministic = prev

    path = ROOT / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    accs = {}
    for opt, lr in (("adam_ota", 0.05), ("fedavgm", 0.01)):
        acc, hist = quickstart.train(opt, lr, device=dev, log_every=0)
        check(len(hist) == 60 and all(math.isfinite(h["loss"])
                                      for h in hist),
              f"quickstart {opt}: losses not finite")
        accs[opt] = acc
    print(f"[round API] quickstart twin on the card (logistic regression, "
          f"20 clients, xi_scale 0.5, 60 rounds): adam_ota acc "
          f"{accs['adam_ota']:.4f}, fedavgm acc {accs['fedavgm']:.4f}; "
          "losses finite; ok")
    return totals


def phase_checkpoint(torch, np, dev, counters):
    """Checkpoint and resume on the card: ResNet-tiny at full width,
    adam_ota, int8 uplink with error feedback, the int8 downlink and
    alpha="auto" (every slot of the state: two optimizer slabs, ef,
    alpha_hat). 6 rounds with chunk_hook writing an async checkpoint at
    round 3 (and a blocking one beside it), then the file loaded back
    onto the card and the run resumed at start_round=3: bitwise the
    uninterrupted run, and the async file's bytes the blocking file's.
    Every counter set to 0 before each run and read after. Returns the
    launches of both runs."""
    import hashlib
    import tempfile

    from repro_torch.checkpoint import (latest_round, load_slab_state,
                                        save_slab_state,
                                        wait_for_async_saves)
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    batcher = FederatedBatcher(synthetic_images(3000, 32, 3, 10, seed=0),
                               N_CLIENTS, BATCH, seed=6)
    batches = [batcher(t) for t in range(CKPT_ROUNDS)]
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                              error_feedback=True),
                          downlink="int8")
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01, alpha="auto")
    runner = make_slab_round_runner(model.loss_fn, ch, ad,
                                    FLConfig(n_clients=N_CLIENTS), device=dev)
    state0 = init_train_state(ad, model.init(seed=0, device=dev),
                              error_feedback=True, device=dev)
    draws = TorchDraws(ch, state0.spec, N_CLIENTS, seed=6, device=dev)
    want_kernels = {"ota_transmit_slab", "ota_receive_slab",
                    "adaptive_update_slab"}
    totals = {c.__name__: 0 for c in counters}

    def counted(fn, rounds, what):
        for c in counters:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {c.__name__: c.launches for c in counters}
        want = {k: rounds if k in want_kernels else 0 for k in counts}
        check(counts == want, f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            totals[k] += v
        return out

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        run_rounds_slab(runner, state0, lambda t: draws(1000 + t),
                        batches.__getitem__, 1)     # warm-up, not counted
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            saved = {}

            def hook(t, state, history):
                if t != CKPT_AT:
                    return
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                save_slab_state(f"{tmp}/round_{t}.npz", state,
                                blocking=False)
                saved["async_ms"] = 1e3 * (time.perf_counter() - t0)
                t0 = time.perf_counter()
                save_slab_state(f"{tmp}/blocking_{t}.npz", state)
                saved["blocking_ms"] = 1e3 * (time.perf_counter() - t0)

            full, hist = counted(
                lambda: run_rounds_slab(runner, state0, draws,
                                        batches.__getitem__, CKPT_ROUNDS,
                                        chunk=CKPT_ROUNDS, align=(CKPT_AT,),
                                        chunk_hook=hook),
                CKPT_ROUNDS, "checkpoint: uninterrupted run")
            wait_for_async_saves()
            path = latest_round(tmp)
            check(path == f"{tmp}/round_{CKPT_AT}.npz",
                  f"latest_round {path}")
            digests = [hashlib.sha256(Path(p).read_bytes()).hexdigest()
                       for p in (path, f"{tmp}/blocking_{CKPT_AT}.npz")]
            check(digests[0] == digests[1],
                  "the async checkpoint's bytes differ from the blocking's")
            size = Path(path).stat().st_size
            loaded, _ = load_slab_state(path, state0.spec, device=dev)
            check(int(loaded.step) == CKPT_AT and loaded.ef is not None
                  and len(loaded.opt) == 2 and float(loaded.alpha_hat) > 0
                  and loaded.w.device == dev,
                  f"loaded state: step {int(loaded.step)}")
            resumed, rhist = counted(
                lambda: run_rounds_slab(runner, loaded, draws,
                                        batches.__getitem__, CKPT_ROUNDS,
                                        start_round=CKPT_AT),
                CKPT_ROUNDS - CKPT_AT, "checkpoint: resumed run")
    finally:
        torch.backends.cudnn.deterministic = prev
    check(_state_bitwise(torch, resumed, full),
          f"the resumed run differs from the uninterrupted one: max|dw| "
          f"{float((resumed.w - full.w).abs().max())}")
    check(rhist == hist[CKPT_AT:], "the resumed history differs")
    print(f"[checkpoint] resnet_tiny full width, {N_CLIENTS} clients, "
          f"adam_ota, int8 + EF + int8 downlink, alpha=\"auto\": "
          f"{CKPT_ROUNDS} rounds with an async save at round {CKPT_AT} "
          f"({size} bytes; {saved['async_ms']:.2f} ms host time for the "
          f"async call, {saved['blocking_ms']:.2f} ms for a blocking save), "
          f"loaded onto the card and resumed for "
          f"{CKPT_ROUNDS - CKPT_AT} rounds: w, opt, ef, alpha_hat "
          f"({float(full.alpha_hat):.4f}) and history bitwise the "
          "uninterrupted run's; the async file's bytes the blocking "
          "file's; ok")
    return totals


def _flash_inputs(torch, dev, case, dtype, seed):
    b, sq, sk, h, kh, d = case[:6]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]


def _flash_tier(torch, variant, want, q, k, v, causal, window):
    """The per-element tolerance a variant's output is held to against the
    plain version (kernels.flash_attention.flash_tolerance), and its
    formula for the log."""
    from repro_torch.kernels.flash_attention import flash_tolerance
    from repro_torch.kernels.ref import flash_attention_ref

    if variant == "hopper":
        ref_abs_v = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                        causal=causal, window=window)
        return (flash_tolerance(variant, want, ref_abs_v),
                "2^-7 |ref| + 2^-8 attn(q, k, |v|) + 2e-5")
    return (flash_tolerance(variant, want),
            "2e-5" if want.dtype == torch.float32 else "2^-7 |ref| + 2e-5")


def phase_kernel_flash(torch, dev):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_variant)
    from repro_torch.kernels.ref import flash_attention_ref

    # the six FLASH_CASES, the two model shapes and the rows without keys,
    # each in f32 and bf16, through the variant the wrapper picks
    labels = ([f"FLASH_CASES[{i}]" for i in range(len(FLASH_CASES))]
              + [f"{a} prefill shape" for a in FLASH_MODEL_SHAPES]
              + ["rows without keys"] * len(FLASH_KEYLESS))
    shapes = FLASH_CASES + list(FLASH_MODEL_SHAPES.values()) + FLASH_KEYLESS
    cases = [(lab, c, dt) for lab, c in zip(labels, shapes)
             for dt in (torch.float32, torch.bfloat16)]
    worst = {"hopper": (0.0, 0.0), "scalar": (0.0, 0.0)}
    for i, (label, case, dtype) in enumerate(cases):
        causal, window = case[6:]
        what = f"flash_attention {label} {case} {str(dtype)[6:]}"
        q, k, v = _flash_inputs(torch, dev, case, dtype, 100 + i)
        n0 = flash_attention.hopper_launches
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        variant = "hopper" if flash_attention.hopper_launches > n0 else \
            "scalar"
        chosen = flash_variant(dtype, case[5], case[1],
                               (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                got.data_ptr()))
        check(variant == chosen, f"{what}: launched {variant}, "
              f"flash_variant says {chosen}")
        check(got.dtype == dtype and got.shape == q.shape,
              f"{what}: {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{what}: not finite")
        diff = (got.float() - want.float()).abs()
        tol, tier = _flash_tier(torch, variant, want, q, k, v, causal,
                                window)
        err, share = float(diff.max()), float((diff / tol).max())
        check(share <= 1.0, f"{what} ({variant}): max err {err}, "
              f"{share:.3f} of the per-element tier {tier}")
        worst[variant] = (max(worst[variant][0], err),
                          max(worst[variant][1], share))
        print(f"[kernel flash_attention] {label} {case} {str(dtype)[6:]}: "
              f"{variant}, max_abs_err={err:.3e}, worst element "
              f"{share:.3f} of its tier ({tier}); ok")
        del q, k, v, got, want, diff, tol
    torch.cuda.empty_cache()
    print(f"[kernel flash_attention] {len(cases)} cases (6 FLASH_CASES, 2 "
          f"model shapes and {len(FLASH_KEYLESS)} with rows without keys, "
          "each f32 and bf16): "
          + "; ".join(f"{v}: max_abs_err {e:.3e}, worst element {sh:.3f} of "
                      "its tier" for v, (e, sh) in worst.items()) + "; ok")
    return {v: e for v, (e, _) in worst.items()}


def _serve_run(torch, model, params, dev, batch, prompt, gen, counter,
               hopper):
    """One greedy serve shape through the CLI's generate: a cold run (the
    shape's first), then the timed warm run, each with the flash counters
    (both variants', ``counter``, and the Hopper variant's, ``hopper``)
    set to 0 just before and read just after; then one more decode step
    with the counter at 0, and a prefill and a decode step under the
    profiler. Returns the warm run's numbers and the cold prefill."""
    from repro_torch.launch.serve import generate

    cfg = model.config
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    runs, counts = [], []
    for _ in ("cold", "warm"):
        counter.launches = hopper.launches = 0
        runs.append(generate(model, params, tokens, gen))
        counts.append(counter.launches)
        check(counts[-1] == cfg.n_layers == hopper.launches,
              f"{cfg.arch} {batch}x{prompt}: {counter.launches} flash "
              f"launches, {hopper.launches} of the Hopper variant, want "
              f"{cfg.n_layers} of it (one a layer in the prefill, none in "
              "decode)")
    cold, r = runs
    check(torch.equal(cold["ids"], r["ids"]),
          f"{cfg.arch} {batch}x{prompt}: the warm run's ids differ")
    counter.launches = 0
    logits, cache = model.decode_step(params, r["cache"], r["ids"][:, -1:],
                                      prompt + gen - 1)
    torch.cuda.synchronize()
    check(counter.launches == 0, f"{cfg.arch}: decode launched flash "
          f"{counter.launches} times")
    check(bool(torch.isfinite(r["prefill_logits"]).all())
          and bool(torch.isfinite(logits).all()),
          f"{cfg.arch} {batch}x{prompt}: logits not finite")
    check(tuple(r["ids"].shape) == (batch, gen)
          and int(r["ids"].min()) >= 0 and int(r["ids"].max()) < cfg.vocab,
          f"{cfg.arch}: ids {tuple(r['ids'].shape)}")
    pos = cache["layers"]["kv"]["pos"][0]
    total = prompt + gen
    if cfg.window and total > cfg.window:
        # the ring holds exactly the last `window` positions
        check(sorted(pos.tolist()) == list(range(total - cfg.window, total)),
              f"{cfg.arch}: ring positions")
    ms_tok = 1e3 * r["t_decode"] / max(gen - 1, 1)
    # where the time goes: one more prefill and one decode step under the
    # profiler (not counted above), each with its own host clock
    batch_in = {"tokens": tokens}
    length = cache["layers"]["kv"]["k"].shape[2]
    _profile(torch, f"{cfg.arch} {batch}x{prompt} prefill",
             lambda: model.prefill(params, batch_in, length=length))
    _profile(torch, f"{cfg.arch} {batch}x{prompt} decode step",
             lambda: model.decode_step(params, cache, r["ids"][:, -1:],
                                       prompt + gen - 1))
    return dict(prefill_ms=1e3 * r["t_prefill"], decode_ms_per_token=ms_tok,
                tokens_per_s=batch * (gen - 1) / r["t_decode"],
                prefill_tokens_per_s=batch * prompt / r["t_prefill"],
                cold_prefill_ms=1e3 * cold["t_prefill"],
                cold_decode_ms_per_token=1e3 * cold["t_decode"]
                / max(gen - 1, 1),
                launches=counts[-1], hopper_launches=counts[-1],
                ids=r["ids"][0, :8].tolist())


def _profile_run(torch, fn):
    """Run fn once under torch.profiler: its host-clock ms and the
    profiler's CUDA events (key_averages)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return wall_ms, [a for a in prof.key_averages()
                     if a.device_type == DeviceType.CUDA]


def _profile(torch, what, fn):
    """Run fn once under torch.profiler; print the host-clock time, the
    card's kernel time (sum over CUDA events: one stream, no overlap),
    hence the card's busy and idle shares, the kernel count and the
    flash kernel's share. Measures; checks nothing."""
    wall_ms, dev_ev = _profile_run(torch, fn)
    busy_ms = sum(a.self_device_time_total for a in dev_ev) / 1e3
    if busy_ms <= 0:
        print(f"[profile] {what}: host clock {wall_ms:.2f} ms; card time "
              "not measured (the profiler saw no kernel)")
        return
    flash_ms = sum(a.self_device_time_total for a in dev_ev
                   if "flash_attention" in a.key) / 1e3
    top = sorted(dev_ev, key=lambda a: -a.self_device_time_total)[:3]
    print(f"[profile] {what}: host clock {wall_ms:.2f} ms (under the "
          f"profiler), card busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%};"
          f" idle {1 - busy_ms / wall_ms:.1%}), "
          f"{sum(a.count for a in dev_ev)} kernels; {FLASH} "
          f"{flash_ms:.2f} ms ({flash_ms / busy_ms:.1%} of busy); top: "
          + "; ".join(f"{a.key[:60]} {a.self_device_time_total / 1e3:.2f} ms"
                      f" x{a.count}" for a in top))


def phase_serve(torch, dev, counter, hopper, arch):
    """Serve one architecture at full width: random parameters on the
    card, then each of its SERVE_RUNS (``counter`` counts both flash
    variants' launches, ``hopper`` the Hopper variant's)."""
    import gc

    from repro_torch.configs import preset_config
    from repro_torch.core.slab import tree_flatten
    from repro_torch.models.model import build_model

    cfg = preset_config(arch, SERVE_PRESET)
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    print(f"[serve {arch}] preset {SERVE_PRESET}: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, window {cfg.window}: "
          f"{n_params / 1e9:.3f} B parameters ({cfg.param_dtype}) drawn on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    out = {}
    with torch.no_grad():
        for name, a, batch, prompt, gen in SERVE_RUNS:
            if a != arch:
                continue
            torch.cuda.reset_peak_memory_stats(dev)
            r = _serve_run(torch, model, params, dev, batch, prompt, gen,
                           counter, hopper)
            r["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            out[name] = r
            print(f"[serve {arch}] {name}: batch {batch} x prompt {prompt}, "
                  f"{gen} tokens greedy, warm run: prefill "
                  f"{r['prefill_ms']:.1f} ms ({r['prefill_tokens_per_s']:.0f}"
                  f" tokens/s), decode {r['decode_ms_per_token']:.2f} "
                  f"ms/token ({r['tokens_per_s']:.1f} tokens/s); cold run "
                  f"(the shape's first): prefill {r['cold_prefill_ms']:.1f} "
                  f"ms, decode {r['cold_decode_ms_per_token']:.2f} ms/token;"
                  f" peak memory {r['peak_gb']:.2f} GB; {FLASH} launches "
                  f"{r['launches']} in each run's prefill (= {cfg.n_layers} "
                  f"layers, all of the Hopper variant), 0 in decode; "
                  f"ids[0,:8] {r['ids']}, the same in both runs; logits "
                  "finite; ok")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_reference_serve(torch, dev):
    """The dense model at smoke width in f32 on the card against the same
    parameters on the CPU: prefill logits, caches and 8 greedy ids. The
    f32 serving path of the scalar flash kernel: its counters are set to 0
    just before and read just after; returns its launches."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.core.slab import tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model

    worst = 0.0
    layers = 0
    flash_attention.scalar_launches = flash_attention.hopper_launches = 0
    for arch, prompt in (("qwen3-14b", 48), ("starcoder2-15b", 80)):
        cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
        model = build_model(cfg)
        params = model.init(seed=0, device="cpu")
        tokens = torch.randint(0, cfg.vocab, (2, prompt),
                               generator=torch.Generator().manual_seed(1))
        cpu = generate(model, params, tokens, 8)
        card = generate(model, tree_map(lambda t: t.to(dev), params),
                        tokens.to(dev), 8)
        layers += cfg.n_layers
        pairs = [("prefill logits", card["prefill_logits"],
                  cpu["prefill_logits"])]
        pairs += [(f"cache {k}", card["cache"]["layers"]["kv"][k],
                   cpu["cache"]["layers"]["kv"][k]) for k in ("k", "v", "pos")]
        for what, a, b in pairs:
            a, b = a.cpu().float(), b.float()
            scale = max(float(b.abs().max()), 1.0)
            err = float((a - b).abs().max())
            check(err <= 1e-4 * scale, f"reference serve {arch} {what}: "
                  f"max err {err} > 1e-4 x {scale}")
            worst = max(worst, err / scale)
        check(torch.equal(card["ids"].cpu(), cpu["ids"]),
              f"reference serve {arch}: ids {card['ids'].tolist()} vs "
              f"{cpu['ids'].tolist()}")
    scalar = flash_attention.scalar_launches
    check(scalar == layers and flash_attention.hopper_launches == 0,
          f"reference serve: {scalar} scalar and "
          f"{flash_attention.hopper_launches} Hopper flash launches, want "
          f"{layers} scalar (one a layer in each f32 prefill)")
    print(f"[reference serve] qwen3-14b (prompt 48) and starcoder2-15b "
          f"(prompt 80 > window 64: the ring cache) smoke configs in f32, "
          f"card vs cpu: prefill logits and caches within {worst:.2e} of "
          f"scale (tol 1e-4), 8 greedy ids equal; {FLASH} launches {scalar},"
          f" all of the scalar variant (one a layer); ok")
    return scalar


def _median_ms(torch, fn, flush):
    """Median of per-launch CUDA-event times, each launch after an L2
    flush (the round finds its operands cold: ~40 MB of other traffic
    runs between two launches of one kernel). A 2 ms device sleep after
    the flush holds the card while the host enqueues the start event,
    the call and the end event, so the time is the card's and not the
    host's enqueue time (a wrapper's Python can outlast the flush)."""
    fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def _fold_cost(torch, dev, gen, flush, gs, hs, acc, n_seg):
    """Time a split call of the accumulating transmit beside the same
    kernel on as many blocks and about the same bytes without a split,
    two turns each: (n_y, d_y) has a column tile for each block of the
    split call, each block reading a segment's rows x 2 KB; its column
    tiles fill the card, so it takes S = 1 (no partials, no ticket, no
    fold). The difference is what the split costs."""
    from repro_torch.kernels.ota_channel import (TRANSMIT_TILE,
                                                 ota_transmit_slab, row_split,
                                                 segment_rows, sm_count)

    (n, d), blocks = gs.shape, -(-gs.shape[1] // TRANSMIT_TILE) * n_seg
    n_y, d_y = segment_rows(n, None, n_seg), blocks * TRANSMIT_TILE
    check(row_split(n_y, d_y, None, True, sm_count(dev.index)) == 1,
          f"the fold's yardstick {n_y}x{d_y} splits its rows")
    gy = torch.randn(n_y, d_y, generator=gen, device=dev)
    hy = torch.rand(n_y, generator=gen, device=dev)
    acc_y = torch.randn(d_y, generator=gen, device=dev)
    calls = [(f"{n}x{d}, S = {n_seg}, {4 * n * d / 1e6:.1f} MB",
              lambda: ota_transmit_slab(gs, hs, n_total=n, acc=acc)),
             (f"{n_y}x{d_y}, S = 1, {4 * n_y * d_y / 1e6:.1f} MB",
              lambda: ota_transmit_slab(gy, hy, n_total=n_y, acc=acc_y))]
    ms = _in_turns(torch, flush, [fn for _, fn in calls])
    fold, plain = (statistics.median(t) for t in ms)
    print(f"[times] {STREAM} {n}x{d} against the same kernel without a "
          f"fold ({blocks} blocks of {n_y} rows x 2 KB each), two turns: "
          + "; ".join(f"{what}: " + " ".join(f"{t:.4f}" for t in times)
                      + " ms" for (what, _), times in zip(calls, ms))
          + f"; the split costs {fold - plain:.4f} ms")


def _in_turns(torch, flush, fns, turns=2):
    """Each call's _median_ms, taken in turns: A B .. B A (the order
    reverses every turn); one list of times a call."""
    ms = [[] for _ in fns]
    for t in range(turns):
        order = list(range(len(fns)))
        for i in (order if t % 2 == 0 else order[::-1]):
            ms[i].append(_median_ms(torch, fns[i], flush))
    return ms


def phase_times(torch, dev):
    """Times of every kernel at its main-path shapes (see the module
    docstring, phase 19). Returns the rows by name and the launch floor:
    a near-empty launch (torch.cuda._sleep of one cycle) timed the same
    way, the least any kernel's time can read in this harness."""
    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.ota_channel import (channel_blocks,
                                                 ota_channel_slab,
                                                 ota_transmit_slab)
    from repro_torch.kernels.ref import adaptive_update_ref, ota_channel_ref

    flush = torch.empty(64 * 2 ** 20, device=dev)      # 256 MB > 50 MB L2
    gen = torch.Generator(device=dev).manual_seed(2)
    floor = _median_ms(torch, lambda: torch.cuda._sleep(1), flush)
    print(f"[times] launch floor: {floor:.4f} ms, the median of "
          f"{TIMED_LAUNCHES} near-empty launches (torch.cuda._sleep(1)) "
          "under the same flush and sleep")
    d, n = D_MAIN, N_CLIENTS
    kw = dict(lr=0.01, beta1=0.9, beta2=0.3, alpha=1.5, eps=1e-8, mode="adam")
    rows = {}
    # adam: reads g, delta, nu, w and writes delta, nu, w (f32); about 16
    # f32 operations an element, counting each powf as one. At the main
    # path's slab and at the million-client stream's.
    for d_u, name in ((D_MAIN, "adaptive_update_slab"),
                      (D_MILLION, f"adaptive_update_slab d={D_MILLION}")):
        g, w = (torch.randn(d_u, generator=gen, device=dev)
                for _ in range(2))
        delta = 0.1 * torch.randn(d_u, generator=gen, device=dev)
        nu = 0.01 * torch.rand(d_u, generator=gen, device=dev)
        rows[name] = (
            _median_ms(torch, lambda: adaptive_update_slab(g, delta, nu, w,
                                                           **kw), flush),
            _median_ms(torch, lambda: adaptive_update_ref(g, delta, nu, w,
                                                          **kw), flush),
            7 * 4 * d_u, 16 * d_u)
    # channel: reads G, h, u, e and writes out; 2 N d for the faded sum
    # and about 12 a column for the CMS transform. At 50 x 175,104 in
    # turns with the accumulating transmit's no-carry call (the same rows
    # through the same ring, no CMS), then with pilot statistics (the
    # wrapper's call: the kernel and the sum of its (blocks, 3) rows);
    # then the one-row streamed finishes.
    ckw = dict(alpha=1.5, scale=0.1)
    for n_c, d_c in ((n, d), (1, D_MAIN), (1, D_MILLION)):
        grads = torch.randn(n_c, d_c, generator=gen, device=dev)
        h = torch.rand(n_c, generator=gen, device=dev)
        u = torch.rand(d_c, generator=gen, device=dev) - 0.5
        e = torch.rand(d_c, generator=gen, device=dev) + 0.5
        name = ("ota_channel_slab" if n_c > 1 else
                f"ota_channel_slab {n_c}x{d_c}")
        if n_c > 1:
            b2, b3 = _in_turns(torch, flush, [
                lambda: ota_channel_slab(grads, h, u, e, **ckw),
                lambda: ota_transmit_slab(grads, h)])
            ms = statistics.median(b2)
            stats_ms = _median_ms(torch, lambda: ota_channel_slab(
                grads, h, u, e, pilot_stats=True, **ckw), flush)
            rows_ = torch.rand(channel_blocks(d_c), 3, generator=gen,
                               device=dev)
            sum_ms = _median_ms(torch, lambda: torch.sum(rows_, dim=0), flush)
            # the same two launches without the statistics epilogue: the
            # difference is what the epilogue costs inside the kernel
            pair_ms = _median_ms(torch, lambda: (
                ota_channel_slab(grads, h, u, e, **ckw),
                torch.sum(rows_, dim=0)), flush)
            print(f"[times] ota_channel_slab {n_c}x{d_c} and {STREAM}'s "
                  f"no-carry call, in turns: "
                  + " ".join(f"{t:.4f}" for t in b2) + " ms against "
                  + " ".join(f"{t:.4f}" for t in b3) + " ms: "
                  f"{1e3 * (ms - statistics.median(b3)):.2f} us over it; "
                  f"with pilot statistics {stats_ms:.4f} ms "
                  f"(+{1e3 * (stats_ms - ms):.2f} us): the kernel and the "
                  f"wrapper's sum of its {channel_blocks(d_c)} statistics "
                  f"rows, a launch of its own ({sum_ms:.4f} ms alone); the "
                  f"kernel without statistics and the same sum "
                  f"{pair_ms:.4f} ms, so the epilogue costs "
                  f"{1e3 * (stats_ms - pair_ms):.2f} us in the kernel")
        else:
            ms = _median_ms(torch, lambda: ota_channel_slab(
                grads, h, u, e, n_total=1, **ckw), flush)
        rows[name] = (
            ms, _median_ms(torch, lambda: ota_channel_ref(grads, h, u, e,
                                                          **ckw), flush),
            4 * (n_c * d_c + n_c + 3 * d_c), 2 * n_c * d_c + 12 * d_c)
    del grads
    d, n = D_MAIN, N_CLIENTS
    grads = torch.randn(n, d, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    u = torch.rand(d, generator=gen, device=dev) - 0.5
    e = torch.rand(d, generator=gen, device=dev) + 0.5
    # transmit, int8 SR + EF + residual: reads G, h, r, ef; writes q
    # (int8), s (one f32 per 128 columns) and the residual; 2 N d for the
    # faded sum and about 8 an entry for the epilogue.
    from repro_torch.kernels.ota_channel import (ota_receive_slab,
                                                 ota_transmit_slab,
                                                 pack_sign_slab, row_split,
                                                 sm_count)
    from repro_torch.kernels.ref import ota_receive_ref, ota_transmit_ref
    r = torch.rand(d, generator=gen, device=dev)
    ef = 0.01 * torch.randn(d, generator=gen, device=dev)
    tkw = dict(quantize=True, r=r, ef=ef, return_residual=True)
    bytes_t = 4 * n * d + 4 * n + 3 * 4 * d + d + 4 * (d // 128)
    ops_t = 2 * n * d + 8 * d
    # in turns with the accumulating transmit's no-carry call (the same
    # rows through the same ring, no epilogue)
    b3c, b3b = _in_turns(torch, flush, [
        lambda: ota_transmit_slab(grads, h, **tkw),
        lambda: ota_transmit_slab(grads, h)])
    ms = statistics.median(b3c)
    print(f"[times] ota_transmit_slab {n}x{d} (int8, host rounding, EF, "
          f"residual) and {STREAM}'s no-carry call, in turns: "
          + " ".join(f"{t:.4f}" for t in b3c) + " ms against "
          + " ".join(f"{t:.4f}" for t in b3b) + " ms: "
          f"{1e3 * (ms - statistics.median(b3b)):.2f} us over it")
    rows["ota_transmit_slab"] = (
        ms,
        _median_ms(torch, lambda: ota_transmit_ref(grads, h, **tkw), flush),
        bytes_t, ops_t)
    # in-kernel rounding: no r to read, a Philox draw a 4-column group
    # (about 40 integer operations); its plain version takes r (it has no
    # Philox), the same work otherwise
    skw = dict(quantize=True, ef=ef, return_residual=True)
    rows["ota_transmit_slab sr_seed"] = (
        _median_ms(torch, lambda: ota_transmit_slab(grads, h, sr_seed=7,
                                                    **skw), flush),
        rows["ota_transmit_slab"][1], bytes_t - 4 * d, ops_t + 10 * d)
    # S3's quantized finish: one row, h = 1, n_total = 1
    g1, h1 = grads[:1], torch.ones(1, device=dev)
    rows[f"ota_transmit_slab 1x{d}"] = (
        _median_ms(torch, lambda: ota_transmit_slab(g1, h1, n_total=1, **tkw),
                   flush),
        _median_ms(torch, lambda: ota_transmit_ref(g1, h1, n_total=1, **tkw),
                   flush),
        4 * d + 4 + 3 * 4 * d + d + 4 * (d // 128), 2 * d + 8 * d)
    # receive, R = 1: reads q (int8, or 1 bit a column packed), s, u, e;
    # writes out; 2 an entry to dequantize and about 12 for the CMS
    # transform.
    q, s = ota_transmit_slab(grads, h, quantize=True, r=r)
    q, s = q[None], s[None]
    words = pack_sign_slab(torch.where(q < 0, -1, 1).to(torch.int8))
    rkw = dict(alpha=1.5, scale=0.1)
    bytes_r = d + 4 * (d // 128) + 3 * 4 * d
    bytes_f = 4 * (d // 32) + 4 * (d // 128) + 3 * 4 * d
    ops_r = 14 * d
    rows["ota_receive_slab"] = (
        _median_ms(torch, lambda: ota_receive_slab(q, s, u, e, **rkw), flush),
        _median_ms(torch, lambda: ota_receive_ref(q, s, u, e, **rkw), flush),
        bytes_r, ops_r)
    # with pilot statistics: + 12 bytes out, and a log, a square and 3
    # adds a column; the wrapper's whole call (one launch since the fold
    # moved into the kernel; two before, the kernel and a torch.sum)
    rows["ota_receive_slab stats"] = (
        _median_ms(torch, lambda: ota_receive_slab(q, s, u, e,
                                                   pilot_stats=True, **rkw),
                   flush),
        _median_ms(torch, lambda: ota_receive_ref(q, s, u, e,
                                                  pilot_stats=True, **rkw),
                   flush), bytes_r + 12, ops_r + 6 * d)
    rows["ota_receive_slab fold"] = (
        _median_ms(torch, lambda: ota_receive_slab(words, s, u, e,
                                                   packed="fold", **rkw),
                   flush),
        _median_ms(torch, lambda: ota_receive_ref(words, s, u, e,
                                                  packed="fold", **rkw),
                   flush), bytes_f, ops_r)
    # the accumulating transmit, one chunk with a carry, at the streamed
    # runs' chunk (50 x 175,104) and the million-client chunk (2000 x
    # 4096): reads G, h, acc and writes out; 2 n d flops for the faded
    # sum and 2 d for the carry. torch.addmv is the one PyTorch call that
    # computes the same function (cuBLAS GEMV), the yardstick.
    library = {}
    for n_s, d_s in ((N_CLIENTS, D_MAIN), (CHUNK_MILLION, D_MILLION)):
        gs = torch.randn(n_s, d_s, generator=gen, device=dev)
        hs = torch.rand(n_s, generator=gen, device=dev)
        acc = torch.randn(d_s, generator=gen, device=dev)
        skw = dict(n_total=n_s, acc=acc)
        name = f"{STREAM} {n_s}x{d_s}"
        rows[name] = (
            _median_ms(torch, lambda: ota_transmit_slab(gs, hs, **skw),
                       flush),
            _median_ms(torch, lambda: ota_transmit_ref(gs, hs, **skw),
                       flush),
            4 * (n_s * d_s + n_s + 2 * d_s), 2 * n_s * d_s + 2 * d_s)
        library[name] = ("torch.addmv", _median_ms(
            torch, lambda: torch.addmv(acc, gs.t(), hs, alpha=1.0 / n_s),
            flush))
        n_seg = row_split(n_s, d_s, None, True, sm_count(dev.index))
        print(f"[times] {name}: the rows split into S = {n_seg} segments; "
              f"{rows[name][0] / library[name][1]:.3f} x torch.addmv's time")
        if n_seg > 1:
            _fold_cost(torch, dev, gen, flush, gs, hs, acc, n_seg)
    del gs, acc
    # flash attention at the two models' prefill shapes, bf16 (the Hopper
    # variant): reads q, k, v and writes out once; 4 D flops for each
    # visible (query, key) pair and head, counted for these masks, at the
    # bf16 tensor-core rate. Then the scalar variant at Qwen3's shape in
    # f32 (what an f32 prefill at full width would run), at the f32 rate.
    # scaled_dot_product_attention computes the same function (the window
    # as a boolean mask): the yardstick, never called by the port.
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    rates = {}
    flash_runs = [(f"{FLASH} hopper {a}", c, torch.bfloat16)
                  for a, c in FLASH_MODEL_SHAPES.items()]
    flash_runs.append((f"{FLASH} scalar f32 qwen3-14b",
                       FLASH_MODEL_SHAPES["qwen3-14b"], torch.float32))
    for name, case, dtype in flash_runs:
        b, sq, sk, h, kh, d, causal, window = case
        q, k, v = _flash_inputs(torch, dev, case, dtype, 7)
        i = np.arange(sq)
        lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
        hi = np.minimum(sk - 1, i) if causal else np.full_like(i, sk - 1)
        pairs = int(np.maximum(0, hi - lo + 1).sum())
        fkw = dict(causal=causal, window=window)
        ops = b * pairs * h * 4 * d
        rows[name] = (
            _median_ms(torch, lambda: flash_attention(q, k, v, **fkw), flush),
            _median_ms(torch, lambda: flash_attention_ref(q, k, v, **fkw),
                       flush),
            q.element_size() * (2 * q.numel() + 2 * k.numel()), ops)
        if dtype == torch.bfloat16:
            rates[name] = (BF16_FLOPS_PER_S, "bf16 flops at 989 TFLOP/s")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            dpos = (torch.arange(sq, device=dev)[:, None]
                    - torch.arange(sk, device=dev)[None, :])
            mask = (dpos >= 0) & (dpos < window)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
        diff = float((sdpa().transpose(1, 2).float()
                      - flash_attention(q, k, v, **fkw).float()).abs().max())
        sdpa_ms = _median_ms(torch, sdpa, flush)
        library[name] = ("scaled_dot_product_attention", sdpa_ms)
        ms = rows[name][0]
        print(f"[times] {name}: {pairs} visible pairs a head, "
              f"{ops / ms / 1e9:.1f} TFLOP/s; {ms / sdpa_ms:.3f} x "
              f"scaled_dot_product_attention's time, which differs from "
              f"the kernel by {diff:.3e} at most")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    out = {}
    for name, (ms, plain_ms, nbytes, ops) in rows.items():
        rate, what = rates.get(name, (F32_FLOPS_PER_S,
                                      "f32 ops at 67 TFLOP/s"))
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * ops / rate
        bound = max(t_bytes, t_ops)
        lib_name, lib_ms = library.get(name, (None, None))
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes" if t_bytes >= t_ops else
                         "operations", bytes=nbytes, library_ms=lib_ms)
        print(f"[times] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.5f} ms ({out[name]['bound_by']}: {nbytes} B at "
              f"3.35 TB/s; {ops} {what}), share of bound "
              f"{bound / ms:.3f}; launch floor {floor:.4f} ms, kernel - "
              f"floor {ms - floor:.4f} ms; "
              + (f"library ({lib_name}) {lib_ms:.4f} ms" if lib_ms else
                 "library_ms null: no single PyTorch call computes this "
                 "function"))
    return out, floor


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
    from repro_torch.kernels.ota_channel import (ota_channel_slab,
                                                 ota_receive_slab,
                                                 ota_transmit_slab)

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
          f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(build.NVCC_FLAGS)}"
          "; " + ", ".join(f"{src} {' '.join(fl) or 'no more'}"
                           for src, fl in build.SOURCE_FLAGS.items()) + ")")
    phase_build_report(build, lib_path)

    from repro_torch.core.slab import make_slab_spec
    from repro_torch.models.vision import resnet_tiny
    spec = make_slab_spec(resnet_tiny(10).init(seed=0, device="cpu"))
    check(spec.padded == D_MAIN, f"ResNet-tiny slab {spec.padded}")

    err_update = phase_kernel_update(torch, dev)
    err_channel = phase_kernel_channel(torch, dev, spec.total)
    err_transmit = phase_kernel_transmit(torch, dev, spec.total)
    err_receive = phase_kernel_receive(torch, dev, spec.total)
    err_update[D_MAIN] = max(err_update[D_MAIN],
                             phase_runtime_alpha(torch, dev, spec.total))
    err_stream = phase_kernel_stream(torch, dev, spec.total)
    err_flash = phase_kernel_flash(torch, dev)
    phase_reference(torch, np)
    phase_reference_wire(torch, np)
    phase_reference_stream(torch, np)
    phase_stream_equals_resident(torch, np, dev)
    counters = (adaptive_update_slab, ota_channel_slab)
    launches = phase_main_path(torch, np, dev, counters)
    all_counters = counters + (ota_transmit_slab, ota_receive_slab,
                               Counter(ota_transmit_slab, "stream_launches",
                                       STREAM))
    launches[STREAM] = 0
    wire_launches, wire_by_run = phase_wire_runs(torch, np, dev,
                                                 all_counters)
    stream_launches = phase_streamed_runs(torch, np, dev, all_counters)
    million_launches = phase_million(torch, dev, all_counters)
    api_launches = phase_round_api(torch, np, dev, all_counters)
    ckpt_launches = phase_checkpoint(torch, np, dev, all_counters)
    for part in (wire_launches, stream_launches, million_launches):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    # launches by shape: the accumulating kernel's chunks, the streamed
    # runs' one-row channel finish, the million-client stream's finish
    # and update
    launches[f"{STREAM} {N_CLIENTS}x{D_MAIN}"] = stream_launches[STREAM]
    launches[f"{STREAM} {CHUNK_MILLION}x{D_MILLION}"] = \
        million_launches[STREAM]
    launches[f"ota_channel_slab 1x{D_MAIN}"] = \
        stream_launches["ota_channel_slab"]
    launches[f"ota_channel_slab 1x{D_MILLION}"] = \
        million_launches["ota_channel_slab"]
    launches[f"adaptive_update_slab d={D_MILLION}"] = \
        million_launches["adaptive_update_slab"]
    # the quantized wire by variant: the transmit at 50 x 175,104 with
    # host rounding or the sign quantizer, with in-kernel rounding, and
    # S3's one-row finish; the receive with pilot statistics (the
    # alpha="auto" runs) and without
    tx, rx = "ota_transmit_slab", "ota_receive_slab"
    launches[f"{tx} sr_seed"] = wire_by_run["int8-srk-ef"][tx]
    launches[tx] = wire_launches[tx] - launches[f"{tx} sr_seed"]
    launches[f"{tx} 1x{D_MAIN}"] = stream_launches[tx]
    launches[f"{rx} stats"] = (wire_by_run["int8-ef-dl8-auto"][rx]
                               + stream_launches[rx])
    launches[rx] = wire_launches[rx] + stream_launches[rx] - \
        launches[f"{rx} stats"]
    # the per-round API's runs and the resident runs beside them (f32:
    # channel and update; int8: transmit with host rounding, receive
    # without statistics, update), and the checkpoint runs (alpha="auto":
    # the receive with statistics)
    upd, chan = "adaptive_update_slab", "ota_channel_slab"
    launches[upd] += api_launches[upd] + ckpt_launches[upd]
    launches[chan] += api_launches[chan]
    launches[tx] += api_launches[tx] + ckpt_launches[tx]
    launches[rx] += api_launches[rx]
    launches[f"{rx} stats"] += ckpt_launches[rx]
    from repro_torch.kernels.flash_attention import flash_attention
    hopper = Counter(flash_attention, "hopper_launches", f"{FLASH} hopper")
    for arch in FLASH_MODEL_SHAPES:
        runs = phase_serve(torch, dev, flash_attention, hopper, arch)
        launches[f"{FLASH} hopper {arch}"] = sum(r["hopper_launches"]
                                                 for r in runs.values())
    launches[f"{FLASH} scalar f32 qwen3-14b"] = phase_reference_serve(
        torch, dev)
    times, floor = phase_times(torch, dev)

    b1 = ("adaptive_update.cu", "src/repro/kernels/adaptive_update.py:188")
    b2 = ("ota_channel.cu", "src/repro/kernels/ota_channel.py:222")
    b3c = ("ota_transmit.cu", "src/repro/kernels/ota_channel.py:527")
    b4 = ("ota_receive.cu", "src/repro/kernels/ota_channel.py:679")
    rows = (("adaptive_update_slab", *b1, err_update[D_MAIN]),
            (f"adaptive_update_slab d={D_MILLION}", *b1,
             err_update[D_MILLION]),
            ("ota_channel_slab", *b2, err_channel[(N_CLIENTS, D_MAIN)]),
            (f"ota_channel_slab 1x{D_MAIN}", *b2, err_channel[(1, D_MAIN)]),
            (f"ota_channel_slab 1x{D_MILLION}", *b2,
             err_channel[(1, D_MILLION)]),
            ("ota_transmit_slab", *b3c, err_transmit),
            ("ota_transmit_slab sr_seed", *b3c, err_transmit),
            (f"ota_transmit_slab 1x{D_MAIN}", *b3c, err_transmit),
            ("ota_receive_slab", *b4, err_receive),
            ("ota_receive_slab stats", *b4, err_receive),
            (f"{STREAM} {N_CLIENTS}x{D_MAIN}", "ota_transmit_stream.cu",
             "src/repro/kernels/ota_channel.py:447", err_stream),
            (f"{STREAM} {CHUNK_MILLION}x{D_MILLION}", "ota_transmit_stream.cu",
             "src/repro/kernels/ota_channel.py:447", err_stream))
    rows += tuple((f"{FLASH} hopper {arch}", "flash_attention_sm90.cu",
                   "src/repro/kernels/flash_attention.py:106",
                   err_flash["hopper"]) for arch in FLASH_MODEL_SHAPES)
    rows += ((f"{FLASH} scalar f32 qwen3-14b", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:106",
              err_flash["scalar"]),)
    kernels = [dict(name=name, route="cuda",
                    source="src/repro_torch/csrc/" + source,
                    replaces=replaces, launches=launches[name],
                    max_abs_err=err,
                    **{k: times[name][k] for k in ("ms", "plain_ms",
                                                   "bound_ms", "bound_by",
                                                   "library_ms")})
               for name, source, replaces, err in rows]
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
