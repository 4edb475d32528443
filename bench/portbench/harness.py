"""One run of one cell: set-up, the measured window, the trace, the check.

The cell is looked up by name in ``BENCHMARK.json``; its configuration
file (``configs`` entry), its traffic file (``bench/traffic/<mix>.json``)
and its limits (``bench/limits/<cell>.json``) are data. The model
family picks its reference (``bench/ref/<family>.py``) and its FLOP
count (``bench/counts/<family>.py``); each per-layer metric is a reader
``bench/metrics/<name>.py``. A cell made of new files runs through this
code unchanged.

The timed path is the training CLI's: ``run_rounds_slab`` (chunk 1) over
``make_slab_round_runner(build_model(cfg).loss_fn, ...)`` with the
port's ``TorchDraws``. Set-up makes the weights on the device from the
seed, builds the runner and the state, and drives them through the
cell's first three rounds: the warm-up, and the rounds the reference
follows. The same runner and state then run whole rounds for the
window. Nothing the program made reaches the reference: it regenerates
the weights, the draws and the batches from the seed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Optional

from portbench import check
from portbench.corpus import make_batch_fn

BENCH = Path(__file__).resolve().parents[1]
WARMUP_ROUNDS = 3                   # the rounds the reference follows
COUNTERS = ("B1", "B2", "B3b", "B3c", "B4", "B5")
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")
_M64 = (1 << 64) - 1


def mix64(x: int) -> int:
    """splitmix64's finalizer: the harness's seeds from ``--seed``."""
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class Seeds:
    """The seeds a run takes from ``--seed`` (any whole number): the
    weights', the draws' (``TorchDraws`` takes [0, 2^31)) and the
    corpus'."""

    def __init__(self, seed: int):
        s = int(seed) & _M64
        self.weights = mix64(s ^ 0x5717) & ((1 << 63) - 1)
        self.draws = mix64(s ^ 0xD4A5) % (2**31 - 1)
        self.corpus = mix64(s ^ 0xC0A5) & ((1 << 63) - 1)


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's data and the modules its names select."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"options: {sorted(cells)}")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads(
            (self.root / self.config_entry["file"]).read_text())
        self.model = self.config["model"]
        bench = self.root / "bench"
        self.traffic = json.loads(
            (bench / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        lim = bench / "limits" / f"{workload}.json"
        self.limits = json.loads(lim.read_text()) if lim.exists() else {}
        self._bench = bench
        self._mods: dict = {}
        self.kind: Optional[str] = None
        self.padded = self.total = 0

    def _mod(self, sub: str, name: str):
        key = (sub, name)
        if key not in self._mods:
            self._mods[key] = load(self._bench / sub / f"{name}.py",
                                   f"portbench_{sub}_{name}")
        return self._mods[key]

    def counts(self, name: str):
        return self._mod("counts", name)

    def ref(self):
        return self._mod("ref", self.model["family"])

    def ref_round(self):
        return self._mod("ref", "round")

    def reader(self, metric: str):
        return self._mod("metrics", metric)

    def peak(self, key: str) -> Optional[float]:
        peaks = json.loads((self._bench / "peaks.json").read_text())
        for card, vals in peaks["cards"].items():
            if self.kind and self.kind.startswith(card):
                return vals.get(key)
        return None

    def metrics(self, section: str) -> list:
        """This cell's metrics of ``end_to_end`` or ``per_layer``."""
        name = self.workload["name"]
        e2e = {m["name"]: m for m in self.bench["end_to_end"]}

        def mine(m):
            if "workloads" in m:
                return name in m["workloads"]
            moved = e2e.get(m.get("moves"))
            return moved is None or "workloads" not in moved \
                or name in moved["workloads"]

        return [m for m in self.bench[section] if mine(m)]

    def leaves(self):
        return self.ref_round().flatten_layout(self.ref().layout(self.model))


def make_weights(cell: Cell, seed: int, device):
    """The weights from the seed, on the device, in their stated types:
    one bf16 normal draw for every random leaf, scaled in place a leaf;
    norms' scales ones, biases zeros. Returns (nested dict, leaves)."""
    import torch

    leaves = cell.leaves()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rand = [lf for lf in leaves if lf.init[0] == "normal"]
    dt = {lf.dtype for lf in rand}
    if len(dt) != 1:
        raise ValueError(f"random leaves of several types: {dt}")
    buf = torch.randn((sum(lf.size for lf in rand),), generator=gen,
                      device=device, dtype=dt.pop())
    out: dict = {}
    off = 0
    for lf in leaves:
        if lf.init[0] == "normal":
            t = buf[off:off + lf.size].view(lf.shape).mul_(lf.init[1])
            off += lf.size
        elif lf.init[0] == "ones":
            t = torch.ones(lf.shape, dtype=lf.dtype, device=device)
        else:
            t = torch.zeros(lf.shape, dtype=lf.dtype, device=device)
        node = out
        for k in lf.path[:-1]:
            node = node.setdefault(k, {})
        node[lf.path[-1]] = t
    return out, leaves


def weights_slab(cell: Cell, seed: int, device):
    """The same weights as one f32 slab (zero tail to a multiple of 128):
    what the reference starts from."""
    import torch

    tree, leaves = make_weights(cell, seed, device)
    total = sum(lf.size for lf in leaves)
    slab = torch.zeros((-(-total // 128) * 128,), dtype=torch.float32,
                       device=device)
    for lf in leaves:
        node = tree
        for k in lf.path:
            node = node[k]
        slab[lf.offset:lf.offset + lf.size].copy_(node.reshape(-1))
    return slab, leaves


def _counters():
    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ota_channel import (ota_channel_slab,
                                                 ota_receive_slab,
                                                 ota_transmit_slab)
    return {"B1": (adaptive_update_slab, "launches"),
            "B2": (ota_channel_slab, "launches"),
            "B3b": (ota_transmit_slab, "stream_launches"),
            "B3c": (ota_transmit_slab, "launches"),
            "B4": (ota_receive_slab, "launches"),
            "B5": (flash_attention, "launches")}


def read_counters() -> dict:
    return {k: getattr(f, a) for k, (f, a) in _counters().items()}


class Program:
    """The system under test, set up for a cell: runner, state, draws
    and the batch feed, driven through the first three rounds."""

    def __init__(self, cell: Cell, seeds: Seeds, device,
                 wrap_loss: Optional[Callable] = None):
        import torch
        from repro_torch.core.adaptive import AdaptiveConfig
        from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
        from repro_torch.core.draws import TorchDraws
        from repro_torch.core.fl import FLConfig, make_slab_round_runner
        from repro_torch.core.slab_state import init_train_state
        from repro_torch.models.model import ModelConfig, build_model

        tr = cell.traffic
        mcfg = ModelConfig(**cell.model)
        model = build_model(mcfg)
        ch = OTAChannelConfig(
            alpha=tr["alpha"], xi_scale=tr["xi_scale"], fading=tr["fading"],
            mu_c=tr["mu_c"], uplink=UplinkConfig(
                mode=tr["uplink"], error_feedback=tr["error_feedback"]))
        ad = AdaptiveConfig(optimizer=tr["optimizer"], lr=tr["lr"],
                            beta1=tr["beta1"], beta2=tr["beta2"],
                            alpha=tr["alpha"], eps=tr["eps"])
        fl = FLConfig(n_clients=tr["clients"],
                      client_chunk=tr.get("client_chunk"))
        params, self.leaves = make_weights(cell, seeds.weights, device)
        state = init_train_state(ad, params, error_feedback=tr[
            "error_feedback"], device=device)
        del params
        spec = state.spec
        want = [lf.shape for lf in self.leaves]
        if [tuple(s) for s in spec.shapes] != want or \
                list(spec.offsets) != [lf.offset for lf in self.leaves]:
            raise ValueError("the program's slab layout is not the "
                             "reference's: " f"{spec.shapes} vs {want}")
        cell.padded, cell.total = spec.padded, spec.total
        loss_fn = model.loss_fn if wrap_loss is None else wrap_loss(
            model.loss_fn)
        self.runner = make_slab_round_runner(loss_fn, ch, ad, fl,
                                             device=device)
        self.draws = TorchDraws(ch, spec, tr["clients"], seed=seeds.draws,
                                device=device)
        self.batch_fn = make_batch_fn(tr, cell.model["vocab"], seeds.corpus)
        self.state = state
        self.device = device
        self.cell = cell
        self.seeds = seeds
        self.t = 0
        self._torch = torch

    def rounds(self, n: int, hook=None) -> list:
        """Run rounds t .. t+n-1 through ``run_rounds_slab``; returns
        their history records."""
        from repro_torch.core.fl import run_rounds_slab

        self.state, hist = run_rounds_slab(
            self.runner, self.state, self.draws, self.batch_fn, self.t + n,
            chunk=1, start_round=self.t, chunk_hook=hook)
        self.t += n
        return hist

    def first_rounds(self) -> dict:
        """The checked rounds 0-2 and the program's readings of them."""
        torch = self._torch
        rr = self.cell.ref_round()
        snap = {}

        def hook(t, st, history):
            if t == 1:
                snap["delta1"] = rr.leaf_norms(st.opt[0], self.leaves)

        hist = self.rounds(WARMUP_ROUNDS, hook)
        w0, _ = weights_slab(self.cell, self.seeds.weights, self.device)
        st = self.state
        seen = rr.clients_view(st.w, self.leaves, "f32")
        change = rr.leaf_norms(seen - rr.clients_view(w0, self.leaves,
                                                      "f32"), self.leaves)
        del w0, seen
        out = {"loss": [h["loss"] for h in hist],
               "grad_norm": [h["grad_norm"] for h in hist],
               "delta1": snap["delta1"], "change": change,
               "ef": (None if st.ef is None
                      else rr.leaf_norms(st.ef[0], self.leaves))}
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return out

    def free(self):
        torch = self._torch
        del self.state, self.runner, self.draws
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference(cell: Cell, seeds: Seeds, device, variant: str = "f32"):
    """The plain reference's readings of the cell's first rounds."""
    w0, leaves = weights_slab(cell, seeds.weights, device)
    fn = make_batch_fn(cell.traffic, cell.model["vocab"], seeds.corpus)
    tokens = [fn(t)["tokens"] for t in range(WARMUP_ROUNDS)]
    return cell.ref_round().run_rounds(cell.ref(), cell.model, cell.traffic,
                                       leaves, w0, tokens, seeds.draws,
                                       WARMUP_ROUNDS, variant)


def jax_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(JAX_NAMES))


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, device_name: str = "cuda",
        wrap_loss: Optional[Callable] = None, log=print) -> dict:
    """One run of the cell. Returns the result line's object; raises
    where the run cannot give one."""
    import torch

    cell = Cell(root, workload)
    dev = torch.device(device_name)
    cuda = dev.type == "cuda"
    if cuda:
        cell.kind = torch.cuda.get_device_name(0)
        from repro_torch.device import warm_up_profiler
        if trace:
            warm_up_profiler()
    seeds = Seeds(seed)
    phases = [("start", time.perf_counter() - t_process)]
    prog = Program(cell, seeds, dev, wrap_loss)
    phases.append(("program built", time.perf_counter() - t_process))
    readings = prog.first_rounds()
    phases.append(("first rounds read", time.perf_counter() - t_process))
    # Each round leaves about a thousand objects in reference cycles, and
    # a full collection over the process's objects takes ~0.2 s. So
    # set-up's objects are frozen out of the collector, the collector
    # does not run on its own in the window, and each round's garbage is
    # collected as the round ends (under a millisecond), inside the
    # window: the round times do not depend on when the collector would
    # have run.
    gc.collect()
    gc.freeze()
    gc.disable()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = read_counters()
    stamps, losses = [], []

    def window():
        stamps.append(time.perf_counter())
        while True:
            losses.extend(h["loss"] for h in prog.rounds(1))
            gc.collect()
            stamps.append(time.perf_counter())
            if stamps[-1] - stamps[0] >= seconds:
                return len(stamps) - 1, None

    summary = None
    if trace:
        from portbench.trace import traced_window
        _, summary = traced_window(window, cell, cuda)
    else:
        window()
    setup_s = stamps[0] - t_process
    rounds = len(stamps) - 1
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launched = {k: v - before[k] for k, v in read_counters().items()}
    gc.enable()
    prog.free()
    del prog
    gc.unfreeze()
    ref = reference(cell, seeds, dev)
    nums = check.numbers(readings, ref)
    if cuda:
        want = cell.traffic["launches"]
        nums["launches_off"] = float(sum(
            abs(launched[k] - rounds * want.get(k, 0)) for k in COUNTERS))
    correct, shown = check.verdict(nums, cell.limits)
    failed = sum(1 for x in losses if not math.isfinite(x))
    spans = [b - a for a, b in zip(stamps, stamps[1:])]
    values = {
        "round_ms": 1e3 * (stamps[-1] - stamps[0]) / rounds,
        "round_ms_p90": _p90_of_pairs(stamps),
        "peak_mem_gb": peak / 1e9,
        "setup_s": setup_s,
    }
    out = {"correct": bool(correct and failed == 0), "attempted": rounds,
           "failed": failed}
    metrics = {}
    if trace:
        for m in cell.metrics("per_layer"):
            v = cell.reader(m["name"]).read(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = {"platform": "gpu" if cuda else "cpu",
                     "kind": cell.kind or "cpu",
                     "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["launches_a_round"] = {k: v / rounds for k, v in launched.items()}
    out["checks"] = shown
    log(json.dumps({"readings": {"program": readings, "reference": ref},
                    "set_up_s": phases, "round_s": spans}))
    return out


def _p90_of_pairs(stamps: list) -> float:
    """The 90th percentile of the window's per-round time taken over
    consecutive pairs of rounds (a pair spans 250 ms and more on the
    host clock)."""
    pairs = [(stamps[i + 2] - stamps[i]) / 2.0
             for i in range(0, len(stamps) - 2, 2)]
    if len(pairs) < 2:
        return 1e3 * statistics.mean(pairs or [stamps[-1] - stamps[0]])
    return 1e3 * statistics.quantiles(pairs, n=10)[8]
