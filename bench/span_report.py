"""A cell's traced run with the card's time split by the program's spans.

    python3 bench/span_report.py --workload <cell> --seed <n> --seconds <s> \
        [--out <file>]

Runs ``bench/run.py --trace 1``'s path (``portbench.harness.run``), the
window under ``torch.profiler`` inside ``trace.WINDOW``, and reduces the
same events a second time by span (``portbench/spans.py``), with
``repro_torch.spans.host_syncs`` read around the window. Prints one JSON
line: the run's result (``correct``, the per-layer metrics, ``device``,
``breakdown``), ``round_ms`` on the host clock under the profiler,
``spans`` (the ten readings a round), ``device_ms``, ``idle_ms`` and
``host_ms`` (a round, by span: the card's work, the card's idle time,
the host's time) and the sums they are checked against. Needs a program
that has ``repro_torch.spans``. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# as bench/run.py sets them
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import harness, trace
    from portbench.spans import reduce_spans
    from repro_torch import spans

    torch.set_num_threads(1)
    kept = {}

    def traced_window(fn, ctx=None, cuda=True):
        """``trace.traced_window``, keeping the span table too."""
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                syncs = spans.host_syncs
                rounds, result = fn()
                if cuda:
                    torch.cuda.synchronize()
                syncs = spans.host_syncs - syncs
        events = prof.profiler.kineto_results.events()
        kept["table"] = reduce_spans(events, rounds, syncs)
        return result, trace.summarize(events, rounds, ctx)

    saved, trace.traced_window = trace.traced_window, traced_window
    logged = []
    try:
        out = harness.run(ROOT, args.workload, args.seed, args.seconds, True,
                          T_PROCESS, device_name=args.device,
                          log=logged.append)
    finally:
        trace.traced_window = saved
    t = kept["table"]
    per = 1e3 / t.rounds
    round_s = json.loads(logged[-1])["round_s"]
    busy = out["device"]["busy_s"]
    rec = {"workload": args.workload, "seed": args.seed, **out,
           "round_ms": 1e3 * statistics.fmean(round_s),
           "spans": t.metrics(),
           "device_ms": {k: per * v for k, v in sorted(t.device_s.items())},
           "idle_ms": {k: per * v for k, v in sorted(t.idle_s.items())},
           "host_ms": {k: per * v for k, v in sorted(t.host_s.items())},
           "sums": {"device_ms": per * sum(t.device_s.values()),
                    "idle_ms": per * sum(t.idle_s.values()),
                    "window_idle_ms": per * (t.window_s - busy),
                    "host_ms": per * sum(t.host_s.values()),
                    "window_ms": per * t.window_s,
                    "ops": t.n_ops, "unmatched_ops": t.unmatched}}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
