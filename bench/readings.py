"""The readings a cell's limits are set from, in one process.

    python3 bench/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--out <file>]

For each seed of ``--seeds``: the program's first three rounds through
the timed path's set-up (no window) against the plain reference: the
lower readings. For each seed of ``--control-seeds``: the control (the
reference in the next precision down, ``bench/ref/round.py``) and the
planted fault (half of each client's rows left out) against the
reference, and the faults a round can have (half of each client's rows
left out; a round that returns its state unchanged): the upper
readings. One JSON line a reading, on standard
output and appended to ``--out``. The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--variants", nargs="*",
                    default=["control", "half", "frozen"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import check, harness

    dev = torch.device(args.device)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        cell = harness.Cell(ROOT, args.workload)
        seeds = harness.Seeds(seed)
        t0 = time.perf_counter()
        ref = None
        if seed in args.seeds:
            prog = harness.Program(cell, seeds, dev)
            got = prog.first_rounds()
            prog.free()
            del prog
            t1 = time.perf_counter()
            ref = harness.reference(cell, seeds, dev)
            t2 = time.perf_counter()
            emit({"workload": args.workload, "seed": seed, "side": "program",
                  "numbers": check.numbers(got, ref),
                  "program_s": t1 - t0, "reference_s": t2 - t1,
                  "loss": got["loss"], "ref_loss": ref["loss"]})
        if seed in args.control_seeds:
            if ref is None:
                ref = harness.reference(cell, seeds, dev)
            for variant in args.variants:
                t1 = time.perf_counter()
                other = harness.reference(cell, seeds, dev, variant)
                emit({"workload": args.workload, "seed": seed,
                      "side": variant, "numbers": check.numbers(other, ref),
                      "seconds": time.perf_counter() - t1})
        del ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
