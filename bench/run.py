"""The port's benchmark: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``src/repro_torch`` and
``BENCHMARK.json``. Prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, with ``--trace 1``, ``breakdown``; last, ``checks``,
each compared number beside its limit, which also end standard error.
Exits non-zero, printing no result, without a CUDA card, with modules
of JAX loaded, or when the program cannot be imported.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# before torch touches the card: the 4 GB slabs fragment the default
# pool near 70 GB
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# one process, few threads: no idle pool of CPU threads beside the one
# that issues the work
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    torch.set_num_threads(1)
    cell = harness.Cell(ROOT, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), T_PROCESS,
                      log=lambda s: print(s, file=sys.stderr))
    found = harness.jax_loaded()
    if found:
        print(f"modules of JAX loaded in the run: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
