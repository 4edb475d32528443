"""End-to-end driver on the PyTorch port: federated training of a
language model with the OTA channel + ADOTA server, via the port's
launcher. The twin of ``examples/train_lm_federated.py``: the same
default arguments, plus ``--device`` (default: the card).

Default is the reduced ``tiny`` model; pass --preset 100m for the
~100M-parameter run.

    PYTHONPATH=src python examples/train_lm_federated_torch.py --device cpu
    PYTHONPATH=src python examples/train_lm_federated_torch.py -- \\
        --preset 100m --rounds 300 --clients 8
"""

import sys
from typing import List

from repro_torch.launch.train import main

DEFAULT_ARGV = ["--preset", "tiny", "--rounds", "60", "--clients", "8",
                "--seq", "64"]


def launcher_argv(argv: List[str]) -> List[str]:
    """The launcher's arguments for this script's: everything after a
    ``--``; else ``DEFAULT_ARGV`` when nothing but ``--device`` is given,
    with that ``--device`` kept."""
    if "--" in argv:
        return argv[argv.index("--") + 1:]
    if (not argv or (argv[0] == "--device" and len(argv) == 2)
            or (len(argv) == 1 and argv[0].startswith("--device="))):
        return DEFAULT_ARGV + argv
    return argv


if __name__ == "__main__":
    main(launcher_argv(sys.argv[1:]))
