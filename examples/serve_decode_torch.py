"""Batched serving example on the PyTorch port: prefill + autoregressive
decode with the per-family cache (ring KV for windowed archs, latent
cache for MLA, O(1) recurrent state for RWKV / hybrid). The twin of
``examples/serve_decode.py``: the same default arguments, plus
``--device`` (default: the card).

    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
    PYTHONPATH=src python examples/serve_decode_torch.py -- --arch rwkv6-7b \\
        --preset tiny --batch 4 --gen 16
"""

import sys
from typing import List

from repro_torch.launch.serve import main

DEFAULT_ARGV = ["--arch", "rwkv6-7b", "--preset", "tiny", "--batch", "2",
                "--prompt-len", "32", "--gen", "8"]


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
