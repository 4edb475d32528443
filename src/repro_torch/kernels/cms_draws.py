"""The round's CMS inputs (u, e) in one launch, on torch's own Philox stream.

``cms_draws_slab(spec, generator)`` returns the padded (u, e) slabs of
``kernels.ref.cms_draws_ref``: two ``torch.rand((total,))`` calls on
``generator``, the CMS transforms and the fixed-point tail. On a CUDA
generator it launches the hand-written kernel in ``csrc/cms_draws.cu``,
which draws the same uniforms as those two calls (the same Philox
counters, read from the generator's seed and offset) and writes the
same bits, then advances the generator past both calls, so every draw
after it is unchanged. On a CPU generator it runs the plain version.
Nothing else selects between the two.

``launch_policy`` and ``rand_launches`` restate on the host how the
card's torch launches ``torch.rand`` on a float32 vector
(``ATen/native/cuda/DistributionTemplates.h``: ``calc_execution_policy``
and ``distribution_nullary_kernel``, and ``philox_cuda_state``'s
rounding of each increment to a multiple of 4). That is torch's private
code, read on the card for the releases in ``CARD_TORCH``; on any other
release the CUDA path refuses (``check_torch_release``) rather than draw
numbers that may no longer be ``torch.rand``'s.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.core.channel import CMS_E_FLOOR, CMS_U_BOUND
from repro_torch.kernels import build
from repro_torch.kernels.ref import cms_draws_ref

__all__ = ["CARD_TORCH", "MAX_PIECES", "check_torch_release",
           "cms_draws_slab", "launch_policy", "rand_launches"]

THREADS = 256        # block_size_bound
UNROLL = 4           # four floats from each curand_uniform4 call
OFFSETS_A_CALL = 4   # max_generator_offsets_per_curand_call
# The most float32 entries a piece drawn with 32-bit indexing holds:
# its largest byte offset, 4 (n - 1) + 1, must fit in an int32.
PIECE_MAX = 2 ** 29
MAX_PIECES = 16      # kMaxPieces of csrc/cms_draws.cu
# The torch releases (major.minor) whose launches of ``torch.rand`` were
# read on an H100 (``g.get_offset()``'s advances) and against which the
# kernel passed bit for bit (the ``cuda``-marked tests of
# tests/test_torch_cms_draws.py). Add a release only once those tests
# pass on it.
CARD_TORCH = ("2.11",)


def check_torch_release(version: str) -> None:
    """Raise unless ``version`` (``torch.__version__``) is of a release
    in ``CARD_TORCH``."""
    release = ".".join(version.split("+")[0].split(".")[:2])
    if release not in CARD_TORCH:
        raise RuntimeError(
            f"cms_draws_slab: torch {version}'s launches of torch.rand were "
            f"not read on the card (read for {', '.join(CARD_TORCH)}); run "
            "the cuda-marked tests of tests/test_torch_cms_draws.py on it "
            "and add its release to CARD_TORCH")


def launch_policy(numel: int, sms: int, threads_per_sm: int
                  ) -> Tuple[int, int]:
    """(grid, counter_offset) of one launch of ``numel`` uniforms on a
    card of ``sms`` multiprocessors of ``threads_per_sm`` threads."""
    grid = min(sms * (threads_per_sm // THREADS), -(-numel // THREADS))
    per_thread = (numel - 1) // (THREADS * grid * UNROLL) + 1
    return grid, per_thread * OFFSETS_A_CALL


def _advance(counter_offset: int) -> int:
    """What the generator adds to its offset for one launch."""
    return -(-counter_offset // 4) * 4


def rand_launches(numel: int, sms: int, threads_per_sm: int
                  ) -> Tuple[List[Tuple[int, int, int, int]], int]:
    """``torch.rand((numel,))`` in float32 as the launches it makes:
    ``[(start, n, grid, offset)]``, each offset relative to the
    generator's before the call, and the call's whole advance. Past
    ``PIECE_MAX`` entries the call takes its own offset first, unused,
    then halves the vector (the first half ``n // 2``), depth first,
    until each piece fits, and launches the pieces in order."""
    pieces: List[Tuple[int, int]] = []

    def split(start: int, n: int) -> None:
        if n <= PIECE_MAX:
            pieces.append((start, n))
        else:
            split(start, n // 2)
            split(start + n // 2, n - n // 2)

    split(0, numel)
    advance = 0
    if numel > PIECE_MAX:
        advance = _advance(launch_policy(numel, sms, threads_per_sm)[1])
    out = []
    for start, n in pieces:
        grid, co = launch_policy(n, sms, threads_per_sm)
        out.append((start, n, grid, advance))
        advance += _advance(co)
    return out, advance


def cms_draws_slab(spec, generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, e), each (spec.padded,) float32 on the generator's device:
    ``cms_draws_ref``'s values, bit for bit, with the generator left
    where those two ``torch.rand`` calls leave it."""
    dev = generator.device
    if dev.type == "cpu":
        return cms_draws_ref(spec, generator)
    if dev.type != "cuda":
        raise ValueError(f"cms_draws_slab takes a cuda or cpu generator, "
                         f"got {dev}")
    check_torch_release(torch.__version__)
    total, padded = int(spec.total), int(spec.padded)
    if total < 1 or padded < total:
        raise ValueError(f"need 1 <= total <= padded, got {total}, {padded}")
    props = torch.cuda.get_device_properties(dev)
    launches, advance = rand_launches(total, props.multi_processor_count,
                                      props.max_threads_per_multi_processor)
    if len(launches) > MAX_PIECES:
        raise ValueError(f"{total} entries take {len(launches)} pieces, "
                         f"more than the kernel's {MAX_PIECES}")
    seed = generator.initial_seed()
    base = generator.get_offset()
    u = torch.empty((padded,), dtype=torch.float32, device=dev)
    e = torch.empty((padded,), dtype=torch.float32, device=dev)
    k = len(launches)
    start, n, grid, rel = zip(*launches)
    ll, ull = ctypes.c_longlong * k, ctypes.c_ulonglong * k
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.repro_cms_draws(
            k, ll(*start), ll(*n), (ctypes.c_int * k)(*grid),
            ull(*(base + r for r in rel)),
            ull(*(base + advance + r for r in rel)), seed,
            2.0 * CMS_U_BOUND, CMS_U_BOUND, CMS_E_FLOOR, u.data_ptr(),
            e.data_ptr(), total, padded, stream)
    build.check(code, "cms_draws_slab")
    generator.set_offset(base + 2 * advance)
    cms_draws_slab.launches += 1
    return u, e


cms_draws_slab.launches = 0
