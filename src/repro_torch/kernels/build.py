"""Build the port's CUDA kernels and bind them with ctypes.

Each source under ``src/repro_torch/csrc/`` (``SOURCES``; the OTA
kernels include the shared headers ``ota_common.cuh`` and
``ota_ring.cuh``) is compiled by its own ``nvcc`` process for ``sm_90a``
(all started together), and the objects are linked into one shared
library with a plain C interface under ``<repo>/build/kernels/``. The
library's name carries a hash of the sources, headers and flags, so an
edited source is rebuilt at its first use and an unchanged one is loaded
as built. Nothing is built at import time:
``load_library()`` builds on first call.

Flags: every source gets ``NVCC_FLAGS``, ``-O3`` with precise math (no
``--use_fast_math``: the CMS transform, the fractional powers and the
softmax keep ``sinf``/``cosf``/``powf``/``expf`` at full accuracy), and
its own flags from ``SOURCE_FLAGS``. The update, OTA and CMS-draw kernels
add ``--fmad=false`` (no mul+add contraction), so each computes the same
f32 operations as its plain version. The two flash-attention kernels do
not: their tiers against the plain version are tolerances (their sums
run in another order than the plain ``einsum`` anyway), so they keep
nvcc's default contraction into fused multiply-adds. The Hopper one
(``flash_attention_sm90.cu``) takes ``cuTensorMapEncodeTiled`` from
``libcuda.so.1`` at run time, so the link line needs no ``-lcuda``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
EXACT = ("--fmad=false",)
# source -> its flags on top of NVCC_FLAGS
SOURCE_FLAGS = {"adaptive_update.cu": EXACT, "ota_channel.cu": EXACT,
                "ota_transmit.cu": EXACT, "ota_transmit_stream.cu": EXACT,
                "ota_receive.cu": EXACT, "cms_draws.cu": EXACT,
                "flash_attention.cu": (), "flash_attention_sm90.cu": ()}
SOURCES = tuple(SOURCE_FLAGS)
HEADERS = ("ota_common.cuh", "ota_ring.cuh")
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update(" ".join(SOURCE_FLAGS.get(name, ())).encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands in parallel; return their outputs, raise on any
    failure. Every process is waited for or killed before returning."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=BUILD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(c)}):\n{out}")
    return outs


def build() -> Path:
    """Build the shared library if it is not there yet; return its path.
    The compiler's report (registers, spills) is kept beside it as .log."""
    lib = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        logs = _run_all([[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS[s], "-c",
                          str(CSRC / s), "-o", o]
                         for s, o in zip(SOURCES, objs)])
        out = os.path.join(tmp, lib.name)
        logs += _run_all([[nvcc, "-shared", "-gencode", ARCH, "-o", out,
                           *objs]])
        Path(out + ".log").write_text("\n".join(logs))
        os.replace(out + ".log", lib.with_suffix(".log"))
        os.replace(out, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with every C entry point's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.repro_adaptive_update.argtypes = ([i] * 3 + [vp] * 9 + [ll] + [f] * 8
                                          + [vp, vp])
    lib.repro_adaptive_update.restype = i
    lib.repro_ota_channel.argtypes = ([i] + [vp] * 6 + [i, ll, f, f]
                                      + [f] * 6 + [i, vp])
    lib.repro_ota_channel.restype = i
    lib.repro_ota_transmit.argtypes = ([i] + [vp] * 7
                                       + [ctypes.c_ulonglong, i, ll, f, vp])
    lib.repro_ota_transmit.restype = i
    lib.repro_ota_transmit_stream.argtypes = ([vp] * 6
                                              + [i, ll, i, i, i, f, vp])
    lib.repro_ota_transmit_stream.restype = i
    lib.repro_ota_receive.argtypes = ([i, i] + [vp] * 8 + [i, ll, f]
                                      + [f] * 6 + [i, vp])
    lib.repro_ota_receive.restype = i
    lib.repro_ota_receive_blocks_per_sm.argtypes = [i, i]
    lib.repro_ota_receive_blocks_per_sm.restype = i
    lib.repro_cms_draws.argtypes = ([i] + [vp] * 5
                                    + [ctypes.c_ulonglong, f, f, f, vp, vp,
                                       ll, ll, vp])
    lib.repro_cms_draws.restype = i
    lib.repro_flash_attention.argtypes = [i] + [vp] * 4 + [i] * 8 + [f, vp]
    lib.repro_flash_attention.restype = i
    lib.repro_flash_attention_sm90.argtypes = [vp] * 4 + [i] * 8 + [f, vp]
    lib.repro_flash_attention_sm90.restype = i
    lib.repro_flash_attention_sm90_smem.argtypes = [i]
    lib.repro_flash_attention_sm90_smem.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = load_library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
