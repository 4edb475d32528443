"""Device policy of the port: the device decides, nothing else does.

The JAX package picks Pallas interpret mode from the platform
(``repro.kernels.interpret``). The port has no such switch. Every entry
point takes a ``device=`` argument: ``None`` means ``"cuda"``, and a
missing card is an error, not a reason to run somewhere else. The CPU
is used only when the caller asks for it (``device="cpu"``, as the
tests do); there the kernel wrappers run their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch.profiler import ProfilerActivity, profile

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent.
    A bare ``cuda`` resolves to the current card's index, so devices
    compare equal to the devices of the tensors made on them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default. Pass device='cpu' to run the plain PyTorch versions "
            "of the kernels on the CPU.")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_PROFILER_READY = []


def warm_up_profiler() -> None:
    """Run one throwaway ``torch.profiler`` session (CPU and CUDA
    activities) around a near-empty kernel, once a process, before the
    process's first capture that counts kernels. A process's first CUPTI
    capture can drop its first kernel record, even in the active step of
    a schedule with a warm-up step; a session before it sets the tracing
    up. Later calls do nothing."""
    if _PROFILER_READY:
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    _PROFILER_READY.append(True)
