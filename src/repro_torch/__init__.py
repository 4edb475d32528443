"""PyTorch / CUDA port of the ADOTA-FL simulator (``repro``).

The package mirrors ``repro``'s module layout and names. It imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``. Its entry
points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; the kernel wrappers launch hand-written CUDA kernels on
CUDA tensors and run their plain PyTorch versions on CPU tensors.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
