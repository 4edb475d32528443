"""Hand-written CUDA kernels of the port and their plain versions.

adaptive_update -- fused Delta/v/w server update (one pass)
ota_channel     -- fused fading reduction + CMS alpha-stable interference

Sources live in ``repro_torch/csrc``; ``build`` compiles them with nvcc
at first use. ``ref`` holds the plain PyTorch versions.
"""

from repro_torch.kernels.adaptive_update import adaptive_update_slab
from repro_torch.kernels.ota_channel import ota_channel_slab

__all__ = ["adaptive_update_slab", "ota_channel_slab"]
