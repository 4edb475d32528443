"""Hand-written CUDA kernels of the port and their plain versions.

adaptive_update -- fused Delta/v/w server update (one pass)
ota_channel     -- fused fading reduction + CMS alpha-stable interference,
                   the quantized wire's transmit / receive pair
flash_attention -- blocked causal / sliding-window GQA attention
cms_draws       -- the round's CMS inputs (u, e) in one launch, on the
                   generator's own Philox stream
ops             -- the public wrappers (fused_server_update,
                   fused_ota_aggregate, causal_flash_attention)

Sources live in ``repro_torch/csrc``; ``build`` compiles them with nvcc
at first use. ``ref`` holds the plain PyTorch versions.
"""

from repro_torch.kernels.adaptive_update import adaptive_update_slab
from repro_torch.kernels.ota_channel import ota_channel_slab

__all__ = ["adaptive_update_slab", "ota_channel_slab"]
