"""Core ADOTA-FL library of the port: slabs (``slab``), channel configs
and transforms (``channel``), the draws seam (``draws``), server
optimizers (``adaptive``), resident state (``slab_state``), the MAC
(``ota``), the streamed client axis (``stream``) and the round (``fl``).

Import from the submodules. This package file imports nothing when it
is imported, so the kernels can import ``core.channel`` without a
cycle; the names ``repro.core`` exports of its stream module resolve
here on first use (``from repro_torch.core import streamed_round_parts``).
"""

_STREAM = ("StreamParts", "client_weight_array", "participation_mask",
           "round_participation", "streamed_round_parts")

__all__ = list(_STREAM)


def __getattr__(name):
    if name in _STREAM:
        # repro-lint: lazy-import (cycle: core.stream -> kernels -> core)
        from repro_torch.core import stream
        return getattr(stream, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
