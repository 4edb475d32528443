"""Bytes of one B1 launch (``adaptive_update_kernel``), the fused
Adam-OTA update: it reads g, delta, nu and w and writes delta, nu and w,
each a float32 slab of ``padded`` entries."""


def bytes_per_launch(ctx) -> int:
    return 7 * 4 * ctx.padded
