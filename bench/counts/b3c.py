"""Bytes of one B3c launch (``ota_transmit_kernel``), the int8 wire's
transmit: it reads the client gradient rows, their fading, the rounding
uniforms and, with error feedback, the carried residual, and writes the
int8 payload, a float32 scale a 128-entry block and, with error
feedback, the fresh residual; float32 slabs of ``padded`` entries."""


def bytes_per_launch(ctx) -> int:
    tr, d = ctx.traffic, ctx.padded
    r = tr["clients"]
    ef = 2 * 4 * d if tr.get("error_feedback") else 0
    return 4 * r * d + 4 * r + 4 * d + ef + d + 4 * (d // 128)
