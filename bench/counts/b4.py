"""Bytes of one B4 launch (``ota_receive_kernel``), the int8 wire's
receive: it reads the int8 payload, its per-128-block scales and the
interference draws u and e, and writes the float32 aggregate."""


def bytes_per_launch(ctx) -> int:
    d = ctx.padded
    return d + 4 * (d // 128) + 2 * 4 * d + 4 * d
