"""Bytes of one B2 launch (``ota_channel_kernel``), the f32 MAC: it
reads the rows of client gradients, the fading (a float a row), the
interference draws u and e, and writes the aggregate; float32 slabs of
``padded`` entries. The resident round sends every client as a row;
the streamed round sends its completed partial as one row."""


def rows(ctx) -> int:
    return 1 if ctx.traffic.get("client_chunk") else ctx.traffic["clients"]


def bytes_per_launch(ctx) -> int:
    r = rows(ctx)
    return 4 * (r * ctx.padded + 3 * ctx.padded + r)
