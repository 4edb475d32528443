"""Bytes of one B3b launch (``ota_transmit_stream_kernel``), the
streamed uplink's accumulating transmit: it reads a chunk of client
gradient rows, their fading and the carried partial, and writes the
partial; float32 slabs of ``padded`` entries."""


def bytes_per_launch(ctx) -> int:
    r = ctx.traffic["client_chunk"]
    return 4 * (r * ctx.padded + 2 * ctx.padded + r)
