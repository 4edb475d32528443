"""B3b's share of its roofline: the least time its launches in the
window could take, their bytes (``bench/counts/b3b.py``) at the card's
peak bandwidth, over the device time the trace gives ``ota_transmit_stream_kernel``.
None where the window launched none."""


def read(t):
    seconds, launches = t.kernel("ota_transmit_stream_kernel")
    bw = t.ctx.peak("hbm_bytes_per_s")
    if not launches or not seconds or bw is None:
        return None
    bound = launches * t.ctx.counts("b3b").bytes_per_launch(t.ctx) / bw
    return 100.0 * bound / seconds
