"""The whole round's share of the card's bf16 dense peak: the model
FLOPs the rounds' clients need (``bench/counts/<family>.py``: forward
and backward, no recompute) over the traced window."""


def read(t):
    peak = t.ctx.peak("bf16_flops_per_s")
    if not t.rounds or t.window_s <= 0 or peak is None:
        return None
    flops = t.ctx.counts(t.ctx.model["family"]).flops_per_round(
        t.ctx.model, t.ctx.traffic)
    return 100.0 * flops * t.rounds / t.window_s / peak
