"""The share of the window in which no operation ran on the card: the
window less the union of the device operations' intervals."""


def read(t):
    if t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
