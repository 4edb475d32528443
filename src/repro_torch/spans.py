"""Named phases of the round for a profiler trace, and a count of the
host's waits on the card.

``span(name)`` marks a phase of the slab runner's round as a
``torch.profiler.record_function`` range named ``"repro." + name``. The
range lands in the profiler's event stream beside the runtime's launch
calls and the device's operations, on their clock, so a reduction of the
trace can charge each device operation to the innermost span open on the
host when its launch call was made, and each idle stretch of the card to
the span the host was in meanwhile. The spans:

    feed       ``run_rounds_slab``: the draws, the batches, their stack
    draws      ``TorchDraws``: the round's fading, CMS and rounding draws
    round      ``make_slab_round_runner``: one round, holding the next six
    h2d        the round's draws and batch moved to the device
    broadcast  the weight slab cast to the parameters the clients see
    clients    the clients' forward and backward (one span a chunk when
               the client axis is streamed)
    mac        the uplink: the gradient stack, the channel or the
               transmit and receive, the streamed chunks' folds
    metrics    the clean mean and the round's norm reductions
    server     the tracked alpha, the storage-dtype round trip, the update
    readback   ``run_rounds_slab``: the metrics read back to the host

A span exists only while a profiler records: otherwise ``span`` returns
one shared no-op context manager, at the cost of one flag check.

``host_syncs`` counts the points where the slab runner's host loop
waits for the card, always, as the kernels' launch counters count their
launches: each metric column that ``run_rounds_slab`` reads back to the
host, and each batch leaf the round copies from host memory to a card
(``torch.as_tensor(..., device=...)`` copies blocking, so the host waits
for the stream to drain first).
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

PREFIX = "repro."
host_syncs = 0
_OFF = contextlib.nullcontext()


def span(name: str):
    """The ``record_function`` range ``"repro." + name`` while a profiler
    records, else a shared no-op context manager."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return record_function(PREFIX + name)
