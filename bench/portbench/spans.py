"""The program's spans in a traced window: the card's time by the phase
of the round that launched its work, and its idle time by the phase the
host was in meanwhile.

``repro_torch.spans.span`` marks the round's phases as
``record_function`` ranges named ``repro.<phase>`` (``repro.feed``,
``repro.round``, ``repro.mac``, ...). This reduces the kineto events of
a window that ``trace.WINDOW`` spans, the events ``trace.summarize``
reduces, and reads nothing else:

* each device operation is charged to the innermost span open on the
  host when the runtime call that issued it was made: the ``cu*`` host
  event with the operation's correlation id. Spans are matched by time
  on the host clock, whatever thread made the call: on CUDA the autograd
  engine issues ``vmap(grad)``'s backward from a thread of its own while
  the caller waits inside ``repro.clients``;
* each stretch of the window in which no device operation ran is split
  across the innermost span open on the host in each part of it;
* the whole window is split so too: the host's time by span, which
  shows where the host waited (a blocking copy or read back holds it in
  ``repro.h2d`` or ``repro.readback`` while the card drains its queue).

Time that falls in no span (or an operation whose launch call the trace
lacks) is charged to ``NONE``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench.trace import WINDOW, _union

PREFIX = "repro."
NONE = "none"
# the device-time metrics, each one span's time
DEVICE = {"draws_ms_per_round": "draws",
          "broadcast_ms_per_round": "broadcast",
          "clients_ms_per_round": "clients",
          "mac_ms_per_round": "mac",
          "round_metrics_ms_per_round": "metrics",
          "server_ms_per_round": "server"}
# the idle metrics, each the card's idle time while the host was in one
# of these spans
IDLE = {"idle_feed_ms_per_round": ("feed", "draws", "h2d"),
        "idle_issue_ms_per_round": ("round", "broadcast", "clients", "mac",
                                    "metrics", "server"),
        "idle_between_ms_per_round": ("readback", NONE)}


class SpanTable:
    """Seconds of device time (``device_s``), of idle time (``idle_s``)
    and of host time (``host_s``) in the window, by span name without
    the prefix."""

    def __init__(self, rounds: int, window_s: float,
                 device_s: Dict[str, float], idle_s: Dict[str, float],
                 host_s: Dict[str, float], n_ops: int, unmatched: int,
                 host_syncs: Optional[int] = None):
        self.rounds = rounds
        self.window_s = window_s
        self.device_s = device_s
        self.idle_s = idle_s
        self.host_s = host_s
        self.n_ops = n_ops
        self.unmatched = unmatched
        self.host_syncs = host_syncs

    def metrics(self) -> Dict[str, Optional[float]]:
        """The per-round readings under their metric names; None each
        where the window ran no device operation."""
        names = [*DEVICE, *IDLE, "host_syncs_per_round"]
        if not self.rounds or not self.n_ops:
            return dict.fromkeys(names)
        ms = 1e3 / self.rounds
        out = {k: ms * self.device_s.get(s, 0.0) for k, s in DEVICE.items()}
        out.update({k: ms * sum(self.idle_s.get(s, 0.0) for s in group)
                    for k, group in IDLE.items()})
        out["host_syncs_per_round"] = (
            None if self.host_syncs is None
            else self.host_syncs / self.rounds)
        return out


def _innermost(spans: List[Tuple[int, int, str]]
               ) -> Tuple[List[int], List[Optional[str]]]:
    """The host timeline as steps: from ``starts[k]`` on, the innermost
    open span is ``names[k]`` (None: no span). Innermost is the open span
    that started last."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    starts: List[int] = []
    names: List[Optional[str]] = []
    open_: List[int] = []
    for t, opening, i in marks:
        if opening:
            open_.append(i)
        else:
            open_.remove(i)
        top = spans[open_[-1]][2] if open_ else None
        if starts and starts[-1] == t:
            names[-1] = top
        elif not names or names[-1] != top:
            starts.append(t)
            names.append(top)
    return starts, names


def _charge(starts: List[int], names: List[Optional[str]], a: int, b: int,
            into: Dict[str, float]) -> None:
    """Add the stretch [a, b) of the host timeline to ``into``, step by
    step, each part under the innermost span open in it."""
    k = bisect.bisect_right(starts, a) - 1
    while a < b:
        nxt = starts[k + 1] if k + 1 < len(starts) else b
        stop = min(b, nxt)
        into[(names[k] if k >= 0 else None) or NONE] += (stop - a) * 1e-9
        a, k = stop, k + 1


def reduce_spans(events, rounds: int,
                 host_syncs: Optional[int] = None) -> SpanTable:
    """The span table of the window that the host annotation ``WINDOW``
    spans; ``host_syncs`` is ``repro_torch.spans.host_syncs``' change
    over the window, where read."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name() == WINDOW
             and e.device_type() == DeviceType.CPU]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} window marks")
    t0 = marks[0].start_ns()
    t1 = t0 + marks[0].duration_ns()
    spans: List[Tuple[int, int, str]] = []
    launched: Dict[int, int] = {}
    dev: List[Tuple[int, int, int]] = []
    for e in events:
        name = e.name()
        start = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            end = start + e.duration_ns()
            if e.is_user_annotation() or end <= t0 or start >= t1:
                continue
            dev.append((max(start, t0), min(end, t1), e.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((start, start + e.duration_ns(),
                          name[len(PREFIX):]))
        elif name.startswith("cu"):
            launched[e.correlation_id()] = start
    starts, names = _innermost(spans)

    def label(t: int) -> str:
        k = bisect.bisect_right(starts, t) - 1
        return (names[k] if k >= 0 else None) or NONE

    device_s: Dict[str, float] = defaultdict(float)
    unmatched = 0
    for s, e, corr in dev:
        at = launched.get(corr)
        if at is None:
            unmatched += 1
        device_s[NONE if at is None else label(at)] += (e - s) * 1e-9
    dev.sort()
    _, merged = _union([(s, e) for s, e, _ in dev])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    idle_s: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        _charge(starts, names, a, b, idle_s)
    host_s: Dict[str, float] = defaultdict(float)
    _charge(starts, names, t0, t1, host_s)
    return SpanTable(rounds, (t1 - t0) * 1e-9, dict(device_s), dict(idle_s),
                     dict(host_s), len(dev), unmatched, host_syncs)
