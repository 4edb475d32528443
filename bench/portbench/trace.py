"""The traced window: ``torch.profiler`` around the measured rounds, and
its reduction to what the per-layer readers take.

Device time comes from the profiler's device activities (kernels, copies
and fills), read from the kineto events directly (``prof.events()``
would build a tree of a million host events). The card's busy time is
the union of their intervals inside the window, not their sum. Launch
calls are the CUDA runtime and driver calls that start work on the card.
An idle gap between two device operations is put down to the host
operation that launched the one after it (the profiler links each
device operation to the innermost host op around its launch call).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
    "cuGraphLaunch"))
# The port's own kernels, B1-B4, by their entry names.
PORT_KERNELS = {
    "adaptive_update_kernel": "B1", "ota_channel_kernel": "B2",
    "ota_transmit_stream_kernel": "B3b", "ota_transmit_kernel": "B3c",
    "ota_receive_kernel": "B4"}
_BASE = re.compile(r"^([^(<\s]+)")


def base_name(name: str) -> str:
    """A device op's name without ``void``, anonymous namespaces,
    template arguments or parameters: ``void (anonymous
    namespace)::ota_channel_kernel(Args)`` -> ``ota_channel_kernel``."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:].lstrip()
    m = _BASE.match(s)
    return m.group(1) if m else name


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, the merged intervals) of sorted (start, end) pairs."""
    merged: List[Tuple[int, int]] = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


class TraceSummary:
    """What a traced window holds, for ``bench/metrics/<name>.py``."""

    def __init__(self, rounds: int, window_s: float, busy_s: float,
                 op_s: Dict[str, float], op_n: Dict[str, int],
                 launch_calls: int, gaps: Dict[str, float], ctx=None):
        self.rounds = rounds
        self.window_s = window_s
        self.busy_s = busy_s
        self.op_s = op_s
        self.op_n = op_n
        self.launch_calls = launch_calls
        self.gaps = gaps
        self.ctx = ctx

    def kernel(self, base: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels named ``base``."""
        return self.op_s.get(base, 0.0), self.op_n.get(base, 0)

    @property
    def device_s(self) -> float:
        return sum(self.op_s.values())

    @property
    def port_kernels_s(self) -> float:
        return sum(self.op_s.get(k, 0.0) for k in PORT_KERNELS)

    def breakdown(self) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


WINDOW = "portbench.window"
# the profiler's own host events, which share an op's correlation id
_KINETO_OWN = frozenset(("Activity Buffer Request",
                         "Runtime Triggered Module Loading",
                         "Lazy Function Loading", WINDOW))


def summarize(events, rounds: int, ctx=None) -> TraceSummary:
    """Reduce the kineto events of a traced window, which the host
    annotation ``WINDOW`` spans."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name() == WINDOW
             and e.device_type() == DeviceType.CPU]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} window marks")
    t0_ns = marks[0].start_ns()
    t1_ns = t0_ns + marks[0].duration_ns()
    dev: List[Tuple[int, int, str, int]] = []
    host_ops: Dict[int, str] = {}
    n_launch = 0
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or end <= t0_ns or start >= t1_ns:
                continue
            # linked: the host op whose launch call started this one
            dev.append((max(start, t0_ns), min(end, t1_ns), name,
                        e.linked_correlation_id()))
        elif name.startswith("cu"):
            if name in LAUNCH_CALLS and t0_ns <= start < t1_ns:
                n_launch += 1
        elif name not in _KINETO_OWN:
            host_ops.setdefault(e.correlation_id(), name)
    dev.sort()
    op_s: Dict[str, float] = defaultdict(float)
    op_n: Dict[str, int] = defaultdict(int)
    for s, e, name, _ in dev:
        b = base_name(name)
        op_s[b] += (e - s) * 1e-9
        op_n[b] += 1
    busy_ns, merged = _union([(s, e) for s, e, _, _ in dev])
    issuer = {}
    for s, _, _, linked in dev:
        issuer.setdefault(s, host_ops.get(linked))
    gaps: Dict[str, float] = defaultdict(float)
    edges = [(t0_ns, merged[0][0])] if merged else [(t0_ns, t1_ns)]
    edges += [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    if merged:
        edges.append((merged[-1][1], t1_ns))
    for a, b in edges:
        if b - a <= 0:
            continue
        if b >= t1_ns:
            label = "window end"
        else:
            op = issuer.get(b)
            label = f"host issuing {op}" if op else "host, outside any op"
        gaps[label] += (b - a) * 1e-9
    return TraceSummary(rounds, (t1_ns - t0_ns) * 1e-9, busy_ns * 1e-9,
                        dict(op_s), dict(op_n), n_launch, dict(gaps), ctx)


def traced_window(fn, ctx=None, cuda: bool = True
                  ) -> Tuple[object, TraceSummary]:
    """Run ``fn() -> (rounds, result)`` under the profiler, inside the
    ``WINDOW`` annotation, and return (result, summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            rounds, result = fn()
            if cuda:
                torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    return result, summarize(events, rounds, ctx)
