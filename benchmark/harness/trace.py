"""Reduction of a ``torch.profiler`` trace to intervals, busy time and idle gaps.

The traced run profiles its first requests, each inside a harness span
(``bench.sweep``).  The traced window runs from the first span's start to
the last span's end.  Device time is the union of the device's kernel,
copy and set intervals, so that two streams that overlap count once; the
profiler's device-side copies of user annotations are not device work and
are left out.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Sequence, Tuple

SPAN = "bench.sweep"

Interval = Tuple[str, int, int]   # (name, start ns, end ns)


class Trace(NamedTuple):
    window: Tuple[int, int]       # the traced window, ns
    device: List[Interval]        # kernels, copies and sets on the device
    host: List[Interval]          # host events: ops, runtime calls, spans


def collect(prof) -> Trace:
    """The intervals of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, s, t = e.name(), int(e.start_ns()), int(e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((name, s, t))
        elif name == SPAN:
            spans.append((name, s, t))
        else:
            host.append((name, s, t))
    if not spans:
        return Trace((0, 0), device, host)
    return Trace((min(s for _, s, _ in spans), max(t for _, _, t in spans)),
                 device, host + spans)


def merged(intervals: Sequence[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint pairs."""
    out: List[List[int]] = []
    for _, s, t in sorted(intervals, key=lambda x: x[1]):
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(a, b) for a, b in out]


def busy_ns(intervals: Sequence[Interval], lo: int, hi: int) -> int:
    return sum(b - a for a, b in merged(intervals, lo, hi))


def gaps(intervals: Sequence[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle stretches of [lo, hi] between the merged intervals."""
    out, at = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's or op's name without ``void``, its argument list and
    template noise past ``width`` characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


def host_labels(host: Sequence[Interval], points: Sequence[int]) -> List[str]:
    """What the host was doing at each of the ascending ``points``: the
    harness span and the innermost host event around it (``(python)``
    where the host ran no profiled op, as in NumPy work)."""
    events = sorted(host, key=lambda x: x[1])
    active: List[Interval] = []
    out, k = [], 0
    for at in points:
        while k < len(events) and events[k][1] <= at:
            active.append(events[k])
            k += 1
        active = [e for e in active if e[2] > at]
        span = any(n == SPAN for n, _, _ in active)
        ops = [e for e in active if e[0] != SPAN]
        inner = short_name(max(ops, key=lambda e: e[1])[0], 64) if ops else "(python)"
        out.append(f"{SPAN} > {inner}" if span else f"outside {SPAN} > {inner}")
    return out


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time of
    the traced window by what the host was doing, each at most ``top``."""
    lo, hi = trace.window
    ops: Dict[str, float] = {}
    for name, s, t in trace.device:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + (t - s) * 1e-9
    idle: Dict[str, float] = {}
    stretches = gaps(trace.device, lo, hi)
    labels = host_labels(trace.host, [(a + b) // 2 for a, b in stretches])
    for (a, b), key in zip(stretches, labels):
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-9
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
