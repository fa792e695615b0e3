"""The harness's spans and the reading of the profiler's trace.

Spans are the benchmark's own: wrappers it puts, in a traced run, around
the program's functions (name, thread, start and end in perf_counter
nanoseconds). The profiler's device events (kernels and copies) are
placed on the same clock through one marker event recorded at a known
perf_counter time. From them: each kernel's busy time by name, the union
of the device's busy intervals, and the idle gaps, each named by the
innermost harness span open at its middle.
"""
from __future__ import annotations

import functools
import threading
import time
from collections import defaultdict

SYNC = "bench.sync"


class Spans:
    def __init__(self):
        self.items = []  # (name, thread ident, t0 ns, t1 ns)
        self.on = True
        self.profiling = False

    def add(self, name, t0, t1):
        if self.on:
            self.items.append((name, threading.get_ident(), t0, t1))

    def wrap(self, obj, attr: str, name: str, after=None):
        """Replace obj.attr by a wrapper that records a span around each
        call; after(args, result) is called after each call. Returns an
        undo function."""
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def wrapped(*a, **k):
            t0 = time.perf_counter_ns()
            out = fn(*a, **k)
            self.add(name, t0, time.perf_counter_ns())
            if after is not None:
                after(a, out)
            return out

        setattr(obj, attr, wrapped)
        return lambda: setattr(obj, attr, fn)

    def iterate(self, it, name: str):
        """Yield its items, recording a span around each step of it (the
        time spent producing the item)."""
        if not self.on:
            yield from it
            return
        it = iter(it)
        while True:
            t0 = time.perf_counter_ns()
            try:
                x = next(it)
            except StopIteration:
                self.add(name, t0, time.perf_counter_ns())
                return
            self.add(name, t0, time.perf_counter_ns())
            yield x

    def total_s(self, names) -> float:
        return sum(t1 - t0 for n, _, t0, t1 in self.items if n in names) / 1e9

    def count(self, name) -> int:
        return sum(1 for n, *_ in self.items if n == name)


def device_events(events, sync_perf_ns: int):
    """[(name, start s, end s)] of the device events of a profiler's
    events() (objects with .name, .device_type, .time_range.start/.end in
    microseconds), on the perf_counter clock in seconds; the SYNC marker
    event (a CPU event) ties the two clocks."""
    from torch.autograd import DeviceType

    off = None
    for e in events:
        if e.name == SYNC:
            off = sync_perf_ns / 1e3 - e.time_range.start
            break
    if off is None:
        return []
    return [(e.name, (e.time_range.start + off) / 1e6,
             (e.time_range.end + off) / 1e6)
            for e in events if e.device_type == DeviceType.CUDA]


def union(intervals):
    """Sorted, merged [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_seconds(dev, t0: float, t1: float) -> float:
    return sum(min(e, t1) - max(s, t0)
               for s, e in union([(s, e) for _, s, e in dev])
               if min(e, t1) > max(s, t0))


def kernel_seconds(dev, key: str):
    """(summed seconds, event count) of the device events whose name
    holds key."""
    ks = [(e - s) for n, s, e in dev if key in n]
    return sum(ks), len(ks)


def top_ops(dev, n: int = 10):
    """[[name, seconds]] of the device operations that took most time,
    summed by name (the first 64 characters)."""
    acc = defaultdict(float)
    for name, s, e in dev:
        acc[name[:64]] += e - s
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


WAITS = ("drain.wait",)


def idle_gaps(dev, spans, t0: float, t1: float, n: int = 10):
    """[[label, seconds]] of the device's idle time in [t0, t1], summed by
    the innermost harness span open at each gap's middle (the latest
    started of the spans other than the main thread's wait, WAITS; that
    wait where it is the only one open), most first; "none" where no span
    was open."""
    busy = [(max(s, t0), min(e, t1)) for s, e in
            union([(s, e) for _, s, e in dev]) if min(e, t1) > max(s, t0)]
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    sp = [(nm, a / 1e9, b / 1e9) for nm, _, a, b in spans]
    acc = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [(nm in WAITS, -s0, nm) for nm, s0, s1 in sp
                 if s0 <= mid < s1]
        acc[min(open_)[2] if open_ else "none"] += b - a
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
