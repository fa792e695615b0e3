"""Readers of what the program records about itself when its tracing is on
(linear_tpu_torch.parallel.pipeline: PipelineMapper.trace, PipeCounters
with its spans, thread CPU and the workers' native phase times).

The readers take ctx["program"]: the PipeCounters of each of the
window's passes, traced from the window's start, as lib/cellrun.py gives
them in a traced run; ctx["window_s"] and ctx["workers"] are the window's
wall and pool size.
Each reader returns None where there is nothing to read: no traced pass,
or no pool task (the -b 0 serial loop). READERS maps the per-layer
metrics' names to them; idle_gaps_program names the device's idle time by
the program's spans, as lib/trace.idle_gaps does by the harness's.

Spans are on time.perf_counter_ns (CLOCK_MONOTONIC), the clock of the
harness's spans and of lib/trace.device_events, in every process.
"""
from __future__ import annotations

from collections import defaultdict


def _passes(ctx):
    return ctx.get("program") or []


def _spans(ctx, name):
    return [sp for c in _passes(ctx) for sp in c.spans if sp.name == name]


def _tasks(ctx) -> bool:
    return bool(_spans(ctx, "feeder.put"))


def _cpu_share(ctx, key):
    if not _tasks(ctx):
        return None
    return 100.0 * sum(getattr(c, key) for c in _passes(ctx)) / (
        ctx["window_s"] * 1e9)


def feeder_cpu_share(ctx):
    """The feeder thread's CPU over the window's wall, in %."""
    return _cpu_share(ctx, "feeder_cpu_ns")


def collector_cpu_share(ctx):
    """The seed collector threads' CPU (read, pack, dispatch, collect)
    over the window's wall, in %."""
    return _cpu_share(ctx, "collector_cpu_ns")


def drain_cpu_share(ctx):
    """The in-order drain's CPU, between the consumer's turns, over the
    window's wall, in %."""
    return _cpu_share(ctx, "drain_cpu_ns")


def seed_wait_share(ctx):
    """The feeder's wall waiting for a task's device seeds
    (feeder.wait_seeds) over the window's wall, in %."""
    if not _tasks(ctx):
        return None
    return 100.0 * sum(sp.t1 - sp.t0 for sp in _spans(
        ctx, "feeder.wait_seeds")) / (ctx["window_s"] * 1e9)


def task_queue_ms(ctx):
    """Mean over tasks of a worker's start on the task (worker.task) after
    the feeder queued it (the end of its feeder.put), in ms: the task
    queue, the drain's submit and the pool's task handler."""
    waits = []
    for c in _passes(ctx):
        put = {sp.task: sp.t1 for sp in c.spans if sp.name == "feeder.put"}
        waits += [sp.t0 - put[sp.task] for sp in c.spans
                  if sp.name == "worker.task" and sp.task in put]
    return sum(waits) / len(waits) / 1e6 if waits else None


def workers_idle_share(ctx):
    """1 - the workers' wall on tasks (worker.task) over workers x the
    window's wall, in %."""
    busy = _spans(ctx, "worker.task")
    if not busy or not ctx.get("workers"):
        return None
    return 100.0 * (1.0 - sum(sp.t1 - sp.t0 for sp in busy) / (
        ctx["workers"] * ctx["window_s"] * 1e9))


def _worker_ms_per_read(ctx, stage):
    ps = [c for c in _passes(ctx) if c.worker_ns]
    reads = sum(c.emitted for c in ps)
    if not reads:
        return None
    return sum(c.worker_ns.get(stage, 0) for c in ps) / 1e6 / reads


def host_seed_ms_per_read(ctx):
    """The workers' native host seeding (query_anchors, le_apx_stage_ns)
    a read emitted, in ms."""
    return _worker_ms_per_read(ctx, "apx.host_seed")


def gap_ms_per_read(ctx):
    """The workers' native gap phase (le_stage_ns) a read emitted, in ms."""
    return _worker_ms_per_read(ctx, "gap")


READERS = {
    "pipeline.feeder_cpu_share": feeder_cpu_share,
    "pipeline.collector_cpu_share": collector_cpu_share,
    "pipeline.drain_cpu_share": drain_cpu_share,
    "pipeline.seed_wait_share": seed_wait_share,
    "pipeline.task_queue_ms": task_queue_ms,
    "workers.idle_share": workers_idle_share,
    "workers.host_seed_ms_per_read": host_seed_ms_per_read,
    "workers.gap_ms_per_read": gap_ms_per_read,
}

# the threads whose spans name an idle gap, in order of precedence
ROLES = ("collector", "feeder", "drain")


def idle_gaps_program(dev, spans, t0: float, t1: float, n: int = 10):
    """[[label, seconds]] of the device's idle time in [t0, t1] (seconds on
    the perf_counter clock), summed by the program span open at each gap's
    middle: the collector thread's innermost (the latest started), else the
    feeder's, else the drain's; "none" where none is open. dev: [(name,
    start s, end s)] device events; spans: the traced pass's spans. Most
    first."""
    from lib.trace import union

    busy = [(max(s, t0), min(e, t1)) for s, e in
            union([(s, e) for _, s, e in dev]) if min(e, t1) > max(s, t0)]
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    by_role = defaultdict(list)
    for sp in spans:
        role = sp.name.split(".")[0]
        if role in ROLES:
            by_role[role].append((sp.t0 / 1e9, sp.t1 / 1e9, sp.name))
    acc = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        label = "none"
        for role in ROLES:
            open_ = [(s0, nm) for s0, s1, nm in by_role[role]
                     if s0 <= mid < s1]
            if open_:
                label = max(open_)[1]
                break
        acc[label] += b - a
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
