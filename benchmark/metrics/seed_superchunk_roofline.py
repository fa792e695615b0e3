"""The seed kernel's (ops/csrc/seed_superchunk.cu) share of its roofline
over the profiled file, in %: the least time of a launch's work
(lib/roofline.seed_bound on the launch's read lengths, tier and probe
counts) over the kernel's device time a launch, both as means over the
file (the profiler may drop an event of a long window). Nothing where the
trace holds no launch of the kernel."""
from lib import roofline, trace


def read(ctx):
    busy, n_ev = trace.kernel_seconds(ctx["device_events"], "seed_superchunk")
    launches = ctx["launches"]
    if not n_ev or not launches or busy <= 0:
        return None
    least = sum(roofline.seed_bound(lens, m_out, probed)["bound_s"]
                for lens, m_out, probed in launches)
    return 100.0 * (least / len(launches)) / (busy / n_ev)
