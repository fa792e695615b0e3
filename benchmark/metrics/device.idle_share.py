"""Share of the profiled file's wall time in which no kernel or copy ran
on the device, in %: 1 - (union of the device intervals) / wall."""
from lib import trace


def read(ctx):
    t0, t1 = ctx["trace_window"]
    if not ctx["device_events"] or t1 <= t0:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(ctx["device_events"], t0, t1)
                    / (t1 - t0))
