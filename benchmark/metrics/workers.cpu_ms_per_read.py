"""CPU milliseconds the pool's worker processes spent a read emitted
(native residual: apx, gaps, SAM), from /proc/<pid>/stat across the
window."""


def read(ctx):
    if not ctx["workers"]:
        return None  # the -b 0 serial loop forks no pool
    if not ctx["reads"]:
        return None
    return 1e3 * ctx["workers_cpu_s"] / ctx["reads"]
