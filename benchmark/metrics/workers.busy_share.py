"""The workers' CPU seconds over the window's wall time times the host's
cores, in %: how far the pool saturates the host."""


def read(ctx):
    if not ctx["workers"]:
        return None  # the -b 0 serial loop forks no pool
    return 100.0 * ctx["workers_cpu_s"] / (ctx["window_s"] * ctx["cores"])
