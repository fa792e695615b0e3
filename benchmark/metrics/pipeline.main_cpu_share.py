"""CPU seconds of the main process (all its threads: feeder, seed
collector, in-order drain, APF text; from /proc/self/stat) over the
window's wall time, in %; above 100 where threads run at once."""


def read(ctx):
    return 100.0 * ctx["main_cpu_s"] / ctx["window_s"]
