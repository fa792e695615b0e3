"""The seed collector threads' CPU (read, pack, dispatch, collect) over the
window's wall, in %. From the program's own tracing (lib/program.py), on
in traced runs; nothing where the run has no traced pass."""
from lib import program


def read(ctx):
    return program.READERS["pipeline.collector_cpu_share"](ctx)
