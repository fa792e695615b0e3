"""1 - the workers' wall on tasks (worker.task) over workers x the window's
wall, in %. From the program's own tracing (lib/program.py), on in
traced runs; nothing where the run has no traced pass."""
from lib import program


def read(ctx):
    return program.READERS["workers.idle_share"](ctx)
