"""The feeder's wall waiting for a task's device seeds (feeder.wait_seeds)
over the window's wall, in %. From the program's own tracing
(lib/program.py), on in traced runs; nothing where the run has no traced
pass."""
from lib import program


def read(ctx):
    return program.READERS["pipeline.seed_wait_share"](ctx)
