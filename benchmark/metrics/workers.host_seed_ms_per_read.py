"""The workers' native host seeding (query_anchors, le_apx_stage_ns) a read
emitted, in ms. From the program's own tracing (lib/program.py), on in
traced runs; nothing where the run has no traced pass."""
from lib import program


def read(ctx):
    return program.READERS["workers.host_seed_ms_per_read"](ctx)
