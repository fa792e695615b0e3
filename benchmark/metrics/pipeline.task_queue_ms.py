"""Mean over tasks of a worker's start on the task (worker.task) after the
feeder queued it (the end of its feeder.put), in ms: the task queue, the
drain's submit and the pool's task handler. From the program's own
tracing (lib/program.py), on in traced runs; nothing where the run has
no traced pass."""
from lib import program


def read(ctx):
    return program.READERS["pipeline.task_queue_ms"](ctx)
