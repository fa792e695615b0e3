"""Milliseconds of host time a superchunk spends in the seeding calls of
the collector thread: pack_superchunk, dispatch_wire (pinned h2d, launch,
d2h) and collect_wire (wait, per-read anchors), from the harness's spans
over the window."""


def read(ctx):
    if not ctx["superchunks"]:
        return None
    return 1e3 * ctx["superchunk_span_s"] / ctx["superchunks"]
