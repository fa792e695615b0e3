"""Share of the window's seedable reads (200 < length <= 131,072) that
the pipeline handed to the workers with device seeds
(PipeCounters.shipped_seeded summed over the window's files), in %."""


def read(ctx):
    if not ctx["eligible"]:
        return None
    return 100.0 * ctx["shipped_seeded"] / ctx["eligible"]
