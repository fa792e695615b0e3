"""Seconds of set-up in the warm-up pass: a file of the traffic's first
1,024 reads mapped once through PipelineMapper.run, so that the workers'
engines, the seeding tiers and the index pages are in use before the
window (the harness's clock)."""


def read(ctx):
    return ctx["setup"]["warmup_s"]
