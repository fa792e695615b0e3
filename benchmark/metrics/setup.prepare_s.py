"""Seconds of set-up in Mapper(genome) and PipelineMapper(...): genome
load, 2_48 features, host DIndex, the workers' fork (the harness's
clock)."""


def read(ctx):
    return ctx["setup"]["prepare_s"]
