"""Seconds of set-up in Mapper._ensure_dev_index: CUDA context, kernel
library, the device index built on the card or uploaded, the first
launch (the harness's clock)."""


def read(ctx):
    return ctx["setup"]["device_s"]
