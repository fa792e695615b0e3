"""Seconds of set-up spent importing the port: its host modules before
the fork, torch and the ops modules after it (the harness's clock)."""


def read(ctx):
    return ctx["setup"]["import_s"]
