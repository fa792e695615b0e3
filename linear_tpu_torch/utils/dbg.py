"""Stage-trace debug stream (set LINEAR_TPU_DBG=<path> to enable).

Used by the host engine to dump per-stage u64 arrays in the same text
format as the instrumented reference binary; tools/diffstage.py diffs the
two traces to localize a divergence to a stage.  Disabled (no-op) unless
the environment variable is set.
"""
from __future__ import annotations

import os

M64 = (1 << 64) - 1

_DBG_FILE = None
if os.environ.get("LINEAR_TPU_DBG"):
    _DBG_FILE = open(os.environ["LINEAR_TPU_DBG"], "w")


def enabled() -> bool:
    return _DBG_FILE is not None


def dbg(tag: str, vals) -> None:
    if _DBG_FILE is not None:
        _DBG_FILE.write(
            tag + " " + str(len(vals)) + "".join(" %d" % (int(v) & M64) for v in vals) + "\n"
        )
        _DBG_FILE.flush()


def dbg_s(tag: str, vals) -> None:
    """Signed dump (feature scripts; the instrumented reference prints
    these with %lld)."""
    if _DBG_FILE is not None:
        _DBG_FILE.write(
            tag + " " + str(len(vals)) + "".join(" %d" % int(v) for v in vals) + "\n"
        )
        _DBG_FILE.flush()
