"""Tiny cells for the benchmark's CPU tests: the real cells' files with
the genome, the pool and -t cut so that a run on the CPU (the kernels'
plain PyTorch versions) takes seconds."""
from __future__ import annotations

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from lib import spec  # noqa: E402


def cell(name: str = "ecoli_k12.clr", reads: int = 24) -> dict:
    c = spec.cell(name)
    g = c["config"]["genome"]
    if g["model"] == "human_like":
        g.update(length=1_500_000,
                 n_runs=[[0, 150000], [700000, 20000], [1490000, 10000]])
        g["alpha_satellite"].update(after_n_run=1, array_bp=40000)
        g["segdup"]["pairs"] = 2
        g["l1"]["copies"] = 80
        g["alu"]["copies"] = 400
    else:
        g["length"] = 300_000
    c["traffic"]["file_reads"] = reads
    c["traffic"]["length"]["max"] = min(c["traffic"]["length"]["max"], 20000)
    c["config"]["flags"]["threads"] = 2
    return c
