"""CPU seconds of processes, from the OS (/proc/<pid>/stat: utime and
stime of all the process's threads)."""
from __future__ import annotations

import os

TICK = os.sysconf("SC_CLK_TCK")


def parse_stat(text: str) -> float:
    """utime + stime in seconds of one /proc/<pid>/stat line."""
    fields = text[text.rindex(")") + 2:].split()
    # fields[0] is the state (field 3); utime and stime are fields 14, 15
    return (int(fields[11]) + int(fields[12])) / TICK


def cpu_seconds(pid: int, proc: str = "/proc") -> float:
    with open(os.path.join(proc, str(pid), "stat")) as f:
        return parse_stat(f.read())


def total(pids, proc: str = "/proc") -> float:
    return sum(cpu_seconds(p, proc) for p in pids)
