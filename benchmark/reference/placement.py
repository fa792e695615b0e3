"""Each read's placement, read from the SAM or APF text that the timed
path produced, held against the origin its generator recorded.

A read is placed when its primary SAM record (flag & 0x904 == 0) lies on
its strand (flag 0x10 for a reverse-complemented read) and its reference
interval, POS and the CIGAR's M, D, N, = and X lengths, overlaps the read's
source interval; in APF, when its first block header's strand icon and
genome interval do. A read with no such record is not placed.
"""
from __future__ import annotations

import re

import numpy as np

_REF_OPS = re.compile(r"(\d+)[MDN=X]")


def sam_primaries(text: str) -> dict:
    """qname -> (reverse, start, end) of its first primary mapped record,
    0-based, half-open; and the count of primary records per qname under
    the key None."""
    out: dict = {}
    n_primary: dict = {}
    for line in text.split("\n"):
        if not line or line[0] == "@":
            continue
        f = line.split("\t", 6)
        flag = int(f[1])
        if flag & 0x904:
            continue
        n_primary[f[0]] = n_primary.get(f[0], 0) + 1
        if f[0] in out:
            continue
        pos = int(f[3]) - 1
        span = sum(int(m) for m in _REF_OPS.findall(f[5]))
        out[f[0]] = (bool(flag & 0x10), pos, pos + span)
    out[None] = n_primary
    return out


def apf_first_blocks(text: str) -> dict:
    """read id -> (reverse, genome start, genome end) of its first block."""
    out: dict = {}
    for line in text.split("\n"):
        if not line.startswith("@ "):
            continue
        f = line.split()
        if f[1] in out:
            continue
        out[f[1]] = (f[5] == "-", int(f[8]), int(f[9]))
    return out


def misplaced(places: dict, names: list, truth: np.ndarray) -> int:
    """Reads of names (truth rows start, end, reverse, ...) not placed on
    their origin."""
    bad = 0
    for name, (t0, t1, rev, *_) in zip(names, truth.tolist()):
        got = places.get(name)
        if got is None or got[0] != bool(rev) or not (got[1] < t1
                                                      and got[2] > t0):
            bad += 1
    return bad
