"""Whether the reads that span a donor's structural variants show them in
the SAM the timed path wrote: the check behind sv_signal_missed_pct.

An SV counts when at least MIN_READS reads span it, each with FLANK bases
of donor sequence on both sides of the SV's donor interval (gen/donor.py
SV.d0, SV.d1); it is found when at least one of those reads shows it in
its primary or supplementary records (secondary and unmapped records are
not read). With p the SV's reference start, L its size and
tol = max(TOL_MIN, TOL_SHARE * L), a read shows
  a deletion     by a D of at least L / 2 starting within tol of p, or by
                 two records on one strand, one ending within tol of p and
                 another starting L (within tol) after that end;
  an insertion   by an I of at least L / 2 within tol of p, or a soft or
                 hard clip of at least L / 2 at a record's end that lies
                 within tol of p;
  an inversion   by a record on the other strand from the read's flanks
                 lying inside [p - tol, p + L + tol);
  a duplication  by two records on one strand, one ending within tol of
                 p + L and another starting within tol of p, back in the
                 copied interval; or by an I of at least L / 2 within tol
                 of p or of p + L, as a short tandem copy is aligned.
The tolerances:
  FLANK 1,000    an aligner places a read across a breakpoint only from
                 anchors on both sides; CLR reads at ~10 % error need some
                 hundreds of bases to anchor, so a read ending closer has
                 nothing to show the SV with;
  MIN_READS 3    an SV caller's least support (pbsv, SVIM and cuteSV ask
                 for 2-3 reads at low depth); fewer is not a call to miss;
  L / 2          an aligner may split one long gap into several, or let
                 part of it into the neighbouring match at a high error
                 rate; half of it is still the event's, and no sequencing
                 error makes a gap that long;
  TOL_MIN 100,   breakpoints move by tens of bases where the gap is placed
  TOL_SHARE 0.1  differently in the sequence around it (and the errors of
                 CLR reads make that likelier), and the ends of a split
                 move with the event's size.
Plain Python and numpy: nothing of the program.
"""
from __future__ import annotations

import re

import numpy as np

FLANK = 1000
MIN_READS = 3
TOL_MIN = 100
TOL_SHARE = 0.1
_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")


def tol(size: int) -> int:
    return max(TOL_MIN, int(TOL_SHARE * size))


class Rec:
    """One mapped record: strand, reference [start, end), and its events
    (op, reference position, length) for D, I and the clips (S or H, at
    the start or the end)."""
    __slots__ = ("rev", "start", "end", "events")

    def __init__(self, flag: int, pos: int, cigar: str):
        self.rev = bool(flag & 0x10)
        self.start = at = pos
        self.events = []
        for n, op in _CIGAR.findall(cigar):
            n = int(n)
            if op in "M=XN":
                at += n
            elif op == "D":
                self.events.append(("D", at, n))
                at += n
            elif op == "I":
                self.events.append(("I", at, n))
            elif op in "SH":
                self.events.append(("C", at, n))
        self.end = at


def records(sam_text: str, want: set) -> dict:
    """qname -> [Rec] of its primary and supplementary mapped records, for
    the qnames in want."""
    out: dict = {}
    for line in sam_text.split("\n"):
        if not line or line[0] == "@":
            continue
        f = line.split("\t", 6)
        if f[0] not in want:
            continue
        flag = int(f[1])
        if flag & 0x104:    # unmapped or secondary
            continue
        out.setdefault(f[0], []).append(Rec(flag, int(f[3]) - 1, f[5]))
    return out


def _near(a: int, b: int, t: int) -> bool:
    return abs(a - b) <= t


def shows(sv, recs: list, read_rev: bool) -> bool:
    """Whether a read's records show the SV (sv.kind, sv.ref, sv.size)."""
    p, L = sv.ref, sv.size
    t, half = tol(L), L / 2
    ev = [e for r in recs for e in r.events]
    if sv.kind == "del":
        if any(op == "D" and n >= half and _near(x, p, t) for op, x, n in ev):
            return True
        return any(a.rev == b.rev and _near(a.end, p, t)
                   and _near(b.start - a.end, L, t)
                   for a in recs for b in recs if a is not b)
    if sv.kind == "ins":
        return any(op in "IC" and n >= half and _near(x, p, t)
                   for op, x, n in ev)
    if sv.kind == "inv":
        return any(r.rev != read_rev and r.start >= p - t
                   and r.end <= p + L + t for r in recs)
    if sv.kind == "dup":
        if any(op == "I" and n >= half and (_near(x, p, t) or
                                            _near(x, p + L, t))
               for op, x, n in ev):
            return True
        return any(a.rev == b.rev and _near(a.end, p + L, t)
                   and _near(b.start, p, t)
                   for a in recs for b in recs if a is not b)
    raise ValueError(f"SV kind {sv.kind!r}")


def check(svs: list, sam_text: str, names: list, src: np.ndarray,
          rev: np.ndarray) -> list:
    """[(sv, spanning reads, found)] for the SVs at least MIN_READS reads
    span. names, src (n, 2: donor start, end) and rev (n) describe the
    reads whose first SAM records sam_text holds."""
    src = np.asarray(src)
    spans = [np.flatnonzero((src[:, 0] <= sv.d0 - FLANK)
                            & (src[:, 1] >= sv.d1 + FLANK)) for sv in svs]
    want = {names[i] for s in spans if len(s) >= MIN_READS for i in s}
    recs = records(sam_text, want)
    out = []
    for sv, s in zip(svs, spans):
        if len(s) < MIN_READS:
            continue
        found = any(shows(sv, recs.get(names[i], []), bool(rev[i]))
                    for i in s.tolist())
        out.append((sv, len(s), found))
    return out


def missed_pct(result: list) -> float:
    """The share of the counted SVs that no spanning read shows, in %;
    100 where no SV is counted, since nothing was shown."""
    if not result:
        return 100.0
    return 100.0 * sum(not f for _, _, f in result) / len(result)
