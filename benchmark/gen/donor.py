"""A donor genome: the reference with structural variants (SVs) applied,
made from a seed, and the map from the donor's sequence back to the
reference's, so that a read drawn from the donor has an exact truth.

A traffic file may carry a "donor" object. It states every one of KEYS,
and nothing falls back on a value of this module's:
  per_mb     SVs per Mb of N-free reference sequence;
  size       {"law": "log-uniform", "min", "max"}: SV sizes, log-uniform
             between min and max (the only law made);
  shares     {"del", "ins", "inv", "dup"}: the types' shares of the SVs
             (deletion, insertion of novel sequence, inversion, tandem
             duplication);
  zygosity   "homozygous" (the only one made): the donor is one haplotype
             carrying every SV;
  min_gap    bases between the reference intervals of two SVs;
  clear      bases between an SV and an N, or a masked position (a copy
             that has a near-identical twin elsewhere);
  source     the published set the values follow, in words;
  assumed    the values that no source bears out, each named by its key
             ("per_mb", "size.law", "shares.inv", ...).

As read lengths are (gen/reads.py), sizes and types are fixed by the
spec and not by the seed: sizes are the quantiles (i + 1/2) / n of the
log-uniform distribution, types are dealt to the sizes in sorted order so
that each type spans the whole range, and every seed makes the same
multiset of (type, size). The seed draws which SV goes where, and the
places: one SV in each of n equal strata of the reference's eligible
sequence (positions `clear` away from N and from the mask, laid end to
end), at a uniform place inside its stratum that keeps `min_gap` to the
strata beside it. The inserted sequence is drawn at the genome's base
composition.

The donor is a list of pieces, each a run of donor bases that is a run
of reference bases (forward, or reverse-complemented for an inversion)
or novel sequence; `lift` turns a donor interval into reference segments.
A traffic with no donor draws its reads from `identity(genome)`: the
reference as one piece, whose lift is the source itself.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TYPES = ("del", "ins", "inv", "dup")
KEYS = ("per_mb", "size", "shares", "zygosity", "min_gap", "clear",
        "source", "assumed")
SIZE_KEYS = ("law", "min", "max")


@dataclass
class SV:
    kind: str      # one of TYPES
    ref: int       # reference start (ins: the base before which it goes)
    size: int      # bases deleted, inserted, inverted or duplicated
    d0: int        # donor interval a read must span to show the SV:
    d1: int        #   del the junction (d0 == d1), ins the inserted bases,
                   #   inv the inverted bases, dup both copies


@dataclass
class Donor:
    seq: np.ndarray      # donor codes (0-3, 4 for N)
    svs: list            # [SV], in reference order
    p_d0: np.ndarray     # piece i: donor [p_d0[i], p_d0[i] + p_len[i])
    p_len: np.ndarray
    p_r0: np.ndarray     # reference start, -1 for novel sequence
    p_rev: np.ndarray    # 1 where it is the reference reverse-complemented

    def lift(self, s: int, e: int) -> list:
        """[(ref start, ref end, rev)] of donor [s, e) in donor order;
        novel sequence is left out. A reverse piece's part [a, b) of its
        donor bases is the reference's [r0 + len - b, r0 + len - a)."""
        out = []
        i = int(np.searchsorted(self.p_d0, s, side="right")) - 1
        while i < len(self.p_d0) and self.p_d0[i] < e:
            d0, n = int(self.p_d0[i]), int(self.p_len[i])
            a, b = max(s, d0) - d0, min(e, d0 + n) - d0
            r0 = int(self.p_r0[i])
            if b > a and r0 >= 0:
                if self.p_rev[i]:
                    out.append((r0 + n - b, r0 + n - a, 1))
                else:
                    out.append((r0 + a, r0 + b, 0))
            i += 1
        return out


def spec_of(traffic: dict) -> dict | None:
    """The traffic's donor spec, checked, or None without a donor. Raises
    ValueError on a key left out or unknown, a law or zygosity that is
    not made here, or an `assumed` entry that names no stated value."""
    d = traffic.get("donor")
    if d is None:
        return None
    for where, got, want in (("donor", d, KEYS),
                             ("donor size", d.get("size", {}), SIZE_KEYS),
                             ("donor shares", d.get("shares", {}), TYPES)):
        if set(got) != set(want):
            raise ValueError(f"{where}: keys {sorted(got)}, not {sorted(want)}")
    if d["size"]["law"] != "log-uniform":
        raise ValueError(f"donor size law {d['size']['law']!r}: only "
                         "log-uniform is made")
    if d["zygosity"] != "homozygous":
        raise ValueError(f"donor zygosity {d['zygosity']!r}: only homozygous "
                         "is made")
    stated = {k for k in KEYS if k not in ("source", "assumed")}
    stated |= {f"size.{k}" for k in SIZE_KEYS} | {f"shares.{k}" for k in TYPES}
    bad = sorted(set(d["assumed"]) - stated)
    if bad:
        raise ValueError(f"donor assumed: {bad} name no stated value")
    return d


def identity(genome: np.ndarray) -> Donor:
    """The donor with no SV: the reference itself, one forward piece."""
    one = np.zeros(1, dtype=np.int64)
    return Donor(seq=genome, svs=[], p_d0=one, p_len=one + len(genome),
                 p_r0=one.copy(), p_rev=one.copy())


def kinds_and_sizes(spec: dict, n: int):
    """The n SVs' (types, sizes), sizes ascending: log-uniform quantiles;
    each type's count by largest remainder of the shares, its SVs spread
    evenly over the sorted sizes."""
    lo, hi = np.log(spec["size"]["min"]), np.log(spec["size"]["max"])
    sizes = np.rint(np.exp(lo + (np.arange(n) + 0.5) / n * (hi - lo)))
    shares = np.array([float(spec["shares"][k]) for k in TYPES])
    want = shares / shares.sum() * n
    count = np.floor(want).astype(np.int64)
    count[np.argsort(count - want)[: n - int(count.sum())]] += 1
    # type k's SVs take the sizes at its own quantiles (j + 1/2) / count
    slots = sorted(((j + 0.5) / c, k) for k, c in enumerate(count.tolist())
                   for j in range(c))
    kinds = [TYPES[k] for _, k in slots]
    return kinds, sizes.astype(np.int64)


def make(rng, genome: np.ndarray, mask: np.ndarray, spec: dict) -> Donor:
    """The donor of `genome` (codes, with `mask`) under `spec` (spec_of)."""
    G = len(genome)
    bad = (genome == 4) | mask
    n_free = int((genome != 4).sum())
    n = int(round(spec["per_mb"] * n_free / 1e6))
    kinds, sizes = kinds_and_sizes(spec, n)
    clear, gap = int(spec["clear"]), int(spec["min_gap"])
    ext = int(spec["size"]["max"])
    # eligible starts: [p - clear, p + ext + clear) holds no N and no mask
    bcum = np.concatenate([[0], np.cumsum(bad)])
    p = np.arange(clear, G - ext - clear)
    elig = p[bcum[p + ext + clear] - bcum[p - clear] == 0]
    W = len(elig) // max(n, 1)
    if n and W < gap + ext + 1:
        raise ValueError(f"{n} SVs do not fit {len(elig)} eligible bases "
                         f"at a gap of {gap}")
    order = rng.permutation(n)           # which SV goes to which stratum
    lo = np.arange(n) * W + gap // 2
    u = lo + (rng.random(n) * (W - gap - ext)).astype(np.int64)
    at = elig[u]
    svs = []
    ins_total = int(sum(int(sizes[i]) for i in order if kinds[i] == "ins"))
    acgt = np.bincount(genome[genome != 4], minlength=4)[:4]
    novel = rng.choice(4, ins_total, p=acgt / acgt.sum()).astype(np.uint8)
    # the donor, piece by piece in reference order
    pieces, parts = [], []     # (d0, len, r0, rev)
    d = r = 0
    used = 0

    def ref_piece(a, b, rev=0):
        nonlocal d
        if b > a:
            seg = genome[a:b]
            if rev:
                seg = 3 - seg[::-1]
            pieces.append((d, b - a, a, rev))
            parts.append(seg)
            d += b - a

    for k in range(n):
        i = int(order[k])
        kind, L, x = kinds[i], int(sizes[i]), int(at[k])
        ref_piece(r, x)
        if kind == "del":
            svs.append(SV(kind, x, L, d, d))
            r = x + L
        elif kind == "ins":
            seg = novel[used: used + L]
            used += L
            pieces.append((d, L, -1, 0))
            parts.append(seg)
            svs.append(SV(kind, x, L, d, d + L))
            d += L
            r = x
        elif kind == "inv":
            d_a = d
            ref_piece(x, x + L, 1)
            svs.append(SV(kind, x, L, d_a, d))
            r = x + L
        else:  # tandem duplication: [x, x + L) twice
            d_a = d
            ref_piece(x, x + L)
            ref_piece(x, x + L)
            svs.append(SV(kind, x, L, d_a, d))
            r = x + L
    ref_piece(r, G)
    pc = np.array(pieces, dtype=np.int64).reshape(-1, 4)
    return Donor(seq=np.concatenate(parts) if parts else genome[:0].copy(),
                 svs=svs, p_d0=pc[:, 0], p_len=pc[:, 1], p_r0=pc[:, 2],
                 p_rev=pc[:, 3])
