"""Reference genomes of the benchmark's deployments, made from a seed.

Codes: 0-3 for A, C, G, T and 4 for N. A configuration file's "genome"
object names its model in "model" and gives that model's parameters;
`make(rng, spec)` dispatches on the name, so a new model is a new
function here and a new name in a configuration file. It returns the
codes and a mask of the positions whose sequence has a near-identical
copy elsewhere (a read drawn from them has no one true place).

Every size of a model (element lengths, truncations, divergences) is
drawn from one fixed generator, SIZES, so that every seed makes a genome
of the same make-up; the seed draws the bases, the order and the places.
The bacterial REP family's consensus is fixed too (rep_consensus): its
500 copies fill the index's heaviest buckets, so a consensus drawn from
the seed changed how many reads overflow the device's seeding tiers, on
the reference's count from 0.7 to 10 % of CLR reads and from 21 to 43 %
of ONT reads between seeds.

bacterial   the port's utils.simdata.make_genomic_genome (7 rrn-like
            operons at 99.5 % identity, IS1/IS3-like families, REP-like
            palindromes, AT-rich islands, homopolymers and microsatellites
            in unique sequence), frozen, without its assembly-gap N runs
            (the finished genome it stands for has none) and with the
            REP consensus fixed; rrn and IS copies are masked.
human_like  unique sequence at the spec's base composition, with N runs at
            the spec's places, an alpha-satellite higher-order array after
            one of them, and interspersed Alu-like, L1-like and
            segmental-duplication copies at the spec's coverage and
            divergence, placed in the free sequence by _place; the array
            and both sides of each duplication are masked.
"""
from __future__ import annotations

import numpy as np

U8 = np.uint8
SIZES_SEED = 20260917


def revcomp(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    out[out < 4] = 3 - out[out < 4]
    return out


def mutate(rng, seg: np.ndarray, rate: float) -> np.ndarray:
    """A copy of seg with about rate of its bases substituted."""
    out = seg.copy()
    n = rng.binomial(len(out), rate)
    pos = rng.integers(0, len(out), n)
    out[pos] = (out[pos] + rng.integers(1, 4, n)) % 4
    return out


def rep_consensus() -> np.ndarray:
    """The bacterial REP-like 40-base palindrome, the same for every
    seed."""
    half = np.random.default_rng(SIZES_SEED + 1).integers(0, 4, 20)
    return np.concatenate([half.astype(U8), revcomp(half.astype(U8))])


def bacterial(rng, spec: dict):
    length = int(spec["length"])
    sz = np.random.default_rng(SIZES_SEED)
    rrn = rng.integers(0, 4, 5000).astype(U8)
    is1 = rng.integers(0, 4, 768).astype(U8)
    is3 = rng.integers(0, 4, 1258).astype(U8)
    rep = rep_consensus()
    kinds = (["rrn"] * 7 + ["is1"] * 8 + ["is3"] * 5 + ["rep"] * 500
             + ["at"] * 10 + ["homo"] * 40 + ["micro"] * 40)
    size = {"at": (2000, 8000), "homo": (8, 60), "micro": (10, 120)}
    features = [(k, int(sz.integers(*size[k])) if k in size else 0)
                for k in kinds]
    per_gap = max(1, (length - 120000) // (len(features) + 1))
    gaps = sz.integers(per_gap // 2, per_gap + per_gap // 2, len(features))
    order = rng.permutation(len(features))
    parts, masked = [], []
    total = 0
    for ul, f in zip(gaps.tolist(), order.tolist()):
        kind, n = features[f]
        parts.append(rng.integers(0, 4, ul).astype(U8))
        masked.append(False)
        total += ul
        if kind in ("rrn", "is1", "is3"):
            seg = mutate(rng, {"rrn": rrn, "is1": is1, "is3": is3}[kind],
                         0.005 if kind == "rrn" else 0.01)
        elif kind == "rep":
            seg = mutate(rng, rep, 0.02)
        elif kind == "at":
            seg = rng.choice(np.array([0, 3], dtype=U8), n).astype(U8)
        elif kind == "homo":
            seg = np.full(n, int(rng.integers(0, 4)), dtype=U8)
        else:  # microsatellite
            seg = np.tile(rng.integers(0, 4, 2).astype(U8), n)
        parts.append(seg)
        masked.append(kind in ("rrn", "is1", "is3"))
        total += len(seg)
        if total >= length:
            break
    if total < length:
        parts.append(rng.integers(0, 4, length - total).astype(U8))
        masked.append(False)
    mask = np.repeat(np.array(masked), [len(p) for p in parts])
    return np.concatenate(parts)[:length], mask[:length]


def _family(rng, sz, consensus: np.ndarray, n: int, div_lo: float,
            div_hi: float, trunc: dict | None):
    """n copies of a consensus, each at a divergence drawn from
    [div_lo, div_hi]; with `trunc`, copies are 5'-truncated: a share
    trunc["full_share"] is whole, the rest keep a 3' part whose length is
    drawn log-uniformly from [trunc["min"], len(consensus)]. Each copy on
    either strand. Sizes from sz, bases from rng. Returns a list of
    arrays."""
    L = len(consensus)
    if trunc:
        full = sz.random(n) < trunc["full_share"]
        keep = np.exp(sz.uniform(np.log(trunc["min"]), np.log(L), n))
        lens = np.where(full, L, keep.astype(np.int64))
    else:
        lens = np.full(n, L, dtype=np.int64)
    divs = sz.uniform(div_lo, div_hi, n)
    rev = sz.random(n) < 0.5
    # all copies mutated in one pass
    src = np.concatenate([consensus[L - k:] for k in lens])
    rate = np.repeat(divs, lens)
    hit = rng.random(len(src)) < rate
    src[hit] = (src[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    out, o = [], 0
    for k, r in zip(lens.tolist(), rev.tolist()):
        seg = src[o: o + k]
        out.append(revcomp(seg) if r else seg)
        o += k
    return out


def _place(rng, genome: np.ndarray, free: np.ndarray, copies: list):
    """Write copies into genome's free sequence (free[i]: position i is
    unique sequence, not yet N, an array or a copy), at random places, in
    random order, none overlapping another: the free positions are laid
    end to end, each copy takes a run of them from a sorted uniform draw,
    and the taken ones are marked. A copy whose run spans an element placed
    before it is interrupted by that element, as repeats in genomes are.
    Returns the positions written."""
    lens = np.array([len(c) for c in copies], dtype=np.int64)
    idx = np.flatnonzero(free)
    order = rng.permutation(len(copies))
    ln = lens[order]
    x = np.sort(rng.integers(0, len(idx) - int(ln.sum()) + 1, len(copies)))
    pos = np.repeat(x, ln) + np.arange(int(ln.sum()))
    at = idx[pos]
    genome[at] = np.concatenate([copies[i] for i in order.tolist()])
    free[at] = False
    return at


def human_like(rng, spec: dict):
    length = int(spec["length"])
    sz = np.random.default_rng(SIZES_SEED)
    gc = float(spec["gc"])
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    genome = rng.choice(4, length, p=p).astype(U8)
    free = np.ones(length, dtype=bool)
    mask = np.zeros(length, dtype=bool)
    for s, n in spec["n_runs"]:
        genome[s: s + n] = 4
        free[s: s + n] = False
    # alpha satellite: a higher-order unit of `monomers_per_hor` monomers
    # (each diverged from one consensus), repeated in tandem at
    # hor_divergence, filling array_bp right after the N run it follows
    sat = spec["alpha_satellite"]
    mono = rng.choice(4, sat["monomer_bp"], p=p).astype(U8)
    hor = np.concatenate([mutate(rng, mono, sat["monomer_divergence"])
                          for _ in range(sat["monomers_per_hor"])])
    reps = -(-sat["array_bp"] // len(hor))
    arr = np.concatenate([mutate(rng, hor, sat["hor_divergence"])
                          for _ in range(reps)])[: sat["array_bp"]]
    s0, n0 = spec["n_runs"][sat["after_n_run"]]
    genome[s0 + n0: s0 + n0 + len(arr)] = arr
    free[s0 + n0: s0 + n0 + len(arr)] = False
    mask[s0 + n0: s0 + n0 + len(arr)] = True
    # segmental duplications first (the longest copies), then L1, then Alu
    sd = spec["segdup"]
    seg_lens = np.exp(sz.uniform(np.log(sd["min_bp"]), np.log(sd["max_bp"]),
                                 sd["pairs"])).astype(np.int64)
    divs = sz.uniform(sd["div_lo"], sd["div_hi"], sd["pairs"])
    revs = sz.random(sd["pairs"]) < 0.5
    dups = []
    for k, dv, r in zip(seg_lens.tolist(), divs.tolist(), revs.tolist()):
        while True:
            s = int(rng.integers(0, length - k))
            if free[s: s + k].all():
                break
        free[s: s + k] = False
        mask[s: s + k] = True
        dup = mutate(rng, genome[s: s + k], dv)
        dups.append(revcomp(dup) if r else dup)
    mask[_place(rng, genome, free, dups)] = True
    for name in ("l1", "alu"):
        fam = spec[name]
        cons = rng.choice(4, fam["consensus_bp"], p=p).astype(U8)
        _place(rng, genome, free,
               _family(rng, sz, cons, fam["copies"], fam["div_lo"],
                       fam["div_hi"], fam.get("truncation")))
    return genome, mask


MODELS = {"bacterial": bacterial, "human_like": human_like}


def make(rng, spec: dict):
    """(codes, mask of positions with a near-identical copy elsewhere) of
    a configuration's "genome" object."""
    return MODELS[spec["model"]](rng, spec)
