"""Read pools of a traffic mix, made from a seed, vectorised over the pool.

A traffic file gives:
  length   {"dist": "lognormal", "median", "sigma"} or
           {"dist": "normal", "mean", "sd"}, with "min" and "max" clips;
  errors   {"sub", "ins", "del"}: the error model of the port's
           utils.simdata.simulate_reads (bench.py's per-base loop), frozen
           here and drawn for all reads of a file at once: before each
           source base a geometric number of random bases is inserted
           (each with probability ins); the base itself is substituted by
           (b + 1) % 4, deleted or copied with probabilities sub, del and
           the rest, given it was not an insertion;
  reverse_share  the share of reads that are reverse-complemented;
  files, file_reads  the pool: files of distinct reads;
  donor    optional (gen/donor.py): the reads come from a donor genome,
           the reference with structural variants applied.
The set-up maps once a warm-up file of WARMUP_READS reads of the mix.

Lengths are the quantiles (i + 1/2) / n of the distribution, shuffled by
the seed: every seed maps the same multiset of lengths, so seeds change
where reads come from and not how much work they are. Sources lie wholly
in N-free sequence. Reads are drawn from a donor (gen/donor.py): the
traffic's, or without one the reference itself (donor.identity). Each
read's truth is (start, end, reverse, unique, source start, source end,
source reverse): the first four on the reference genome, 0-based and
half-open, the last three on the donor. A read's source lifts to one or
more reference segments: its truth is the longest of them, on the strand
the read has against it, and unique is 1 where no segment holds a
position of the genome's mask (no near-identical copy elsewhere); a read
of novel sequence alone has no segment, start = end = -1, and is not
unique. From the identity donor the source is its one segment.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

U8 = np.uint8
WARMUP_READS = 1024   # one superchunk


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    nd = NormalDist()
    z = np.array([nd.inv_cdf(float(v)) for v in q])
    if spec["dist"] == "lognormal":
        lens = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif spec["dist"] == "normal":
        lens = spec["mean"] + spec["sd"] * z
    else:
        raise ValueError(f"length dist {spec['dist']!r}")
    return np.clip(np.rint(lens), spec["min"], spec["max"]).astype(np.int64)


def draw_starts(rng, genome: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """A start for each length whose source [s, s + len) holds no N."""
    G = len(genome)
    ncum = np.concatenate([[0], np.cumsum(genome == 4)])
    starts = np.zeros(len(lens), dtype=np.int64)
    todo = np.arange(len(lens))
    for _ in range(1000):
        if not len(todo):
            return starts
        s = (rng.random(len(todo)) * (G - lens[todo] + 1)).astype(np.int64)
        ok = ncum[s + lens[todo]] - ncum[s] == 0
        starts[todo[ok]] = s[ok]
        todo = todo[~ok]
    raise RuntimeError("no N-free source for some reads")


def add_errors(rng, src: np.ndarray, sub: float, ins: float, dele: float):
    """The error model over one concatenated source; returns (out, ends):
    ends[i] is the end in out of source base i's output (insertions before
    it included), so a read of source bases [a, b) is out[ends[a-1]:ends[b-1]]."""
    n = len(src)
    n_ins = rng.geometric(1.0 - ins, n).astype(np.int64) - 1
    u = rng.random(n) * (1.0 - ins)
    base = np.where(u < sub, (src + 1) % 4, src).astype(U8)
    keep = ~((u >= sub) & (u < sub + dele))
    ends = np.cumsum(n_ins + keep)
    out = rng.integers(0, 4, int(ends[-1]), dtype=U8)
    out[ends[keep] - 1] = base[keep]
    return out, ends


def make_file(rng, donor, traffic: dict, n: int, mask=None):
    """One file of n reads drawn from donor.seq (gen/donor.py; the
    reference itself for donor.identity): (list of uint8 arrays, truth
    (n, 7) int64 of start, end, reverse, unique, source start, source end,
    source reverse)."""
    seq = donor.seq
    lens = rng.permutation(quantile_lengths(traffic["length"], n))
    starts = draw_starts(rng, seq, lens)
    rev = np.zeros(n, dtype=bool)
    rev[rng.permutation(n)[: int(round(n * traffic["reverse_share"]))]] = True
    src = np.concatenate([seq[s: s + k]
                          for s, k in zip(starts.tolist(), lens.tolist())])
    e = traffic["errors"]
    out, ends = add_errors(rng, src, e["sub"], e["ins"], e["del"])
    b = np.cumsum(lens)
    hi = ends[b - 1]
    lo = np.concatenate([[0], hi[:-1]])
    reads = []
    for a, z, r in zip(lo.tolist(), hi.tolist(), rev.tolist()):
        seg = out[a:z]
        reads.append((3 - seg[::-1]) if r else seg)
    mcum = (None if mask is None
            else np.concatenate([[0], np.cumsum(mask)]))
    ref, unique = lift_truth(donor, starts, lens, rev, mcum)
    truth = np.concatenate([ref, unique[:, None], starts[:, None],
                            (starts + lens)[:, None],
                            rev.astype(np.int64)[:, None]], axis=1)
    return reads, truth


def lift_truth(donor, starts, lens, rev, mcum):
    """(n, 3) reference start, end, reverse of each donor source's longest
    reference segment, and unique: every segment free of the mask (mcum,
    its running count; None: no mask)."""
    ref = np.full((len(starts), 3), -1, dtype=np.int64)
    unique = np.zeros(len(starts), dtype=np.int64)
    for i, (s, k, r) in enumerate(zip(starts.tolist(), lens.tolist(),
                                      rev.tolist())):
        segs = donor.lift(s, s + k)
        if not segs:
            ref[i, 2] = int(r)
            continue
        a, z, seg_rev = max(segs, key=lambda x: x[1] - x[0])
        ref[i] = (a, z, int(r) ^ seg_rev)
        unique[i] = int(mcum is None or all(
            mcum[z1] - mcum[a1] == 0 for a1, z1, _ in segs))
    return ref, unique


def make_pool(rng, donor, traffic: dict, mask=None):
    """The traffic's files: a list of (reads, truth)."""
    return [make_file(rng, donor, traffic, int(traffic["file_reads"]), mask)
            for _ in range(int(traffic["files"]))]


def make_warmup(rng, donor, traffic: dict):
    """The reads of the warm-up file."""
    return make_file(rng, donor, traffic, WARMUP_READS)[0]
