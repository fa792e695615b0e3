"""The donor (gen/donor.py): its SVs' count, sizes, types and places, and
the lift of a read's donor source back to the reference; and a traffic
without a donor makes the files of the donor-less path."""
import hashlib
import os

import numpy as np
import pytest

import bench_tiny
from gen import donor as DN
from gen import genome as GG
from gen import reads as GR
from lib import cellrun, fasta

SPEC = {"per_mb": 20.0,
        "size": {"law": "log-uniform", "min": 50, "max": 10000},
        "shares": {"del": 0.43, "ins": 0.47, "inv": 0.05, "dup": 0.05},
        "zygosity": "homozygous", "min_gap": 5000, "clear": 2000,
        "source": "a test's", "assumed": ["per_mb", "shares.inv"]}


@pytest.fixture(scope="module")
def human():
    spec = bench_tiny.cell("human_chr21.clr")["config"]["genome"]
    g, mask = GG.make(np.random.default_rng(11), spec)
    return g, mask


def _donor(human, seed=12, spec=SPEC):
    g, mask = human
    return DN.make(np.random.default_rng(seed), g, mask, spec)


def test_count_sizes_and_types(human):
    g, _ = human
    d = _donor(human)
    n = round(SPEC["per_mb"] * int((g != 4).sum()) / 1e6)
    assert len(d.svs) == n
    sizes = sorted(sv.size for sv in d.svs)
    assert SPEC["size"]["min"] <= sizes[0] and sizes[-1] <= SPEC["size"]["max"]
    # log-uniform: the median size near the geometric mean of the range
    assert np.median(sizes) == pytest.approx(
        np.sqrt(SPEC["size"]["min"] * SPEC["size"]["max"]), rel=0.15)
    kinds = [sv.kind for sv in d.svs]
    for k, share in SPEC["shares"].items():
        assert abs(kinds.count(k) - share * n) <= 1, k
    # every seed: the same multiset of (type, size)
    e = _donor(human, seed=13)
    assert sorted((sv.kind, sv.size) for sv in d.svs) == sorted(
        (sv.kind, sv.size) for sv in e.svs)
    assert [sv.ref for sv in d.svs] != [sv.ref for sv in e.svs]


def test_places_keep_apart_from_each_other_n_and_mask(human):
    g, mask = human
    d = _donor(human)
    bad = (g == 4) | mask
    ends = []
    for sv in d.svs:
        ext = 0 if sv.kind == "ins" else sv.size
        lo, hi = sv.ref - SPEC["clear"], sv.ref + ext + SPEC["clear"]
        assert lo >= 0 and not bad[lo:hi].any(), sv
        ends.append((sv.ref, sv.ref + ext))
    for (_, e0), (s1, _) in zip(ends, ends[1:]):
        assert s1 - e0 >= SPEC["min_gap"]
    # the donor's N are the reference's, all of them
    assert int((d.seq == 4).sum()) == int((g == 4).sum())
    inserted = sum(sv.size for sv in d.svs if sv.kind == "ins")
    deleted = sum(sv.size for sv in d.svs if sv.kind == "del")
    copied = sum(sv.size for sv in d.svs if sv.kind == "dup")
    assert len(d.seq) == len(g) + inserted - deleted + copied


def test_each_sv_as_applied(human):
    """The donor bases around each SV are the reference's with the SV
    applied: gone, novel, reverse-complemented or copied twice."""
    g, _ = human
    d = _donor(human)
    for sv in d.svs:
        p, L = sv.ref, sv.size
        before = d.seq[sv.d0 - 500: sv.d0]
        if sv.kind == "dup":
            assert np.array_equal(before, g[p - 500: p])
            assert np.array_equal(d.seq[sv.d0: sv.d1],
                                  np.concatenate([g[p: p + L]] * 2))
            assert np.array_equal(d.seq[sv.d1: sv.d1 + 500],
                                  g[p + L: p + L + 500])
            continue
        assert np.array_equal(before, g[p - 500: p]), sv
        after = g[p: p + 500] if sv.kind == "ins" else g[p + L: p + L + 500]
        assert np.array_equal(d.seq[sv.d1: sv.d1 + 500], after), sv
        if sv.kind == "inv":
            assert np.array_equal(d.seq[sv.d0: sv.d1], 3 - g[p: p + L][::-1])
        if sv.kind == "ins":
            assert sv.d1 - sv.d0 == L
            assert d.lift(sv.d0, sv.d1) == []


def test_error_free_reads_lift_to_the_reference(human):
    """Each read's error-free source is the reference's segments, each on
    its strand, with the SV applied: the novel bases of an insertion are
    the only ones no segment accounts for; the truth is the longest
    segment, on the read's strand against it."""
    g, mask = human
    d = _donor(human)
    t = dict(bench_tiny.cell("human_chr21.clr")["traffic"],
             errors={"sub": 0, "ins": 0, "del": 0})
    reads, truth = GR.make_file(np.random.default_rng(14), d, t, 300, mask)
    mcum = np.concatenate([[0], np.cumsum(mask)])
    n_split = 0
    for r, row in zip(reads, truth.tolist()):
        s0, s1, rev, uniq, d0, d1, src_rev = row
        src = d.seq[d0:d1]
        assert np.array_equal(r, 3 - src[::-1] if src_rev else src)
        segs = d.lift(d0, d1)
        parts = [3 - g[a:b][::-1] if sr else g[a:b] for a, b, sr in segs]
        novel = sum(max(0, min(d1, sv.d1) - max(d0, sv.d0))
                    for sv in d.svs if sv.kind == "ins")
        assert sum(b - a for a, b, _ in segs) == (d1 - d0) - novel
        if novel == 0:
            assert np.array_equal(np.concatenate(parts), src)
        n_split += len(segs) > 1
        if not segs:
            assert (s0, s1, uniq) == (-1, -1, 0)
            continue
        a, b, sr = max(segs, key=lambda x: x[1] - x[0])
        assert (s0, s1, rev) == (a, b, src_rev ^ sr)
        assert uniq == int(all(mcum[y] == mcum[x] for x, y, _ in segs))
    assert n_split > 0


def test_no_svs_lift_to_themselves(human):
    g, mask = human
    d = _donor(human, spec=dict(SPEC, per_mb=0.0))
    assert d.svs == [] and np.array_equal(d.seq, g)
    assert d.lift(1000, 5000) == [(1000, 5000, 0)]


def _digest(d):
    h = hashlib.sha256()
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _donor_less_file(rng, genome, traffic, n, mask=None):
    """The generator as it was before donors, frozen here as the oracle:
    reads drawn straight from the genome, truth (n, 4)."""
    lens = rng.permutation(GR.quantile_lengths(traffic["length"], n))
    starts = GR.draw_starts(rng, genome, lens)
    rev = np.zeros(n, dtype=bool)
    rev[rng.permutation(n)[: int(round(n * traffic["reverse_share"]))]] = True
    src = np.concatenate([genome[s: s + k]
                          for s, k in zip(starts.tolist(), lens.tolist())])
    e = traffic["errors"]
    out, ends = GR.add_errors(rng, src, e["sub"], e["ins"], e["del"])
    hi = ends[np.cumsum(lens) - 1]
    lo = np.concatenate([[0], hi[:-1]])
    reads = [(3 - out[a:z][::-1]) if r else out[a:z]
             for a, z, r in zip(lo.tolist(), hi.tolist(), rev.tolist())]
    if mask is None:
        unique = np.ones(n, dtype=np.int64)
    else:
        mcum = np.concatenate([[0], np.cumsum(mask)])
        unique = (mcum[starts + lens] - mcum[starts] == 0).astype(np.int64)
    return reads, np.stack([starts, starts + lens, rev.astype(np.int64),
                            unique], axis=1)


@pytest.mark.parametrize("name", ["ecoli_k12.clr", "human_chr21.hifi"])
def test_without_a_donor_the_donor_less_files(tmp_path, name):
    """make_data of a traffic with no donor draws from the identity donor
    and writes the bytes, and the truth, of the generator before donors;
    each read's source is its own truth."""
    c = bench_tiny.cell(name)
    seed = 2**40 + 5
    (tmp_path / "a").mkdir()
    *_, files, donor = cellrun.make_data(c, seed, str(tmp_path / "a"))
    assert donor.svs == [] and len(donor.p_d0) == 1
    b = tmp_path / "b"
    b.mkdir()
    rng = np.random.default_rng(seed)
    g, mask = GG.make(rng, c["config"]["genome"])
    fasta.write_genome(str(b / "genome.fa"), c["config"]["genome"]["id"], g)
    for fi in range(int(c["traffic"]["files"])):
        reads, truth = _donor_less_file(rng, g, c["traffic"],
                                        int(c["traffic"]["file_reads"]), mask)
        fasta.write_reads(str(b / f"reads{fi}.fa"),
                          [f"f{fi}r{i}" for i in range(len(reads))], reads)
        got = files[fi][2]
        assert np.array_equal(got[:, :4], truth)
        assert np.array_equal(got[:, 4:], truth[:, :3])
    warm = _donor_less_file(rng, g, c["traffic"], GR.WARMUP_READS)[0]
    fasta.write_reads(str(b / "warmup.fa"),
                      [f"w{i}" for i in range(len(warm))], warm)
    assert _digest(str(tmp_path / "a")) == _digest(str(b))


def test_a_donor_changes_the_reads_not_the_genome(tmp_path):
    c = bench_tiny.cell("human_chr21.clr")
    seed = 2**40 + 6
    for sub, tr in (("a", c["traffic"]),
                    ("b", dict(c["traffic"], donor=dict(SPEC)))):
        (tmp_path / sub).mkdir()
        cellrun.make_data(dict(c, traffic=tr), seed, str(tmp_path / sub))
    ga, gb = ((tmp_path / s / "genome.fa").read_bytes() for s in "ab")
    ra, rb = ((tmp_path / s / "reads0.fa").read_bytes() for s in "ab")
    assert ga == gb and ra != rb


def test_donor_spec_states_every_key():
    assert DN.spec_of({}) is None
    assert DN.spec_of({"donor": SPEC}) == SPEC
    for key in DN.KEYS:
        with pytest.raises(ValueError):
            DN.spec_of({"donor": {k: v for k, v in SPEC.items() if k != key}})
    bad = [dict(SPEC, extra=1),
           dict(SPEC, size={"min": 50, "max": 10000}),
           dict(SPEC, size=dict(SPEC["size"], law="gamma")),
           dict(SPEC, shares={"del": 0.5, "ins": 0.5}),
           dict(SPEC, shares=dict(SPEC["shares"], cnv=0.0)),
           dict(SPEC, zygosity="heterozygous"),
           dict(SPEC, assumed=["size.mean"])]
    for b in bad:
        with pytest.raises(ValueError):
            DN.spec_of({"donor": b})
