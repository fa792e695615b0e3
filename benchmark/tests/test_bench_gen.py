"""The generators: a seed makes the same bytes; lengths follow the traffic
file's distribution; error rates and N totals are as specified."""
import hashlib
import os

import numpy as np
import pytest

import bench_tiny
from gen import donor as DN
from gen import genome as GG
from gen import reads as GR
from lib import cellrun


def _digest(d):
    h = hashlib.sha256()
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["ecoli_k12.clr", "human_chr21.hifi"])
def test_same_seed_same_bytes(tmp_path, name):
    c = bench_tiny.cell(name)
    digests = []
    for sub, seed in (("a", 2**40 + 3), ("b", 2**40 + 3), ("c", 2**40 + 4)):
        d = tmp_path / sub
        d.mkdir()
        cellrun.make_data(c, seed, str(d))
        digests.append(_digest(str(d)))
    assert digests[0] == digests[1] != digests[2]


@pytest.mark.parametrize("traffic", ["clr", "hifi", "ont"])
def test_lengths_follow_the_traffic(traffic):
    tf = bench_tiny.spec._load(os.path.join(
        bench_tiny.BENCH, "traffic", traffic + ".json"))
    spec = tf["length"]
    lens = GR.quantile_lengths(spec, 20001)
    assert lens.min() >= spec["min"] and lens.max() <= spec["max"]
    mid = np.median(lens)
    want = spec["median"] if spec["dist"] == "lognormal" else spec["mean"]
    assert abs(mid - want) <= 1
    # every seed maps the same multiset of lengths, in another order
    g = np.random.default_rng(1).integers(0, 4, 2_000_000).astype(np.uint8)
    t = dict(tf, file_reads=50)
    d = DN.identity(g)
    r1, _ = GR.make_file(np.random.default_rng(1), d, t, 50)
    r2, _ = GR.make_file(np.random.default_rng(2), d, t, 50)
    _, tr1 = GR.make_file(np.random.default_rng(1), d, t, 50)
    _, tr2 = GR.make_file(np.random.default_rng(2), d, t, 50)
    assert sorted(tr1[:, 1] - tr1[:, 0]) == sorted(tr2[:, 1] - tr2[:, 0])


@pytest.mark.parametrize("rates", [(0.04, 0.03, 0.03), (0.003, 0.003, 0.003),
                                   (0.03, 0.02, 0.04)])
def test_error_rates(rates):
    """Each rate alone, then all three: the output length a source base."""
    sub, ins, dele = rates
    rng = np.random.default_rng(5)
    src = rng.integers(0, 4, 2_000_000).astype(np.uint8)
    out, _ = GR.add_errors(rng, src, 0.0, 0.0, dele)
    assert 1 - len(out) / len(src) == pytest.approx(dele, rel=0.05)
    out, _ = GR.add_errors(rng, src, 0.0, ins, 0.0)
    assert len(out) / len(src) - 1 == pytest.approx(ins / (1 - ins), rel=0.05)
    out, ends = GR.add_errors(rng, src, sub, ins, dele)
    want = ins / (1 - ins) + 1 - dele / (1 - ins)
    assert len(out) / len(src) == pytest.approx(want, rel=0.002)
    assert ends[-1] == len(out)


def test_substitution_share():
    rng = np.random.default_rng(9)
    src = rng.integers(0, 4, 1_000_000).astype(np.uint8)
    out, ends = GR.add_errors(rng, src, 0.04, 0.0, 0.0)
    assert len(out) == len(src)
    assert (out != src).mean() == pytest.approx(0.04, abs=0.002)
    assert ((out[out != src] - src[out != src]) % 4 == 1).all()


def test_human_like_n_total_and_repeats():
    c = bench_tiny.cell("human_chr21.clr")
    spec = c["config"]["genome"]
    g, mask = GG.make(np.random.default_rng(3), spec)
    assert len(g) == spec["length"] == len(mask)
    # the array and both sides of every duplication are masked, no N
    sat = spec["alpha_satellite"]
    s0, n0 = spec["n_runs"][sat["after_n_run"]]
    assert mask[s0 + n0: s0 + n0 + sat["array_bp"]].all()
    assert not (mask & (g == 4)).any()
    assert mask.sum() > sat["array_bp"] + 2 * spec["segdup"]["pairs"] * 5000
    assert int((g == 4).sum()) == sum(n for _, n in spec["n_runs"])
    for s, n in spec["n_runs"]:
        assert (g[s: s + n] == 4).all()


def test_full_chr21_n_total():
    spec = bench_tiny.spec.cell("human_chr21.clr")["config"]["genome"]
    assert spec["length"] - sum(n for _, n in spec["n_runs"]) == 40_088_623


def test_reads_avoid_n_and_record_truth():
    c = bench_tiny.cell("human_chr21.clr")
    g, mask = GG.make(np.random.default_rng(3), c["config"]["genome"])
    reads, truth = GR.make_file(np.random.default_rng(4), DN.identity(g),
                                dict(c["traffic"],
                                     errors={"sub": 0, "ins": 0, "del": 0}),
                                200, mask)
    n_rev = 0
    for r, (s, e, rev, uniq, *_) in zip(reads, truth.tolist()):
        assert uniq == int(not mask[s:e].any())
        src = g[s:e]
        assert (src != 4).all()
        want = (3 - src[::-1]) if rev else src
        assert np.array_equal(r, want)
        n_rev += rev
    assert n_rev == round(200 / 3)


@pytest.mark.parametrize("name", ["ecoli_k12.clr", "human_chr21.clr"])
def test_seeds_share_the_make_up(name):
    """Two seeds make genomes of the same element sizes: the same masked
    total, N total and length."""
    spec = bench_tiny.cell(name)["config"]["genome"]
    a, ma = GG.make(np.random.default_rng(1), spec)
    b, mb = GG.make(np.random.default_rng(2), spec)
    assert not np.array_equal(a, b)
    assert len(a) == len(b) and (a == 4).sum() == (b == 4).sum()
    assert abs(int(ma.sum()) - int(mb.sum())) <= 0.01 * ma.sum()


def test_bacterial_rep_family_is_every_seed_s():
    """The REP-like family has one consensus for every seed: the genomes
    of two seeds each hold a hundred or more unmutated copies of its
    first half, on either strand."""
    spec = bench_tiny.cell("ecoli_k12.clr")["config"]["genome"]
    spec["length"] = 2_000_000
    half = GG.rep_consensus()[:20]
    words = {half.tobytes(), GG.revcomp(half).tobytes()}
    for seed in (1, 2):
        g, _ = GG.make(np.random.default_rng(seed), spec)
        win = np.lib.stride_tricks.sliding_window_view(g, 20)
        n = sum(w.tobytes() in words for w in win[::1])
        assert n >= 100, (seed, n)
