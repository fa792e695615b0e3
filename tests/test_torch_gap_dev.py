"""linear_tpu_torch.ops.gap_dev against linear_tpu.ops.gap_dev: the port's
batch_gap_anchors on the CPU (the plain version of the kernel) against
JAX's per item, None included, on tests/test_gap_dev.py's generator (seeds
1-3) and against the host oracle (the port's map.gap g_map_hs_kmer +
g_create_anchors); items that overflow the cap on a repeat-rich genome,
exceed m_out, have windows longer than g_max or r_max, or hold no hash
position; the tensor-level outputs (anchors, keys, count, overflow) against
JAX's _gap_anchors_kernel; the streams with N; and the dispatch. Every
comparison is exact (tolerance 0)."""
import numpy as np
import pytest
import torch

from linear_tpu.ops import gap_dev as JGD
from linear_tpu_torch.map import gap as G
from linear_tpu_torch.ops import gap_dev as GD


def oracle_anchors(genome, read, gs, ge, rs, re_, a_lo, a_hi):
    """The host path (tests/test_gap_dev.py:16-26, on the port's gap
    module): the two 9-mer streams, then g_create_anchors direction 0."""
    g_hs = []
    G.g_map_hs_kmer(genome, g_hs, gs, ge, 9, 5, 0)
    G.g_map_hs_kmer(read, g_hs, rs, re_, 9, 1, 1)
    anchors = []
    G.g_create_anchors(g_hs, anchors, 9, 0, a_lo, a_hi, len(read) - 1, 0, 0,
                       G.GapParms())
    return np.asarray(anchors, dtype=np.uint64)


def make_item(genome, read, gs, ge, rs, re_, a_lo=GD.LLMIN, a_hi=GD.LLMAX):
    g_stop = min(ge, len(genome) - 9)
    r_stop = min(re_, len(read) - 9)
    return {"gwin": genome[gs: g_stop + 8], "g_n": max(g_stop - gs, 0),
            "gpos0": gs, "rwin": read[rs: r_stop + 8],
            "r_n": max(r_stop - rs, 0), "rpos0": rs, "rvcp": len(read) - 1,
            "a_lo": a_lo, "a_hi": a_hi}


def _items(rng, genome, n, glen=(200, 3000), rlen=(200, 3000), at=None):
    """tests/test_gap_dev.py's items: a read overlapping its genome window
    at 8 % substitutions; every other item bounded to +-500 around the
    diagonal. Returns (items, their windows for the oracle)."""
    items, wins = [], []
    for t in range(n):
        gs = int(rng.integers(0, len(genome) - 10000)) if at is None else \
            at[t % len(at)]
        ge = gs + int(rng.integers(*glen))
        rs_pos = gs + int(rng.integers(-100, 100))
        rl = int(rng.integers(*rlen))
        read = genome[max(rs_pos, 0): max(rs_pos, 0) + rl + 500].copy()
        sub = rng.random(len(read)) < 0.08
        read[sub] = (read[sub] + 1) % 4
        a_lo, a_hi = (GD.LLMIN, GD.LLMAX) if t % 2 == 0 else (
            gs - rs_pos - 500, gs - rs_pos + 500)
        items.append(make_item(genome, read, gs, ge, 0, rl, a_lo, a_hi))
        wins.append((genome, read, gs, ge, 0, rl, a_lo, a_hi))
    return items, wins


def _same(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), k
        if g is not None:
            assert g.dtype == np.uint64 and np.array_equal(g, w), k


@pytest.mark.parametrize("limits", [(1024, 4096, 16, 2048),
                                    (640, 3072, 8, 1024)],
                         ids=["defaults", "narrow"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_batch_matches_jax_and_oracle(seed, limits):
    """Windows of up to 3,000 bases fit both limit sets; the narrow one
    halves the cap and m_out."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 60000).astype(np.uint8)
    items, wins = _items(rng, genome, 24)
    got = GD.batch_gap_anchors(items, *limits, device="cpu")
    _same(got, JGD.batch_gap_anchors(items, *limits))
    n_checked = 0
    for g, w in zip(got, wins):
        if g is not None:
            assert np.array_equal(g, oracle_anchors(*w))
            n_checked += 1
    assert n_checked >= 20


@pytest.fixture(scope="module")
def repeat_genome():
    """A genome with a tandem repeat and a duplicated segment, so that read
    9-mers match more than cap genome entries."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 40000).astype(np.uint8)
    genome[12000:13200] = np.tile(genome[100:124], 50)
    genome[20000:23000] = genome[5000:8000]
    genome[26000:26600] = 0  # a homopolymer run
    return genome


@pytest.mark.parametrize("limits", [(1024, 4096, 16, 2048), (64, 512, 4, 96)],
                         ids=["defaults", "small"])
def test_overflowing_items_match_jax(repeat_genome, limits):
    """Cap overflow on repeats, count over m_out, windows over g_max / r_max
    (the small limits), and items with no genome or no read position."""
    g_max, r_max, cap, m_out = limits
    rng = np.random.default_rng(12)
    g = repeat_genome
    items, wins = _items(rng, g, 12, at=[11900, 19800, 4900, 25800, 30000])
    items += _items(rng, g, 4, glen=(20, 300), rlen=(20, 300))[0]
    empty_g = make_item(g, g[1000:2000], 3000, 3000, 0, 400)
    empty_r = make_item(g, g[1000:2000], 1000, 1300, 0, 0)
    short = make_item(g, g[1000:2000], 1000, 1003, 0, 5)
    items += [empty_g, empty_r, short]
    got = GD.batch_gap_anchors(items, g_max, r_max, cap, m_out, device="cpu")
    _same(got, JGD.batch_gap_anchors(items, g_max, r_max, cap, m_out))
    assert sum(x is None for x in got) >= 3
    assert any(x is not None and len(x) for x in got)
    assert [len(x) for x in got[-3:]] == [0, 0, 0]
    if g_max == 1024:
        for x, w in zip(got, wins):
            if x is not None:
                assert np.array_equal(x, oracle_anchors(*w))


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_tensor_outputs_match_jax_kernel(seed, repeat_genome):
    """gap_anchors (the plain version) against _gap_anchors_kernel: counts
    and overflow flags, and anchors and keys on every slot."""
    rng = np.random.default_rng(seed)
    items = _items(rng, repeat_genome, 10, at=[11900, 19800, 2000, 33000])[0]
    packed = GD.pack_items(items, 256, 1024)
    assert [a.shape for a in packed[::3]] == [(10, 1292), (10, 1032),
                                              (10,)]
    got = GD.gap_anchors(*(torch.from_numpy(x) for x in packed), g_max=256,
                         r_max=1024, cap=8, m_out=512)
    want = JGD._gap_anchors_kernel(*packed, g_max=256, r_max=1024, cap=8,
                                   m_out=512)
    for name, g, w in zip(("anchors", "keys", "count", "overflow"), got,
                          want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert got[3].any() and not got[3].all()
    assert (got[2] > 0).sum() >= 5


@pytest.mark.parametrize("with_n", [False, True])
def test_stream_vals_match_jax(with_n):
    rng = np.random.default_rng(8)
    seq = rng.integers(0, 4, (3, 200)).astype(np.uint8)
    if with_n:
        seq[:, ::7] = 4
    got = GD.stream_vals(torch.from_numpy(seq))
    want = JGD._stream_vals(seq)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_dispatch():
    """CPU tensors run the plain version and launch nothing; other devices
    and mixed devices raise."""
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    items = _items(rng, genome, 3)[0]
    args = [torch.from_numpy(x) for x in GD.pack_items(items)]
    before = GD.launches
    got = GD.gap_anchors(*args)
    want = GD.gap_anchors_reference(*args, 1024, 4096, 16, 2048)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert GD.launches == before
    with pytest.raises(ValueError):
        GD.gap_anchors(*(a.to("meta") for a in args))
    with pytest.raises(ValueError):
        GD.gap_anchors(*args[:-1], args[-1].to("meta"))
    assert GD.batch_gap_anchors([], device="cpu") == []


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(repeat_genome):
    """The hand-written kernel against the plain version on the card: count
    and overflow, anchors and keys up to min(count, m_out)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs this check on corpus items)")
    rng = np.random.default_rng(3)
    items = _items(rng, repeat_genome, 40, at=[11900, 19800, 2000, 33000])[0]
    for limits in ((1024, 4096, 16, 2048), (64, 512, 4, 96)):
        args = [torch.from_numpy(x).cuda()
                for x in GD.pack_items(items, *limits[:2])]
        got = GD.gap_anchors(*args, *limits)
        want = GD.gap_anchors_reference(*args, *limits)
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        for b, c in enumerate(want[2].tolist()):
            n = min(c, limits[3])
            assert torch.equal(got[0][b, :n], want[0][b, :n])
            assert torch.equal(got[1][b, :n], want[1][b, :n])


@pytest.mark.parametrize("limits,near", [((1025, 4096), False),
                                         ((1024, 4097), False),
                                         ((2048, 8192), False),
                                         ((1024, 4096), True)],
                         ids=["g_max_1025", "r_max_4097", "wide", "near_2_30"])
def test_past_the_kernel_tables_match_jax_kernel(limits, near):
    """The shapes past the kernel's usual order: g_max or r_max one past
    its shared tables (the keyed kernel), both doubled (the emission key's
    g_rel and r_rel fields then pass 13 bits and overlap, in JAX as here),
    and windows that start within 5 g_max of 2^30 (the genome entries carry
    into the std bit; merged by key). The plain version against
    _gap_anchors_kernel on every slot."""
    g_max, r_max = limits
    rng = np.random.default_rng(g_max + r_max + near)
    genome = rng.integers(0, 4, 80000).astype(np.uint8)
    items = _items(rng, genome, 6, glen=(5 * g_max - 400, 5 * g_max),
                   rlen=(r_max - 300, r_max))[0]
    if near:
        for t, it in enumerate(items):
            it["gpos0"] = (1 << 30) - 1500 - 700 * t
    packed = GD.pack_items(items, g_max, r_max)
    kw = dict(g_max=g_max, r_max=r_max, cap=16, m_out=4096)
    got = GD.gap_anchors(*(torch.from_numpy(x) for x in packed), **kw)
    want = JGD._gap_anchors_kernel(*packed, **kw)
    for name, g, w in zip(("anchors", "keys", "count", "overflow"), got,
                          want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert (got[2] > 0).sum() >= 3


# -------------------------------- the kernel's filtered formulation

def _filtered_items(kind, rng, genome):
    """Items for gap_anchors_filtered: random windows; windows on the
    repeats (groups over the cap); read windows ending in 20 T bases, whose
    9-mer val 2^18 - 1 no genome sample of these windows has, so vmax comes
    only from a read 9-mer the filter drops; read windows of T only (the
    filter empties them); windows near 2^30 and below 0 (ranked by key)."""
    at = [2000, 5000, 9000, 15000, 30000, 33000]
    if kind == "repeats":
        return _items(rng, genome, 8, at=[11900, 19800, 4900, 12100])[0]
    items = _items(rng, genome, 8, at=at)[0]
    if kind in ("tail_only_vmax", "emptied"):
        for it in items:
            rw = it["rwin"].copy()
            if kind == "emptied":
                rw[:] = 3
            else:
                rw[-28:] = 3
            it["rwin"] = rw
    if kind == "near_2_30":
        for t, it in enumerate(items):
            it["gpos0"] = (1 << 30) - 1500 - 700 * t if t < 5 else -1200
    if kind == "below_0":
        # a genome entry at a position below 0 sits in the group of the val
        # below its own (JAX's signed searchsorted): read 9-mers of that val
        # pair with it
        for t, it in enumerate(items):
            it["gpos0"] = -1200 - 7 * t
    return items


@pytest.mark.parametrize("limits", [(1024, 4096, 16, 2048), (64, 512, 4, 96)],
                         ids=["defaults", "small"])
@pytest.mark.parametrize("kind", ["random", "repeats", "tail_only_vmax",
                                  "emptied", "near_2_30", "below_0"])
def test_filtered_formulation_matches_jax_kernel(kind, limits,
                                                 repeat_genome):
    """gap_anchors_filtered (the read 9-mers filtered by the hashed bitmap of
    the genome vals after vmax has seen them all, both key sets sorted, the
    pairs walked in (genome entry, read key) order, ranked by key only off
    0 .. 2^30 - 5 g_max) against JAX's _gap_anchors_kernel: counts,
    overflow flags, and anchors and keys up to min(count, m_out)."""
    g_max, r_max, cap, m_out = limits
    rng = np.random.default_rng(61 + len(kind))
    items = _filtered_items(kind, rng, repeat_genome)
    packed = GD.pack_items(items, g_max, r_max)
    got = GD.gap_anchors_filtered(*(torch.from_numpy(x) for x in packed),
                                  g_max, r_max, cap, m_out)
    want = [np.asarray(t) for t in JGD._gap_anchors_kernel(
        *packed, g_max=g_max, r_max=r_max, cap=cap, m_out=m_out)]
    count = want[2]
    assert np.array_equal(got[2].numpy(), count)
    assert np.array_equal(got[3].numpy(), want[3])
    defined = np.arange(m_out)[None, :] < np.minimum(count, m_out)[:, None]
    for g, w in zip(got[:2], want[:2]):
        assert np.array_equal(np.where(defined, g.numpy(), 0),
                              np.where(defined, w, 0))
    survivors, r_n = got[4].numpy(), np.minimum(packed[4], r_max)
    if kind == "emptied":
        assert not survivors.any() and not count.any() and not want[3].any()
    else:
        assert (count > 0).sum() >= 3 and (survivors < r_n).all()
    if kind == "repeats":
        assert want[3].any()
    if kind == "tail_only_vmax":
        # the largest val of the genome windows' samples is below the
        # read's 2^18 - 1, and its group is kept
        assert (survivors < r_n - 20).all() and count.sum() > 0
