"""linear_tpu_torch.ops.chain_dp against linear_tpu: the port's plain
windowed DP (what CPU tensors run) against JAX's `batch_chain_dp_windowed`
on JAX-CPU, for score_type 0 and 1 at W = 64, on random rows, rows with
overflow, edge rows (0-2 anchors, ties, 64-bit patterns whose anchor-x add
passes bit 63) and rows from corpus reads after the Mapper's pre-pass; the
plain full DP against JAX's `batch_chain_dp` and the windowed DP on rows
without overflow; ChainsRecords through `chain_records_from_dp` against
`get_best_chains` on the cases of tests/test_device.py; the full DP's
dispatch `chain_dp` against JAX's `batch_chain_dp` on sorted, unsorted and
padded rows, every column; and the Mapper's `_device_chain_block` on device
cpu. Every comparison is exact."""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

import difftest as DT  # noqa: E402
import test_torch_native_ready  # noqa: E402,F401  (the JAX package's libraries)
from linear_tpu.map import chaining as JCH  # noqa: E402
from linear_tpu.ops import chain_dp as JCD  # noqa: E402
from linear_tpu_torch.index import dindex as DI  # noqa: E402
from linear_tpu_torch.map import chaining as CH  # noqa: E402
from linear_tpu_torch.map import pmpfinder as PMP  # noqa: E402
from linear_tpu_torch.ops import chain_dp as CD  # noqa: E402
from linear_tpu_torch.utils import seqio  # noqa: E402
from linear_tpu_torch.utils.cordscalar import anchor_x  # noqa: E402

W = 64


def _pack(rows, N=None):
    """Anchor lists -> (B, N) int64 rows (uint64 bit patterns) and counts."""
    N = N or max(64, 1 << int(np.ceil(np.log2(max(1, max(map(len, rows)))))))
    arr = np.zeros((len(rows), N), dtype=np.uint64)
    cnt = np.zeros((len(rows),), dtype=np.int32)
    for b, r in enumerate(rows):
        arr[b, : len(r)] = np.array(r, dtype=np.uint64)
        cnt[b] = len(r)
    return arr.view(np.int64), cnt


def _random_row(rng, n, y_span=4000, x0=123000):
    """tests/test_device.py's generator: anchors near one diagonal, sorted
    descending by anchor-x; a small y_span packs them within dx-depth."""
    ys = np.sort(rng.integers(0, y_span, n))
    anc = [(((x0 + int(rng.integers(-150, 150)) + (1 << 20)) << 20) + int(y)
            + (int(rng.integers(0, 2)) << 61)) for y in ys]
    anc.sort(key=anchor_x, reverse=True)
    return anc


def _port_windowed(arr, cnt, score_type, W=W):
    out = CD.chain_dp_windowed_reference(torch.from_numpy(arr),
                                         torch.from_numpy(cnt), W=W,
                                         score_type=score_type)
    return [t.numpy() for t in out]


def _jax_windowed(arr, cnt, score_type, W=W):
    out = JCD.batch_chain_dp_windowed(jnp.asarray(arr), jnp.asarray(cnt), W=W,
                                      score_type=score_type)
    return [np.asarray(t) for t in out]


def _assert_same(got, want):
    for name, a, b in zip(("p2", "score", "length", "overflow"), got, want):
        assert a.shape == b.shape, name
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


def _prepass(anchors):
    """Mapper._device_chain_block's pre-pass on one read's seeds."""
    a = [0] + [int(x) for x in anchors]
    PMP.filter_anchors(a, 1, 2, 2)
    return PMP.CXS.std_sort(a, [anchor_x(x) for x in a], desc=True)


@pytest.fixture(scope="module")
def corpus_rows():
    """Rows of reads on a repeat-rich genome after the pre-pass (2 or more
    anchors, at most 1024), in batches of 16."""
    rng = np.random.default_rng(77)
    genome = DT.make_repeat_genome(rng, 120000)
    idx = DI.build_dindex([genome], 4)
    rows = []
    for r in DT.simulate(rng, [genome], 40):
        if len(r) <= 200:
            continue
        a = _prepass(DI.query_anchors(idx, r, 0, len(r)))
        if 2 <= len(a) <= 1024:
            rows.append(a)
    return rows


def _random_rows(seed):
    rng = np.random.default_rng(seed)
    rows = [_random_row(rng, int(rng.integers(8, 200))) for _ in range(10)]
    # dense rows: anchors W + 1 places back are still within dx-depth
    rows += [_random_row(rng, int(rng.integers(W + 2, 200)), y_span=250)
             for _ in range(3)]
    return rows


@pytest.mark.parametrize("score_type", [0, 1])
@pytest.mark.parametrize("case", ["random", "corpus"])
def test_windowed_matches_jax(case, score_type, corpus_rows):
    rows = _random_rows(3 + score_type) if case == "random" else corpus_rows
    for b0 in range(0, len(rows), 16):
        arr, cnt = _pack(rows[b0: b0 + 16])
        got = _port_windowed(arr, cnt, score_type)
        _assert_same(got, _jax_windowed(arr, cnt, score_type))
        assert (got[0] >= 0).any(), "no chained anchor"
    if case == "random":
        assert got[3].any() and not got[3].all()


@pytest.mark.parametrize("score_type", [0, 1])
def test_edge_rows(score_type):
    """0, 1 and 2 anchors, equal anchors (ties: the smallest j wins), a row
    of random 64-bit patterns (bit 63 set: the anchor-x add wraps), and an
    n = N row."""
    rng = np.random.default_rng(9)
    one = _random_row(rng, 1)

    def at_x(xs):  # anchors with the given anchor-x, y rising by 20
        return [((x - 20 * k + (1 << 20)) << 20) + 20 * k
                for k, x in enumerate(xs)]

    dense = list(range(123064, 122999, -1))  # W + 1 anchors within 64
    rows = [[], one, _random_row(rng, 2), one * 40,
            [int(v) for v in rng.integers(-(1 << 63), (1 << 63) - 1, 100,
                                          dtype=np.int64).view(np.uint64)],
            _random_row(rng, 128),
            # the overflow test's edge: the anchor W + 1 places back is
            # 1000 away (no overflow), W places back 64 (overflow if used)
            at_x([124000] + dense), at_x([123065] + dense)]
    arr, cnt = _pack(rows, N=128)
    got = _port_windowed(arr, cnt, score_type)
    _assert_same(got, _jax_windowed(arr, cnt, score_type))
    assert got[3].tolist()[-2:] == [False, True]


@pytest.mark.parametrize("score_type", [0, 1])
def test_windowed_equals_full_dp(score_type):
    """On rows without overflow the windowed DP is the full DP; the port's
    plain full DP equals JAX's batch_chain_dp on every row."""
    rows = _random_rows(5)
    arr, cnt = _pack(rows, N=256)
    full = [t.numpy() for t in CD.chain_dp_reference(
        torch.from_numpy(arr), torch.from_numpy(cnt), score_type=score_type)]
    jfull = JCD.batch_chain_dp(jnp.asarray(arr), jnp.asarray(cnt),
                               score_type=score_type)
    _assert_same(full, [np.asarray(t) for t in jfull])
    win = _port_windowed(arr, cnt, score_type)
    assert not win[3].all()
    for b in np.flatnonzero(~win[3]):
        for k in range(3):
            assert np.array_equal(win[k][b], full[k][b]), (b, k)


@pytest.mark.parametrize("seed,N", [(5, 64), (11, 96)],
                         ids=["test_device_132", "test_device_164"])
def test_chain_records_match_get_best_chains(seed, N):
    """tests/test_device.py:132 and :164: the records rebuilt from the plain
    full and windowed DP tables equal getBestChains (the port's and JAX's)."""
    rng = np.random.default_rng(seed)
    rows = [_random_row(rng, int(rng.integers(8, N))) for _ in range(4)]
    arr, cnt = _pack(rows, N=N)
    full = [t.numpy() for t in CD.chain_dp_reference(torch.from_numpy(arr),
                                                     torch.from_numpy(cnt))]
    win = _port_windowed(arr, cnt, 0)
    for b, row in enumerate(rows):
        n = len(row)
        a = np.array(row, dtype=np.uint64)
        want = CH.get_best_chains(a, 0, n, 20, 300, CH.get_apx_chain_score,
                                  CH.ChainScoreParms(), anchor_x)
        jwant = JCH.get_best_chains(a, 0, n, 20, 300, JCH.get_apx_chain_score,
                                    JCH.ChainScoreParms(), anchor_x)
        tables = [full] + ([] if win[3][b] else [win])
        for t in tables:
            got = CD.chain_records_from_dp(t[0][b], t[1][b], t[2][b], n)
            for i in range(n):
                rec = (got[i].p2anchor, got[i].score, got[i].length,
                       got[i].root_ptr, got[i].f_leaf)
                for w in (want[i], jwant[i]):
                    assert rec == (w.p2anchor, w.score, w.length, w.root_ptr,
                                   w.f_leaf), (b, i)


def test_dispatch():
    """CPU tensors run the plain version and launch nothing; other devices
    and mixed devices raise."""
    arr, cnt = _pack(_random_rows(7)[:4])
    before = CD.launches
    got = CD.chain_dp_windowed(torch.from_numpy(arr), torch.from_numpy(cnt))
    _assert_same([t.numpy() for t in got], _port_windowed(arr, cnt, 0))
    assert CD.launches == before
    with pytest.raises(ValueError):
        CD.chain_dp_windowed(torch.from_numpy(arr).to("meta"),
                             torch.from_numpy(cnt).to("meta"))
    with pytest.raises(ValueError):
        CD.chain_dp_windowed(torch.from_numpy(arr).to("meta"),
                             torch.from_numpy(cnt))


def _full_rows(kind, seed):
    """Rows for the full DP: sorted (the pre-pass order), unsorted (the
    same rows shuffled: JAX's mask, not the C++ break, decides), or sorted
    rows in a wide padded table (columns past n are computed too)."""
    rng = np.random.default_rng(seed)
    rows = _random_rows(seed)[:8] + [[], _random_row(rng, 1)]
    if kind == "unsorted":
        rows = [[int(v) for v in rng.permutation(np.array(r, np.uint64))]
                for r in rows]
    return _pack(rows, N=512 if kind == "padded" else 256)


@pytest.mark.parametrize("depths", [(20, 300), (5, 100)],
                         ids=["default", "shallow"])
@pytest.mark.parametrize("score_type", [0, 1])
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "padded"])
def test_full_dp_matches_jax(kind, score_type, depths):
    """chain_dp on the CPU (the plain full DP) against JAX's batch_chain_dp
    on every column, at the default depth and dx-depth and at shallower
    ones."""
    arr, cnt = _full_rows(kind, 13 + score_type + depths[0])
    got = [t.numpy() for t in CD.chain_dp(
        torch.from_numpy(arr), torch.from_numpy(cnt), *depths,
        score_type=score_type)]
    want = JCD.batch_chain_dp(jnp.asarray(arr), jnp.asarray(cnt), *depths,
                              score_type=score_type)
    _assert_same(got, [np.asarray(t) for t in want])
    assert (got[0] >= 0).sum() > 100


def test_full_dp_dispatch():
    """CPU tensors run the plain full DP and launch nothing; other devices
    and mixed devices raise."""
    arr, cnt = _full_rows("sorted", 7)
    a, c = torch.from_numpy(arr), torch.from_numpy(cnt)
    before = CD.full_launches
    got = CD.chain_dp(a, c, thd_chain_depth=5, thd_chain_dx_depth=100)
    want = CD.chain_dp_reference(a, c, 5, 100)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert CD.full_launches == before
    with pytest.raises(ValueError):
        CD.chain_dp(a.to("meta"), c.to("meta"))
    with pytest.raises(ValueError):
        CD.chain_dp(a, c.to("meta"))


@pytest.mark.parametrize("chain_w,max_n", [(64, 8192), (4, 20)])
def test_device_chain_block_accounts_for_every_read(tmp_path, chain_w, max_n):
    """Mapper._device_chain_block on device cpu: every seeded read is
    chained or counted under one host-DP reason (a small W or anchor cap
    makes reads overflow or exceed it), and each chained read's records
    equal getBestChains on its pre-passed anchors."""
    from linear_tpu_torch.map.mapper import Mapper, MapperConfig

    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 30000).astype(np.uint8)
    seqio.write_fasta(str(tmp_path / "g.fa"), ["chrH x"], [genome])
    m = Mapper([str(tmp_path / "g.fa")], MapperConfig(threads=4),
               device="cpu")
    m.prepare()
    m.CHAIN_W, m.CHAIN_MAX_N, m.DEV_BATCH = chain_w, max_n, 4
    seeded = [None]
    for _ in range(9):
        ln = int(rng.integers(300, 3000))
        pos = int(rng.integers(0, 30000 - ln))
        r = DT.mutate(genome[pos: pos + ln], rng)
        seeded.append(DI.query_anchors(m.index, r, 0, len(r)))
    seeded.append(np.zeros(0, dtype=np.uint64))
    out = m._device_chain_block(seeded)
    raw = m._device_chain_block(seeded, raw=True)
    cc = m.chain_counters
    assert cc.seeded == 2 * 10
    assert cc.chained + cc.host_few + cc.host_many + cc.host_overflow == cc.seeded
    assert cc.chained > 0 and cc.host_few >= 2
    if chain_w == 4:
        assert cc.host_overflow > 0 and cc.host_many > 0
    for s, o, rw in zip(seeded, out, raw):
        if o is None:
            assert rw is None
            continue
        anchors, recs = o
        assert anchors == _prepass(s) and rw[0] == anchors
        want = CH.get_best_chains(np.array(anchors, dtype=np.uint64), 0,
                                  len(anchors), 20, 300,
                                  CH.get_apx_chain_score,
                                  CH.ChainScoreParms(), anchor_x)
        assert [(r.p2anchor, r.score, r.length, r.root_ptr, r.f_leaf)
                for r in recs] == [(r.p2anchor, r.score, r.length,
                                    r.root_ptr, r.f_leaf) for r in want]
        assert [r.p2anchor for r in recs] == list(rw[1])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(corpus_rows):
    """The hand-written kernel against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs this check at the main path's shapes)")
    for score_type in (0, 1):
        for rows in (corpus_rows, _random_rows(3)):
            arr, cnt = _pack(rows)
            a, c = torch.from_numpy(arr).cuda(), torch.from_numpy(cnt).cuda()
            got = [t.cpu().numpy() for t in CD.chain_dp_windowed(
                a, c, W=W, score_type=score_type)]
            want = [t.cpu().numpy() for t in CD.chain_dp_windowed_reference(
                a, c, W=W, score_type=score_type)]
            _assert_same(got, want)


@pytest.mark.cuda
def test_cuda_full_kernel_matches_plain():
    """The full-DP kernel against its plain version on the card, every
    column."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs this check at the Mapper's widths)")
    for kind in ("sorted", "unsorted", "padded"):
        arr, cnt = _full_rows(kind, 3)
        a, c = torch.from_numpy(arr).cuda(), torch.from_numpy(cnt).cuda()
        for score_type in (0, 1):
            got = CD.chain_dp(a, c, score_type=score_type)
            want = CD.chain_dp_reference(a, c, score_type=score_type)
            assert all(torch.equal(x, y) for x, y in zip(got, want))


# ------------------------------------------- any W, and the packed-key facts

from test_torch_kernel_edges import adversarial_pairs, tied_rows  # noqa: E402,E501

WS = [1, 31, 32, 33, 65, 128]


@pytest.mark.parametrize("rows", ["random_dense", "short"])
@pytest.mark.parametrize("score_type", [0, 1])
@pytest.mark.parametrize("w", WS)
def test_windowed_at_any_w_matches_jax(w, score_type, rows):
    """chain_dp_windowed_reference (what CPU tensors run and the kernel is
    held to on the card) against JAX's batch_chain_dp_windowed at W around
    the warp's 32 lanes and past the Mapper's 64: on random and dense rows
    (N 256), and on short rows at N 64, where W 65 and 128 exceed N."""
    if rows == "random_dense":
        arr, cnt = _pack(_random_rows(3 + score_type), N=256)
    else:
        rng = np.random.default_rng(40 + w)
        arr, cnt = _pack([_random_row(rng, int(rng.integers(0, 65)),
                                      y_span=400) for _ in range(6)], N=64)
    got = _port_windowed(arr, cnt, score_type, W=w)
    _assert_same(got, _jax_windowed(arr, cnt, score_type, W=w))
    assert (got[0] >= 0).any()


@pytest.mark.parametrize("score_type", [0, 1])
@pytest.mark.parametrize("w", [33, 64, 128])
def test_tied_rows_match_jax(w, score_type):
    """Rows of clusters of equal anchors: every candidate of a step from the
    cluster before ties (same edge, same score), so the key's d field alone
    decides, and JAX's argmax takes the smallest j."""
    arr, cnt = tied_rows(w, n_rows=4, N=256)
    got = _port_windowed(arr, cnt, score_type, W=w)
    _assert_same(got, _jax_windowed(arr, cnt, score_type, W=w))
    # a chained anchor takes the first anchor of the cluster before it
    p2 = got[0][0, : cnt[0]]
    assert (p2 >= 0).sum() > 100 and (p2[p2 >= 0] % 8 == 0).all()


@pytest.mark.parametrize("kind", ["random", "near_diagonal", "adversarial"])
@pytest.mark.parametrize("score_type", [0, 1])
def test_positive_edge_scores_fit_a_byte(score_type, kind):
    """What the kernel's uint8 edges rely on: every positive edge score of
    getApxChainScore (and getApxChainScore0) lies in 1..100 (1..95), and
    the port's score functions equal JAX's on the pairs."""
    rng = np.random.default_rng(7 + score_type)
    if kind == "random":
        pairs = rng.integers(-(1 << 63), (1 << 63) - 1, (20000, 2),
                             dtype=np.int64)
    elif kind == "near_diagonal":
        row = np.array(_random_row(rng, 4000, y_span=20000),
                       dtype=np.uint64).view(np.int64)
        j = rng.integers(0, len(row) - 64, 20000)
        pairs = np.stack([row[j], row[j + rng.integers(1, 64, len(j))]], 1)
    else:
        pairs = adversarial_pairs(rng, 20000)
    fn = CD._apx_chain_score if score_type == 0 else CD._apx_chain_score0
    jfn = JCD._apx_chain_score if score_type == 0 else JCD._apx_chain_score0
    got = fn(torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1]))
    want = np.asarray(jfn(jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    pos = got.numpy()[got.numpy() > 0]
    assert kind == "random" or len(pos) > 1000
    assert int(pos.max(initial=0)) <= (100 if score_type == 0 else 95)


@pytest.mark.parametrize("w", [1, 2, 31, 32, 33, 64, 128, 4096])
def test_key_max_picks_jax_argmax(w):
    """The kernel's one max over key = total << bits | (d - 1) picks what
    JAX's argmax over the ring order (w = W - d, the oldest first) picks:
    the largest total, and on ties the smallest j. Rows with every total
    tied, with ties among a few, with no candidate, and random totals up to
    the 32-bit key's limit."""
    rng = np.random.default_rng(w)
    bits = CD.key_bits(w)
    top = (1 << (32 - bits)) - 1
    tot = np.concatenate([
        np.full((4, w), 57), np.full((1, w), top), np.zeros((2, w)),
        rng.integers(0, 4, (16, w)) * 100,
        rng.integers(0, top + 1, (16, w))]).astype(np.int64)
    tot[:2, : w // 2] = 0
    best, d = CD.key_max(torch.from_numpy(tot), bits)
    assert int(((torch.from_numpy(tot) << bits) | (w - 1)).max()) < 1 << 32
    ring = np.where(tot > 0, tot, -(1 << 40))[:, ::-1]  # column w = W - d
    arg = np.asarray(jnp.argmax(jnp.asarray(ring), axis=1))
    found = ring.max(1) > 0
    assert np.array_equal(best.numpy(), np.where(found, ring.max(1), 0))
    assert np.array_equal(d.numpy()[found], (w - arg)[found])


# ------------------------------- the full DP kernel's split (near and far)

from test_torch_kernel_edges import straddle_rows  # noqa: E402

SPLIT_N = 256


def _split_rows(kind, seed):
    """(B, SPLIT_N) rows for chain_dp_split: sorted (random and dense rows,
    an empty and a one-anchor row), the same shuffled, dense rows whose
    anchors lie within dx-depth of many before them, tied rows (clusters
    of equal anchors), and rows whose tied clusters straddle lookbacks 33
    and 64."""
    rng = np.random.default_rng(seed)
    if kind == "tied":
        return tied_rows(33, 6, SPLIT_N, seed)
    if kind == "straddle":
        return straddle_rows(4, SPLIT_N, seed)
    if kind == "dense":
        rows = [_random_row(rng, int(rng.integers(60, SPLIT_N)), y_span=300)
                for _ in range(6)]
    else:
        rows = _random_rows(seed)[:7] + [[], _random_row(rng, 1)]
    if kind == "shuffled":
        rows = [[int(v) for v in rng.permutation(np.array(r, np.uint64))]
                for r in rows]
    return _pack(rows, N=SPLIT_N)


@pytest.mark.parametrize("score_type", [0, 1])
@pytest.mark.parametrize("D", [1, 2, 33, 64])
@pytest.mark.parametrize("kind", ["sorted", "shuffled", "dense", "tied",
                                  "straddle"])
def test_chain_dp_split_matches_jax(kind, D, score_type):
    """chain_dp_split (the full DP kernel's near part over the last D
    columns by the packed key, its far part over j < i - D, the far part
    winning a tie, padded columns equal to the one before them copied)
    against JAX's batch_chain_dp on every column."""
    arr, cnt = _split_rows(kind, 90 + D)
    got = [t.numpy() for t in CD.chain_dp_split(
        torch.from_numpy(arr), torch.from_numpy(cnt), D=D,
        score_type=score_type)]
    want = JCD.batch_chain_dp(jnp.asarray(arr), jnp.asarray(cnt),
                              score_type=score_type)
    _assert_same(got, [np.asarray(t) for t in want])
    assert (got[0] >= 0).sum() > 40


@pytest.mark.parametrize("D", [33, 64])
def test_straddling_ties_take_the_far_j(D):
    """On the straddle rows every winning total ties across the whole
    cluster before a column, part of it within the last D columns and part
    past them: the far part's (smaller) j wins, so each chained column
    points at its previous cluster's first anchor."""
    arr, cnt = straddle_rows(2, SPLIT_N)
    p2 = CD.chain_dp_split(torch.from_numpy(arr), torch.from_numpy(cnt),
                           D=D)[0].numpy()[0]
    starts = np.flatnonzero(np.r_[True, arr[0, 1:] != arr[0, :-1]])
    first = starts[np.searchsorted(starts, np.arange(SPLIT_N), "right") - 1]
    prev_first = np.r_[-1, starts][np.searchsorted(starts, first)]
    chained = p2 >= 0
    assert chained.sum() > 100
    assert np.array_equal(p2[chained], prev_first[chained])
    # some of those ties had members on both sides of D
    d = np.arange(SPLIT_N) - p2
    assert (chained & (d > D) & (np.arange(SPLIT_N) - first < D)).any()


def test_far_edge_prefilter_admits_every_positive_edge():
    """far_edge_may_score, the full DP kernel's test before it scores a
    far edge: every (dy, dx) on a grid past its bounds whose edge scores
    positive under either score type satisfies it, and the bounds are
    tight enough to be reached."""
    dy = torch.arange(-60, 2400)[:, None]
    dx = torch.arange(-250, 2800)[None, :]
    dy, dx = dy.expand(-1, dx.shape[1]), dx.expand(dy.shape[0], -1)
    yi, xi = 300000, 5_000_000
    aj = _anchors_at(xi + dx.reshape(-1), yi + dy.reshape(-1))
    ai = _anchors_at(torch.full_like(aj, xi), torch.full_like(aj, yi))
    ok = CD.far_edge_may_score(dy.reshape(-1), dx.reshape(-1))
    for fn in (CD._apx_chain_score, CD._apx_chain_score0):
        pos = fn(aj, ai) > 0
        assert pos.any() and not (pos & ~ok).any()
    # beyond the grid: random pairs anywhere in the anchors' range
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 1 << 30, (2, 200000)))
    y = torch.from_numpy(rng.integers(0, 1 << 20, (2, 200000)))
    aj, ai = _anchors_at(x[0], y[0]), _anchors_at(x[1], y[1])
    ok = CD.far_edge_may_score(y[0] - y[1], x[0] - x[1])
    for fn in (CD._apx_chain_score, CD._apx_chain_score0):
        assert not ((fn(aj, ai) > 0) & ~ok).any()


def _anchors_at(x, y):
    """int64 anchors whose getAnchorX is x and whose y is y."""
    a = (((x - y + (1 << 20)) % (1 << 40)) << 20) + y
    assert torch.equal(CD._anchor_x(a), x)
    return a
