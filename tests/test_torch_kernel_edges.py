"""Edge cases of the extension and DIndex build kernels on the card, each
against its plain PyTorch version on the same inputs, exactly. The file
imports nothing of JAX, so on a machine with a card and without JAX it runs
alone: `python -m pytest --noconftest tests/test_torch_kernel_edges.py`.
Without a card every test skips with the reason."""
import numpy as np
import pytest
import torch

from linear_tpu_torch.index import dindex as DI
from linear_tpu_torch.map import nengine as NE
from linear_tpu_torch.ops import _cuda
from linear_tpu_torch.ops import devbuild as DB
from linear_tpu_torch.ops import extend_dev as ED
from linear_tpu_torch.utils import cordscalar as CS


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py holds them against their plain versions "
                    "at the main paths' shapes)")


# ------------------------------------------------------------ DIndex build


def _emit_sort_both(xv, yv, st, jj, gid, bs, **kw):
    cols = [torch.as_tensor(np.asarray(c), dtype=torch.int64)
            for c in (xv, yv, st, jj, gid)]
    b = torch.as_tensor(np.asarray(bs), dtype=torch.uint8)
    want = DB.emit_count_sort(*cols, b, **kw)
    got = DB.emit_count_sort(*(c.cuda() for c in cols), b.cuda(), **kw)
    assert np.array_equal(got[0].cpu().numpy(), want[0].numpy())
    assert np.array_equal(got[1].cpu().numpy(), want[1].numpy())
    assert got[2] == want[2]
    return want


@pytest.mark.cuda
def test_devbuild_bucket_sizes_strands_and_genomes():
    """Hand-made samples, each its own run (every sample emitted): a bucket
    of exactly omit_block (400) entries stays, one of 401 goes, one holds
    both strands interleaved, and the samples come from three genomes."""
    _card()
    rng = np.random.default_rng(21)
    xv = np.concatenate([np.full(400, 777), np.full(401, 888),
                         np.full(300, 999), rng.integers(0, 1 << 26, 5000)])
    st = rng.integers(0, 2, len(xv))
    st[801:1101] = np.arange(300) % 2
    order = rng.permutation(len(xv))
    xv, st = xv[order], st[order]
    gid = np.repeat([0, 1, 2], [2000, 2500, len(xv) - 4500])
    jj = np.concatenate([np.arange(n) * 9 + 8 for n in np.bincount(gid)])
    yv = rng.integers(0, 256, len(xv))
    bs = np.ones(len(xv), np.uint8)
    dirp, hs, largest = _emit_sort_both(xv, yv, st, jj, gid, bs)
    counts = np.diff(dirp.numpy())
    assert counts[777] == 400 and counts[888] == 0 and counts[999] == 300
    assert largest == 400


@pytest.mark.cuda
def test_devbuild_runs_and_emission():
    """Runs of one xval over block starts: every second sample of a run is
    emitted, and a block start restarts the phase."""
    _card()
    rng = np.random.default_rng(22)
    xv = np.repeat(rng.integers(0, 1 << 26, 3000), rng.integers(1, 9, 3000))
    n = len(xv)
    bs = (rng.random(n) < 0.01).astype(np.uint8)
    bs[0] = 1
    _emit_sort_both(xv, rng.integers(0, 256, n), rng.integers(0, 2, n),
                    np.arange(n) * 9 + 8, np.zeros(n, np.int64), bs)


@pytest.mark.cuda
def test_devbuild_run_across_many_tiles():
    """One xval over 200,000 samples (a homopolymer's run, some 200 tiles of
    the emission) with three block starts inside it, between short runs;
    omit_block above the run's count keeps it, so every emitted sample of
    the run shows in hs and each tile's carry must be the run's start."""
    _card()
    rng = np.random.default_rng(24)
    head = np.repeat(rng.integers(0, 1 << 26, 500), rng.integers(1, 9, 500))
    tail = np.repeat(rng.integers(0, 1 << 26, 500), rng.integers(1, 9, 500))
    xv = np.concatenate([head, np.full(200_000, 4242), tail])
    n = len(xv)
    bs = np.zeros(n, np.uint8)
    bs[0] = 1
    bs[len(head) + np.array([37_001, 90_017, 150_031])] = 1
    dirp, _, largest = _emit_sort_both(
        xv, rng.integers(0, 256, n), rng.integers(0, 2, n),
        np.arange(n) * 9 + 8, np.zeros(n, np.int64), bs, omit_block=1 << 20)
    assert largest == int(np.diff(dirp.numpy())[4242]) > 400


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [1, 8])
def test_devbuild_three_genomes_one_shorter_than_a_sample(threads):
    """Three genomes through build_dindex_device, the last shorter than one
    sample (it adds nothing), one with a repeat over omit_block."""
    _card()
    rng = np.random.default_rng(23)
    unit = rng.integers(0, 4, 45).astype(np.uint8)
    seqs = [np.concatenate([rng.integers(0, 4, 9000).astype(np.uint8),
                            np.tile(unit, 1000)]),
            rng.integers(0, 4, 15000).astype(np.uint8),
            rng.integers(0, 4, 7).astype(np.uint8)]
    want = DB.build_dindex_device_host(seqs, "cpu", threads)
    got = DB.build_dindex_device_host(seqs, "cuda", threads)
    host = DI.build_dindex(seqs, threads)
    for ref in (want, host):
        assert np.array_equal(got.dir, ref.dir)
        assert np.array_equal(got.hs, ref.hs)


# -------------------------------------------------------------- extension


@pytest.fixture(scope="module")
def genome():
    g = np.random.default_rng(31).integers(0, 4, 200000).astype(np.uint8)
    return g, NE.build_features_native(g, 4)


def _hits(p, ln, kind):
    """Hand-placed hits of an exact read at genome position p."""
    good = [CS.make_cord(0, p + y, y, 0) for y in range(0, ln - 600, 480)]
    bad = CS.set_end(CS.make_cord(0, (p + 50000) % 150000, 700, 0))
    h = {"zero": [], "one": [CS.FLAG_END], "two": [CS.FLAG_END, good[0]],
         "three": [CS.FLAG_END] + good[:2],
         "good": [CS.FLAG_END] + good,
         "end_inside": [CS.FLAG_END] + good[:4]
         + [CS.set_end(good[4])] + good[5:],
         "drop_first": [CS.FLAG_END, bad] + good,
         "drop_mid": [CS.FLAG_END] + good[:3] + [bad] + good[3:]}[kind]
    if len(h) > 1:
        h[-1] = CS.set_end(h[-1])
    return np.array(h, dtype=np.uint64)


def _extend_both(reads, hits, f2, pad, C, H=256):
    packed, lens = ED.pack_rows(reads, pad)
    hm = np.zeros((len(reads), H), np.uint64)
    hn = np.zeros(len(reads), np.int32)
    for i, h in enumerate(hits):
        hm[i, : len(h)] = h
        hn[i] = len(h)
    args = [torch.from_numpy(a) for a in (packed, lens, hm.view(np.int64), hn)]
    want = [t.numpy() for t in ED.filter_extend(
        *args, ED.upload_genome_feats([f2], "cpu"), C)]
    got = [t.cpu().numpy() for t in ED.filter_extend(
        *(a.cuda() for a in args), ED.upload_genome_feats([f2], "cuda"), C)]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    return want


@pytest.mark.cuda
def test_extension_hit_counts_and_end_flags(genome):
    """Reads with 0, 1, 2 and 3 hits, an end flag inside the hits, and
    end-flagged hits the filter drops (their flags land on the header or on
    the kept hit before them)."""
    _card()
    g, f2 = genome
    rng = np.random.default_rng(32)
    kinds = ["zero", "one", "two", "three", "good", "end_inside",
             "drop_first", "drop_mid"] * 5
    reads, hits = [], []
    for kind in kinds:
        ln = int(rng.integers(3000, 8000))
        p = int(rng.integers(0, len(g) - ln))
        reads.append(g[p: p + ln].copy())
        hits.append(_hits(p, ln, kind))
    _, ncords, ovf = _extend_both(reads, hits, f2, 8192, 512)
    assert not ovf.any()
    assert (ncords[[kinds.index(k) for k in ("zero", "one", "two")]] == 0).all()
    assert (ncords[[kinds.index(k) for k in ("good", "end_inside",
                                             "drop_mid")]] > 1).all()


@pytest.mark.cuda
def test_extension_overflow_exactly_at_slot_c(genome):
    """C equal to a read's cord count fits it; one less overflows there."""
    _card()
    g, f2 = genome
    reads, hits = [], []
    for p, ln in ((1000, 6000), (90000, 7500)):
        reads.append(g[p: p + ln].copy())
        hits.append(_hits(p, ln, "good"))
    _, ncords, _ = _extend_both(reads, hits, f2, 8192, 512)
    k = int(ncords.min())
    assert k > 2
    _, n_at, ovf_at = _extend_both(reads, hits, f2, 8192, k)
    assert not ovf_at[int(ncords.argmin())] and n_at.min() == k
    _, _, ovf_below = _extend_both(reads, hits, f2, 8192, k - 1)
    assert ovf_below.all()


@pytest.mark.cuda
@pytest.mark.parametrize("pad,H", [(32768, 256), (131072, 2048)])
def test_extension_rows_past_the_shared_memory_budget(genome, pad, H):
    """Reads of 20 and 32 kb have more feature rows than a warp keeps in
    shared memory and take them from the device scratch; a 5 kb read of the
    same launch keeps its rows in shared memory. At pad 131072 with H 2048
    the hits and the cords do not fit either and live in device memory."""
    _card()
    g, f2 = genome
    C = 256 + pad // 32
    assert ED.feature_rows(pad) > _cuda.EXT_SMEM_ROWS
    assert (H > _cuda.EXT_SMEM_HITS) == (C > _cuda.EXT_SMEM_CORDS)
    reads, hits = [], []
    for p, ln in ((3000, 20000), (60000, 5000), (100000, 32000)):
        reads.append(g[p: p + ln].copy())
        hits.append(_hits(p, ln, "good"))
    assert (ED._serial_rows(torch.tensor([20000]))
            > _cuda.EXT_SMEM_ROWS).all()
    _, ncords, ovf = _extend_both(reads, hits, f2, pad, C, H)
    assert (ncords > 1).all() and not ovf.any()


# ------------------------------------------------------ windowed chain DP


def _anchor(x, y, hi=0):
    """An anchor with anchor-x x and y y (getAnchorX inverted)."""
    return (((x - y + (1 << 20)) % (1 << 40)) << 20) + y + hi


def _pack_rows(rows, N):
    arr = np.zeros((len(rows), N), np.uint64)
    cnt = np.zeros(len(rows), np.int32)
    for b, r in enumerate(rows):
        arr[b, : len(r)] = r
        cnt[b] = len(r)
    return arr.view(np.int64), cnt


def tied_rows(w, n_rows, N, seed=0):
    """Rows of clusters of equal anchors, 20 apart in x and y: an anchor
    has no edge within its cluster (dy 0) and the same edge to every anchor
    of the cluster before it, whose scores are equal, so every candidate of
    a step that can win ties. Row 0 has clusters of 8 over all N columns;
    the others random sizes up to 16 and lengths up to N. (int64 (n_rows,
    N), counts (n_rows,) int32)."""
    rng = np.random.default_rng(seed + w)
    rows = []
    for b in range(n_rows):
        n = N if b == 0 else int(rng.integers(N // 2, N + 1))
        row, c = [], 0
        while len(row) < n:
            k = 8 if b == 0 else int(rng.integers(1, 17))
            row += [_anchor(500000 - 20 * c, 200000 - 20 * c)] * k
            c += 1
        rows.append(row[:n])
    return _pack_rows(rows, N)


def straddle_rows(n_rows, N, seed=0):
    """Rows of clusters of equal anchors 20 apart in x and y, of 40 and 70
    anchors, so that a column's best totals (the whole cluster before it,
    all tied) straddle lookback 33 and 64: the full DP kernel's near part
    (the last 64 columns) and its far part hold equal totals, and the far
    part's smaller j must win. Row 0 fills N; the others take N / 2 .. N
    anchors, with a padded tail of zeros. (int64 (n_rows, N), counts
    (n_rows,) int32)"""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(n_rows):
        n = N if b == 0 else int(rng.integers(N // 2, N + 1))
        row, c = [], 0
        while len(row) < n:
            row += [_anchor(500000 - 20 * c, 200000 - 20 * c)] * (
                40 if c % 2 else 70)
            c += 1
        rows.append(row[:n])
    return _pack_rows(rows, N)


def adversarial_pairs(rng, n):
    """(a_j, a_i) anchor pairs at the score functions' branch edges: dy
    around 5, 10, 15 * 150 and 15 * 10000, da around 10, 30 and the
    denominator, anchor-x near 0 and 2^30, y near 0 and 2^20, bit 61 and
    the high bits set."""
    dys = np.array([-3, 0, 4, 5, 6, 9, 10, 11, 2249, 2250, 2251, 149999,
                    150000, 150001, (1 << 20) - 1])
    das = np.array([0, 9, 10, 11, 29, 30, 31, 49, 50, 51, 1000, 1 << 25,
                    (1 << 30) - 1])
    pairs = []
    for _ in range(n):
        dy = int(rng.choice(dys))
        da = int(rng.choice(das)) * int(rng.choice([-1, 1]))
        yi = int(rng.integers(0, (1 << 20) - max(dy, 0)))
        xi = int(rng.integers(0, 1 << 30))
        yj, xj = yi + dy, (xi + dy + da) % (1 << 30)
        hi = int(rng.choice([0, 1 << 61, 3 << 62]))
        pairs.append((_anchor(xj, yj % (1 << 20), hi), _anchor(xi, yi)))
    return np.array(pairs, dtype=np.uint64).view(np.int64)


def _dp_rows(rng, W, N):
    """Rows of n in {0, 1, W, W + 1, N} anchors near one diagonal (some
    within dx-depth of anchors past W), sorted by descending anchor-x."""
    rows = []
    for n in sorted({0, 1, min(W, N), min(W + 1, N), N}):
        for y_span in (max(4, 40 * n), max(4, 3 * n)):
            ys = np.sort(rng.integers(0, y_span, n))[::-1]
            xs = 300000 - ys + rng.integers(-150, 150, n)
            rows.append(sorted(
                (_anchor(int(x), int(y), int(rng.integers(0, 2)) << 61)
                 for x, y in zip(xs, ys)), key=CS.anchor_x, reverse=True))
    return rows


def _windowed_both(arr, cnt, W, score_type):
    from linear_tpu_torch.ops import chain_dp as CD

    a, c = torch.from_numpy(arr).cuda(), torch.from_numpy(cnt).cuda()
    got = CD.chain_dp_windowed(a, c, W=W, score_type=score_type)
    want = CD.chain_dp_windowed_reference(a, c, W=W, score_type=score_type)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y.cpu())
    return [t.cpu().numpy() for t in want]


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 33, 128])
def test_windowed_dp_any_w_row_lengths_and_ties(W):
    """W 1, 33 and 128 (one lane's lookbacks, a warp and one more, four a
    lane) on rows of 0, 1, W, W + 1 and N anchors, and on rows where every
    winning total ties, both score types."""
    _card()
    rng = np.random.default_rng(40 + W)
    N = 256
    for score_type in (0, 1):
        arr, cnt = _pack_rows(_dp_rows(rng, W, N), N)
        out = _windowed_both(arr, cnt, W, score_type)
        assert (out[0] >= 0).any()
        arr, cnt = tied_rows(max(W, 1), 6, N)
        out = _windowed_both(arr, cnt, W, score_type)
        if W > 8:
            assert (out[0][0][out[0][0] >= 0] % 8 == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("W,N", [(64, 8192), (4096, 12288)])
def test_windowed_dp_one_long_chain(W, N):
    """One row of N anchors in one chain (each 20 after the last: totals up
    to 100 (N - 1)), beside short rows. At W 4096 the key needs 12 index
    bits, so 100 N passes 2^20 and the row takes the 64-bit path; its ring
    (8,192 slots) and row table pass their shared-memory budgets and live in
    the device scratch."""
    _card()
    rng = np.random.default_rng(N)
    chain = [_anchor(600000 - 20 * k, 900000 - 20 * k) for k in range(N)]
    rows = [chain, _dp_rows(rng, 64, 512)[-1]]
    arr, cnt = _pack_rows(rows, N)
    out = _windowed_both(arr, cnt, W, 0)
    assert out[2][0, N - 1] == N and out[1][0, N - 1] == 100 * (N - 1)


# --------------------------------------------------------- K1 with N bases


def n_dense_reads(genome, rng):
    """Reads dense with N for the scan's state, by kind: N in the init
    window (the first N-free 21-window moves), N only in the last 21 bases,
    a base N every 21, an all-N read, N runs in the first 41 bases (the
    calls k < 41 still hold init bases), reads shorter than 42, lengths 21
    and 22, and an N-free read."""
    def cut(ln, *runs):
        p = int(rng.integers(0, len(genome) - ln))
        r = genome[p: p + ln].copy()
        for sl in runs:
            r[sl] = 4
        return r

    reads = {
        "init_window": cut(3000, slice(3, 9)),
        "first_window_moves": cut(3000, slice(0, 25), 30),
        "last_21": cut(3000, slice(-21, None)),
        "every_21": cut(3000, slice(None, None, 21)),
        "every_21_from_10": cut(3000, slice(10, None, 21)),
        "all_n": np.full(3000, 4, np.uint8),
        "init_tail": cut(3000, slice(20, 41)),
        "first_calls": cut(3000, slice(35, 56)),
        "scattered": cut(3000, rng.random(3000) < 0.3),
        "n_free": cut(3000),
    }
    for ln in (21, 22, 30, 41, 56, 57):
        reads[f"len_{ln}"] = cut(ln, ln // 2)
    return reads


@pytest.mark.cuda
def test_scan_seeding_on_n_dense_reads(genome):
    """K1 (pre-pass and closed-form states) against the plain scan on the
    card, on the N-dense reads, at pad 4096 and at a pad of 128 (most reads
    cut, three call positions)."""
    _card()
    from linear_tpu_torch.ops import seeding as SD

    g, _ = genome
    idx = DI.build_dindex([g], 4)
    index = SD.upload_index(idx.dir, idx.hs, "cuda")
    reads = list(n_dense_reads(g, np.random.default_rng(33)).values())
    for pad in (4096, 128):
        seqs, lens = SD.pad_reads(reads, pad)
        args = (torch.from_numpy(seqs).cuda(), torch.from_numpy(lens).cuda(),
                index.dir_start, index.hs, index.cap)
        got = SD.batch_seed_anchors(*args)
        want = SD.batch_seed_anchors_reference(*args)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        assert int(want[1].sum()) > (300 if pad == 4096 else 0)


# --------------------------------- the shapes past the kernels' shared memory


@pytest.mark.cuda
def test_full_dp_past_the_shared_memory_row():
    """The full DP at N 12,288, past the 11,622 anchors a row that the
    first design kept in shared memory (the redesign keeps 12 bytes a
    column there up to 18,944), sorted and shuffled rows."""
    _card()
    from linear_tpu_torch.ops import chain_dp as CD

    rng = np.random.default_rng(34)
    N = 12288
    row = [_anchor(700000 - 3 * k + int(rng.integers(-100, 100)),
                   (900000 - 3 * k) % (1 << 20)) for k in range(N - 5)]
    shuffled = [row[k] for k in rng.permutation(3000)]
    arr, cnt = _pack_rows([row, shuffled], N)
    a, c = torch.from_numpy(arr).cuda(), torch.from_numpy(cnt).cuda()
    for score_type in (0, 1):
        got = CD.chain_dp(a, c, score_type=score_type)
        want = CD.chain_dp_reference(a, c, score_type=score_type)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [513, 600, 13000])
def test_banded_past_1024_diagonals(W):
    """KW 1,026 and 1,200 (five warps a pair, seven and eight diagonals a
    lane) and 26,000 (32 warps of 32 diagonals a lane)."""
    _card()
    from linear_tpu_torch.ops import align_pallas as AP

    rng = np.random.default_rng(W)
    qry, ref = [], []
    for k in range(6):
        base = rng.integers(0, 4, int(rng.integers(200, 1500))).astype(
            np.uint8)
        q = base.copy()
        q[rng.random(len(q)) < 0.1] = 3
        r = np.concatenate([rng.integers(0, 4, 300 * (k % 3)).astype(np.uint8),
                            base])
        qry.append(q)
        ref.append(r)
    a, bpad, nm = (torch.from_numpy(x).cuda()
                   for x in AP.pack_pairs(qry, ref, W))
    got = AP.banded_align(a, bpad, nm, W)
    want = AP.banded_align_reference(a, bpad, nm, W)
    assert torch.equal(got, want) and int(want.max()) > 300


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 16, 100, 512])
def test_banded_one_diagonal_a_thread(W):
    """KW 2 to 1,024: one warp a pair up to KW 256 (one to eight
    diagonals a lane), four warps of eight at KW 1,024."""
    _card()
    from linear_tpu_torch.ops import align_pallas as AP

    rng = np.random.default_rng(W + 1)
    qry, ref = [], []
    for k in range(8):
        base = rng.integers(0, 4, int(rng.integers(50, 900))).astype(np.uint8)
        q = base.copy()
        q[rng.random(len(q)) < 0.1] = 3
        r = np.concatenate([rng.integers(0, 4, 7 * k).astype(np.uint8), base])
        qry.append(q)
        ref.append(r)
    a, bpad, nm = (torch.from_numpy(x).cuda()
                   for x in AP.pack_pairs(qry, ref, W))
    got = AP.banded_align(a, bpad, nm, W)
    want = AP.banded_align_reference(a, bpad, nm, W)
    assert torch.equal(got, want) and int(want.max()) > 0


def _gap_items(g, rng, n, glen, rlen, gpos_hi=None):
    items = []
    for t in range(n):
        gs = int(rng.integers(0, len(g) - glen - 600))
        ge = gs + glen
        rs_pos = gs + int(rng.integers(0, 100))
        read = g[rs_pos: rs_pos + rlen + 500].copy()
        sub = rng.random(len(read)) < 0.08
        read[sub] = (read[sub] + 1) % 4
        items.append({"gwin": g[gs: ge + 8], "g_n": glen,
                      "gpos0": gs if gpos_hi is None else gpos_hi - t * 7,
                      "rwin": read[: rlen + 8], "r_n": rlen, "rpos0": 0,
                      "rvcp": len(read) - 1,
                      "a_lo": -(1 << 40) if t % 2 == 0 else -500,
                      "a_hi": (1 << 40) if t % 2 == 0 else 1500})
    return items


def _gap_both(items, g_max, r_max, cap, m_out):
    from linear_tpu_torch.ops import gap_dev as GD

    packed = [torch.from_numpy(x).cuda()
              for x in GD.pack_items(items, g_max, r_max)]
    got = GD.gap_anchors(*packed, g_max, r_max, cap, m_out)
    want = GD.gap_anchors_reference(*packed, g_max, r_max, cap, m_out)
    count = want[2].cpu()
    assert torch.equal(got[2].cpu(), count)
    assert torch.equal(got[3].cpu(), want[3].cpu())
    defined = torch.arange(m_out)[None, :] < count.clamp(max=m_out)[:, None]
    for x, y in zip(got[:2], want[:2]):
        assert torch.equal(torch.where(defined, x.cpu(), 0),
                           torch.where(defined, y.cpu(), 0))
    return count


@pytest.mark.cuda
@pytest.mark.parametrize("limits", [(1025, 4096), (1024, 4097), (2048, 8192)])
def test_gap_anchors_past_the_shared_tables(genome, limits):
    """g_max 1,025 or r_max 4,097 (one past the shared tables) and 2,048 /
    8,192: the keyed branch, on windows that fill them."""
    _card()
    g_max, r_max = limits
    g, _ = genome
    rng = np.random.default_rng(g_max + r_max)
    items = _gap_items(g, rng, 12, 5 * g_max - 20, r_max - 3)
    count = _gap_both(items, g_max, r_max, 16, 4096)
    assert int(count.max()) > 0


@pytest.mark.cuda
def test_gap_anchors_windows_near_2_30(genome):
    """Windows that start within 5 g_max of 2^30 (the genome entries carry
    into the std bit) have their kept pairs merged by JAX's emission key,
    in one launch with items that do not."""
    _card()
    g, _ = genome
    rng = np.random.default_rng(35)
    near = _gap_items(g, rng, 8, 4000, 3000, gpos_hi=(1 << 30) - 2000)
    far = _gap_items(g, rng, 8, 4000, 3000)
    count = _gap_both(near + far, 1024, 4096, 16, 2048)
    assert int(count[:8].max()) > 0 and int(count[8:].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("m_out", [1, 100, 300])
def test_gap_anchors_near_2_30_past_m_out(genome, m_out):
    """Windows near 2^30 and below 0, whose kept pairs are merged into the
    output row by key a round of 256 at a time, with more kept pairs than
    m_out: the row keeps the first m_out by key, as JAX's argsort does."""
    _card()
    g, _ = genome
    rng = np.random.default_rng(37 + m_out)
    near = _gap_items(g, rng, 6, 5000, 4000, gpos_hi=(1 << 30) - 3000)
    below = _gap_items(g, rng, 4, 3000, 2500, gpos_hi=-1200)
    count = _gap_both(near + below, 1024, 4096, 16, m_out)
    assert int(count.max()) > m_out


@pytest.mark.cuda
def test_seed_superchunk_past_4096_slots(genome):
    """m_out 8,192, JAX's default: rows whose probe passes 4,096 slots keep
    the rest in the device scratch."""
    _card()
    from linear_tpu_torch.ops import seeding as SD

    g, _ = genome
    idx = DI.build_dindex([g], 4)
    index = SD.upload_index(idx.dir, idx.hs, "cuda")
    rng = np.random.default_rng(36)
    reads = [g[p: p + 120000].copy()
             for p in rng.integers(0, len(g) - 120000, 6)]
    wire, _ = SD.pack_superchunk(reads, 131072, 8)
    w = torch.from_numpy(wire).cuda()
    for m_out in (8192, 5000):
        got = SD.seed_superchunk(w, index, m_out).cpu().numpy()
        want = SD.seed_superchunk_reference(w, index.dir_start, index.hs,
                                            index.cap, m_out).cpu().numpy()
        count = want[:, -1] & 0xFFFFFFFF
        assert np.array_equal(got[:, -1], want[:, -1])
        for b in range(len(want)):
            assert np.array_equal(got[b, : count[b]], want[b, : count[b]])
        assert int((want[:, -1] >> 32).max()) > 4096


@pytest.mark.cuda
def test_windowed_dp_edge_scores_at_branch_edges():
    """The kernel's 32-bit, branch-free edge scores against the plain
    version's: rows of two anchors from pairs at the score functions'
    branch edges (dy near 5, 10, 2,250 and 150,000, da near 10, 30, the
    denominator and 2^25, anchor-x near 0 and 2^30, high bits set), whose
    second column's score is the edge's score when it is positive."""
    _card()
    pairs = adversarial_pairs(np.random.default_rng(37), 8192)
    arr = np.zeros((len(pairs), 2), np.int64)
    arr[:, :] = pairs
    cnt = np.full(len(pairs), 2, np.int32)
    for score_type in (0, 1):
        out = _windowed_both(arr, cnt, 64, score_type)
        assert (out[1][:, 1] > 0).sum() > 300


# ------------------------------------------------- anchor sort, seed kernel


def _sort_rows(rng, n, kept_counts):
    """Rows of n slots with random anchors (strands, x and y fields, some
    anchor-x ties) and the given numbers of kept slots; a count of -1 keeps
    each chunk's first and last flag."""
    from linear_tpu_torch.ops import chain_dp as CD

    B = len(kept_counts)
    anc = ((rng.integers(0, 2, (B, n)) << 61)
           | (rng.integers(1 << 21, (1 << 21) + 4096, (B, n)) << 20)
           | rng.integers(0, 1 << 10, (B, n))).astype(np.int64)
    keep = np.zeros((B, n), dtype=bool)
    for b, k in enumerate(kept_counts):
        if k < 0:
            edges = np.arange(0, n, CD.SORT_CHUNK)
            keep[b, np.concatenate([edges, np.minimum(edges + CD.SORT_CHUNK,
                                                      n) - 1])] = True
        else:
            keep[b, rng.choice(n, k, replace=False)] = True
    return anc, keep


def _sort_both(anc, keep, n_max):
    from linear_tpu_torch.ops import chain_dp as CD

    got = CD.sort_anchors(anc, keep, n_max)
    want = CD.sort_anchors_reference(anc, keep, n_max)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("n_max", [256, 8192, 30000])
def test_sort_anchors_at_the_shared_capacity(n_max):
    """Rows of 3 chunks and a ragged tail: K one under, at and one over the
    1,024 items a row sorts in registers (past them: in place in the
    scratch) and the 8,192 of a shared-memory tile (past them: a merge in
    global memory), every slot kept, nothing kept, kept slots on each
    chunk's first and last flag, and K = n_max - 1, n_max, n_max + 1."""
    _card()
    from linear_tpu_torch.ops import chain_dp as CD

    n = 3 * CD.SORT_CHUNK + 77
    ks = [CD.SORT_TILE - 1, CD.SORT_TILE, CD.SORT_TILE + 1, n, 0, -1, 1023,
          1024, 1025, 1]
    ks += [k for k in (n_max - 1, n_max, n_max + 1) if k <= n]
    anc, keep = _sort_rows(np.random.default_rng(n_max), n, ks)
    _, count = _sort_both(torch.from_numpy(anc).cuda(),
                          torch.from_numpy(keep).cuda(), n_max)
    assert count.tolist()[:4] == [min(k, n_max) for k in ks[:4]]


@pytest.mark.cuda
def test_sort_anchors_all_kept_grid_row():
    """The scan grid's width (544 positions x cap 352 = 191,488 slots) with
    every slot kept and few distinct anchor-x: the in-place branch over
    the whole row."""
    _card()
    rng = np.random.default_rng(51)
    n = 544 * 352
    anc, keep = _sort_rows(rng, n, [n, 20000])
    anc[0] = ((rng.integers(1 << 21, (1 << 21) + 32, n) << 20)
              | rng.integers(0, 32, n)).astype(np.int64)
    for n_max in (256, 8192):
        _sort_both(torch.from_numpy(anc).cuda(), torch.from_numpy(keep).cuda(),
                   n_max)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 5, 8])
def test_sort_anchors_on_a_keep_view_not_16_aligned(offset):
    """keep a contiguous view `offset` bytes into its buffer and rows of a
    width that is no multiple of 16: every row's flags start off a 16-byte
    boundary, so the flag pass loads ragged heads and tails by bytes."""
    _card()
    rng = np.random.default_rng(52 + offset)
    B, n = 5, 2 * 8192 + 13
    anc, keep = _sort_rows(rng, n, [300, 0, n, -1, 9000])
    buf = torch.zeros(B * n + offset, dtype=torch.bool, device="cuda")
    kv = buf[offset:].view(B, n)
    kv.copy_(torch.from_numpy(keep))
    assert kv.data_ptr() % 16
    for n_max in (256, 8192):
        _sort_both(torch.from_numpy(anc).cuda(), kv, n_max)


def _seed_both(index, w, m_out):
    from linear_tpu_torch.ops import seeding as SD

    got = SD.seed_superchunk(w, index, m_out).cpu().numpy()
    want = SD.seed_superchunk_reference(w, index.dir_start, index.hs,
                                        index.cap, m_out).cpu().numpy()
    count = want[:, -1] & 0xFFFFFFFF
    assert np.array_equal(got[:, -1], want[:, -1])
    for b in range(len(want)):
        assert np.array_equal(got[b, : count[b]], want[b, : count[b]])
    return want


@pytest.fixture(scope="module")
def seed_index(genome):
    _card()
    from linear_tpu_torch.ops import seeding as SD

    g, _ = genome
    idx = DI.build_dindex([g], 4)
    return SD.upload_index(idx.dir, idx.hs, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m_out", [1, 4096, 4097, 8192])
def test_seed_superchunk_pad_131072(genome, seed_index, m_out):
    """Rows of pad 131,072 (the largest row staged in shared memory) with
    reads of 100-131 kb, at m_out 1, the 4,096 slots a row keeps in shared
    memory, one past them, and JAX's default 8,192."""
    _card()
    from linear_tpu_torch.ops import seeding as SD

    g, _ = genome
    rng = np.random.default_rng(53)
    lens = [131072, 131071, 100000, 120001, 57, 56]
    reads = [g[p: p + ln].copy() for p, ln in
             zip(rng.integers(0, len(g) - 131072, len(lens)), lens)]
    wire, _ = SD.pack_superchunk(reads, 131072, 8)
    want = _seed_both(seed_index, torch.from_numpy(wire).cuda(), m_out)
    assert int((want[:, -1] >> 32).max()) > min(m_out, 4097)


@pytest.mark.cuda
@pytest.mark.parametrize("pad,offset", [(8192, 0), (4080, 0), (8192, 3),
                                        (262144, 0)])
def test_seed_superchunk_row_bytes_and_alignment(genome, seed_index, pad,
                                                 offset):
    """Rows of 2,056 bytes (8192 bases: 8-byte aligned, not 16), of 1,028
    (4,080 bases: the rows after the first are not 8-byte aligned and their
    last base word is partial), a wire 3 bytes into its buffer, and rows
    of 262,144 bases (staged in the device scratch), with reads of 55-65
    bases and reads ending mid-byte."""
    _card()
    from linear_tpu_torch.ops import seeding as SD

    g, _ = genome
    rng = np.random.default_rng(54 + pad + offset)
    lens = [55, 56, 57, 63, 64, 65, min(pad, 7001), min(pad, 190_001), 3001]
    reads = [g[p: p + ln].copy() for p, ln in
             zip(rng.integers(0, len(g) - max(lens), len(lens)), lens)]
    wire, _ = SD.pack_superchunk(reads, max(pad, 4096), 12)
    if pad == 4080:
        wire = np.ascontiguousarray(np.concatenate(
            [wire[:, : pad // 4], wire[:, -8:]], axis=1))
    buf = torch.zeros(wire.size + offset, dtype=torch.uint8, device="cuda")
    w = buf[offset:].view(wire.shape)
    w.copy_(torch.from_numpy(wire))
    for m_out in (128, 512):
        _seed_both(seed_index, w, m_out)


@pytest.mark.cuda
def test_seed_superchunk_both_block_shapes(genome, seed_index):
    """The same reads in launches of 792 rows and of 1,024 (past the small
    grid: the 128-thread blocks), reads of 55 bases to the pad: every row
    equal to the plain version, and a row the same in both launches."""
    _card()
    from linear_tpu_torch.ops import seeding as SD

    g, _ = genome
    rng = np.random.default_rng(55)
    lens = np.concatenate([[55, 56, 57, 8192], rng.integers(58, 8193, 1020)])
    reads = [g[p: p + ln].copy() for p, ln in
             zip(rng.integers(0, len(g) - 8192, len(lens)), lens)]
    wire, _ = SD.pack_superchunk(reads, 8192, 1024)
    w = torch.from_numpy(wire).cuda()
    for m_out in (128, 512):
        big = _seed_both(seed_index, w, m_out)
        small = _seed_both(seed_index, w[:792].contiguous(), m_out)
        assert np.array_equal(big[:792, -1], small[:, -1])


# ------------------------------------------------- K3 and the banded score


def compact_rows(rng, n, m_out, chunk):
    """Rows of n slots (random non-zero anchors) for the compaction: nothing
    kept, every slot kept, a random 30 %, each chunk's first and last flag,
    then, where the row has room, kept counts m_out - 1, m_out and m_out + 1
    whose m_out-th kept slot is the last flag of chunk 0 and then the first
    of chunk 1."""
    rows = [np.zeros(n, bool), np.ones(n, bool), rng.random(n) < 0.3]
    edges = np.arange(0, n, chunk)
    k = np.zeros(n, bool)
    k[np.concatenate([edges, np.minimum(edges + chunk, n) - 1])] = True
    rows.append(k)
    for at in (chunk - 1, chunk):
        if m_out - 1 > at or at + 1 >= n:
            continue
        for extra in (-1, 0, 1):
            k = np.zeros(n, bool)
            k[rng.choice(at, m_out - 1, replace=False)] = True
            if extra >= 0:
                k[at] = True
            if extra > 0:
                k[int(rng.integers(at + 1, n))] = True
            rows.append(k)
    keep = np.stack(rows)
    anc = rng.integers(1, 1 << 62, keep.shape).astype(np.int64)
    return anc, keep


def _compact_both(anc, keep, m_out):
    from linear_tpu_torch.ops import seeding as SD

    before = SD.compact_launches
    got = SD.compact_anchors(anc, keep, m_out)
    assert SD.compact_launches == before + 1
    want = SD.compact_anchors_reference(anc, keep, m_out)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16383, 16384, 16385, 3 * 16384 + 77])
def test_compact_at_chunk_edges(n):
    """K3 on rows of one chunk less one flag, one chunk, one more, and three
    chunks and a ragged tail: nothing kept, every slot kept, each chunk's
    first and last flag, counts m_out - 1, m_out and m_out + 1 whose
    m_out-th kept slot sits on the boundary of chunks 0 and 1, and m_out
    past n."""
    _card()
    from linear_tpu_torch.ops import seeding as SD

    rng = np.random.default_rng(n)
    for m_out in (1, 100, 8192, n + 5):
        anc, keep = compact_rows(rng, n, m_out, SD.COMPACT_CHUNK)
        _, count = _compact_both(torch.from_numpy(anc).cuda(),
                                 torch.from_numpy(keep).cuda(), m_out)
        assert count.tolist()[:2] == [0, n]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 5, 8])
def test_compact_on_a_keep_view_not_16_aligned(offset):
    """keep a contiguous view `offset` bytes into its buffer, rows of a
    width that is no multiple of 16: each row's flags start off a 16-byte
    boundary, so the chunks load ragged heads and tails by bytes."""
    _card()
    from linear_tpu_torch.ops import seeding as SD

    rng = np.random.default_rng(60 + offset)
    n = 2 * SD.COMPACT_CHUNK + 13
    anc, keep = compact_rows(rng, n, 300, SD.COMPACT_CHUNK)
    buf = torch.zeros(keep.size + offset, dtype=torch.bool, device="cuda")
    kv = buf[offset:].view(keep.shape)
    kv.copy_(torch.from_numpy(keep))
    assert kv.data_ptr() % 16
    for m_out in (256, 8192):
        _compact_both(torch.from_numpy(anc).cuda(), kv, m_out)


def banded_edge_pairs(rng, W):
    """Pairs at the banded score's edges: an empty query (n = 0), an empty
    reference (m = 0), a query longer than the reference by more than W
    (the band leaves the matrix), a reference far longer than the query,
    identical sequences, all mismatches, N against N, and a mutated pair."""
    base = rng.integers(0, 4, 90).astype(np.uint8)
    mut = base.copy()
    mut[rng.random(len(mut)) < 0.1] = 3
    qry = [np.zeros(0, np.uint8), base[:40],
           rng.integers(0, 4, 12 + W + 9).astype(np.uint8), base[:15],
           base, np.zeros(70, np.uint8), np.full(50, 4, np.uint8), mut]
    ref = [base[:50], np.zeros(0, np.uint8), base[:12],
           np.concatenate([rng.integers(0, 4, 200).astype(np.uint8), base]),
           base.copy(), np.ones(80, np.uint8), np.full(60, 4, np.uint8),
           np.concatenate([rng.integers(0, 4, 7).astype(np.uint8), base])]
    return qry, ref


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 15, 16, 17, 31, 32, 33, 100, 513])
def test_banded_edges(W):
    """The banded score at band widths around a lane's and a warp's
    diagonals (one warp a pair up to KW 256, then several with one barrier
    a row) on the edge pairs: every score equal to the plain version."""
    _card()
    from linear_tpu_torch.ops import align_pallas as AP

    qry, ref = banded_edge_pairs(np.random.default_rng(W), W)
    args = [torch.from_numpy(x).cuda() for x in AP.pack_pairs(qry, ref, W)]
    before = AP.launches
    got = AP.banded_align(*args, W)
    assert AP.launches == before + 1
    assert torch.equal(got, AP.banded_align_reference(*args, W))


# ------------------------------------------ the wide branch, near and far


@pytest.mark.cuda
@pytest.mark.parametrize("W,L", [(16385, None), (1, 1 << 25), (100, 1 << 25),
                                 (600, 1 << 25), (26000, 1 << 15)])
def test_banded_wide_branch(W, L):
    """The banded kernel's wide branch: W 16,385 (one past the register
    design; the edge pairs include a query of W + 21 bases), rows of L =
    2^25 (the first length past it) at W 1, 100 and 600, and W 26,000 in
    rows of 2^15, whose ring of min(2W, L + W + 1) + 1 ints passes the
    shared-memory budget (the device scratch), against the plain
    version."""
    _card()
    from linear_tpu_torch.ops import _cuda
    from linear_tpu_torch.ops import align_pallas as AP

    qry, ref = banded_edge_pairs(np.random.default_rng(W + 3), W)
    args = [torch.from_numpy(x).cuda()
            for x in AP.pack_pairs(qry, ref, W, L)]
    assert W > AP.BANDED_MAX_W or args[0].shape[1] >= AP.BANDED_MAX_L
    scratch = _cuda.lib().lt_banded_align_scratch(len(qry), args[0].shape[1],
                                                  W)
    assert (scratch > 0) == (W == 26000)
    got = AP.banded_align(*args, W)
    want = AP.banded_align_reference(*args, W)
    assert torch.equal(got, want) and int(want.max()) > 100


def _full_both(arr, cnt, **kw):
    from linear_tpu_torch.ops import chain_dp as CD

    a, c = torch.from_numpy(arr).cuda(), torch.from_numpy(cnt).cuda()
    got = CD.chain_dp(a, c, **kw)
    want = CD.chain_dp_reference(a, c, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    return [t.cpu().numpy() for t in want]


@pytest.mark.cuda
@pytest.mark.parametrize("depths", [(20, 300), (100, 50)],
                         ids=["default", "depth_past_64"])
def test_full_dp_across_the_near_far_boundary(depths):
    """Rows whose winning totals tie across lookback 64 (clusters of 40
    and 70 equal anchors, and of up to 16), both score types, at the
    default depths and at a depth of 100 (past the chain's 64 lookbacks:
    the depth term then admits far j too): every column equal to the plain
    version; the far part's smaller j wins the ties."""
    _card()
    for score_type in (0, 1):
        for arr, cnt in (straddle_rows(4, 512), tied_rows(64, 4, 512)):
            p2 = _full_both(arr, cnt, thd_chain_depth=depths[0],
                            thd_chain_dx_depth=depths[1],
                            score_type=score_type)[0]
            assert (p2 >= 0).sum() > 500


@pytest.mark.cuda
@pytest.mark.parametrize("N", [18944, 18945])
def test_full_dp_at_the_shared_memory_limit(N):
    """The full DP at N 18,944 (its tables, 12 bytes a column, the last
    width in shared memory beside the tiles) and 18,945 (the first in the
    device scratch): a chain of N anchors, 3,000 of them shuffled with a
    padded tail of distinct anchors (no column copies another), and an
    empty row."""
    _card()
    rng = np.random.default_rng(N)
    chain = [_anchor(900000 - 20 * k, 900000 - 20 * k) for k in range(N)]
    arr, cnt = _pack_rows([chain, [chain[k] for k in rng.permutation(3000)],
                           []], N)
    arr[1, 3000:] = rng.integers(0, 1 << 50, N - 3000)
    out = _full_both(arr, cnt)
    assert out[2][0, N - 1] == N and out[1][0, N - 1] == 100 * (N - 1)


@pytest.mark.cuda
def test_gap_anchors_filter_empties_items(genome):
    """Items whose read windows hold only T (val 2^18 - 1, which no sample
    of these genome windows has: the hashed bitmap filter drops every read
    9-mer, and vmax comes from them alone), beside items whose read windows
    end in T and ordinary ones: the kernel against the plain version. (The
    windows starting below 0, whose entries sit in the group of the val
    below their own, are test_gap_anchors_near_2_30_past_m_out's.)"""
    _card()
    g, _ = genome
    rng = np.random.default_rng(39)
    items = _gap_items(g, rng, 12, 3000, 2500)
    for t, it in enumerate(items[:8]):
        rw = it["rwin"].copy()
        if t < 4:
            rw[:] = 3
        else:
            rw[-28:] = 3
        it["rwin"] = rw
    count = _gap_both(items, 1024, 4096, 16, 2048)
    # (odd items are bounded to a diagonal band their reads miss)
    assert not count[:4].any() and (count[4::2] > 0).all()
