"""The synthetic inputs of linear_tpu_torch/kernel_times.py: what each case
claims to feed its kernel (the timing itself needs the card)."""
import numpy as np
import pytest
import torch

from linear_tpu_torch import kernel_times as KT
from linear_tpu_torch.ops import chain_dp as CD


@pytest.mark.parametrize("lo,hi,read_len", [(65, 512, 7000),
                                            (513, 2000, 120_000)])
def test_chain_rows_sorted_by_anchor_x_and_chained(lo, hi, read_len):
    rng = np.random.default_rng(lo)
    rows = KT.chain_rows(rng, 6, lo, hi, read_len)
    arr, cnt = KT.pad_rows(rows, hi)
    a, c = torch.from_numpy(arr), torch.from_numpy(cnt)
    x = CD._anchor_x(a)
    for k, n in enumerate(cnt):
        assert lo <= n <= hi
        assert bool((x[k, : n - 1] >= x[k, 1:n]).all())
    p2, _, length, _ = CD.chain_dp_windowed_reference(a, c)
    # the true hits (three quarters of a row) chain along the diagonal
    assert int((p2 >= 0).sum()) >= cnt.sum() // 2
    assert int(length.max()) > lo // 2


def test_gap_items_near_2_30_fill_the_tables():
    from linear_tpu_torch.ops import gap_dev as GD

    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 60_000).astype(np.uint8)
    items = KT.gap_items(rng, genome, 4, near=True)
    packed = GD.pack_items(items)
    gpos0, g_n, r_n = packed[2], packed[1], packed[4]
    assert ((gpos0 > (1 << 30) - 5 * 1024) & (gpos0 < 1 << 30)).all()
    assert (g_n == 5120).all() and (r_n == 4096).all()


def test_band_pairs_fit_the_band():
    from linear_tpu_torch.ops import align_pallas as AP

    rng = np.random.default_rng(4)
    qry, ref = KT.band_pairs(rng, 5)
    assert all(200 - 15 <= len(q) <= 7000 for q in qry)
    a, bpad, nm = (torch.from_numpy(x) for x in AP.pack_pairs(qry, ref, 100))
    assert a.shape[1] <= 7040
    # a copy with 10 % substitutions scores well above 0 in the band
    scores = AP.banded_align(a, bpad, nm, 100)
    assert bool((scores > nm[:, 0]).all())


def test_seed_corpus_feeds_the_seed_and_sort_cases():
    """The seed and sort cases' inputs at a small genome on the CPU: the
    DIndex built by the device build's plain version, reads of about 7 kb
    (some with N) on the corpus' wire, the scan grid at the corpus cap (544
    x 352 = 191,488 slots a row), and the seed case's digest view."""
    from linear_tpu_torch.ops import seeding as SD

    index, reads = KT.seed_corpus(np.random.default_rng(6), 300_000, 24,
                                  "cpu")
    assert index.dir_start.numel() == 4 ** 13 + 1 and index.hs.numel() > 1000
    assert all(6000 < len(r) < 8200 for r in reads)
    w = KT.seed_inputs(index, reads, 16, KT.CORPUS_PAD)
    assert tuple(w.shape) == (16, KT.CORPUS_PAD // 4 + 8)
    seqs, lens = SD._unpack_wire(w)
    assert lens.tolist() == [min(len(r), KT.CORPUS_PAD) for r in reads[:16]]
    n_rows = [bool((r == 4).any()) for r in reads[:16]]
    assert any(n_rows) and not seqs[n_rows].any()
    res = SD.seed_superchunk(w, index, 128)
    anc, tail = KT.defined_seeds(res)
    count = (tail & 0xFFFFFFFF).numpy()
    assert (tail >> 32).max() > 128 and count.max() > 0
    for b in range(16):
        assert not anc[b, count[b]:].any()
        assert torch.equal(anc[b, : count[b]], res[b, : count[b]])
    a, keep = KT.sort_inputs(index, reads, 4, KT.CORPUS_PAD, KT.SORT_CAP)
    assert tuple(a.shape) == (4, 544, 352) and a[0].numel() == 191_488
    assert 0 < int(keep.sum()) < keep.numel() // 100


def test_wide_rows_feed_the_12288_case():
    """The full DP's (4, 12,288) case: two long-read rows sorted by
    anchor-x, one chain of 12,288 anchors (every column chained, score 100
    a link) and 3,000 of them shuffled; the chain's first columns through
    the plain full DP."""
    rows = KT.wide_rows(np.random.default_rng(2))
    arr, cnt = KT.pad_rows(rows, KT.WIDE_N)
    assert arr.shape == (4, 12288) and cnt[2] == 12288 and cnt[3] == 3000
    a = torch.from_numpy(arr)
    x = CD._anchor_x(a)
    for b in range(3):
        n = cnt[b]
        assert bool((x[b, : n - 1] >= x[b, 1:n]).all())
    assert not bool((x[3, :2999] >= x[3, 1:3000]).all())
    head = a[2:3, :300].clone()
    p2, score, length = CD.chain_dp_reference(
        head, torch.tensor([300], dtype=torch.int32))
    assert p2[0, 1:].tolist() == list(range(299))
    assert score[0, 299] == 100 * 299 and length[0, 299] == 300


def test_wide_rows_feed_the_scratch_case():
    """The full DP's (4, 20,480) case: past the 18,944 anchors a row whose
    tables fit the kernel's shared memory; one chain of 20,480 anchors,
    sorted by anchor-x, and 3,000 of them shuffled."""
    rows = KT.wide_rows(np.random.default_rng(10), KT.SCRATCH_N)
    arr, cnt = KT.pad_rows(rows, KT.SCRATCH_N)
    assert KT.SCRATCH_N > 18944
    assert arr.shape == (4, KT.SCRATCH_N) and cnt[2] == KT.SCRATCH_N
    x = CD._anchor_x(torch.from_numpy(arr))
    assert bool((x[2, :-1] > x[2, 1:]).all()) and cnt[3] == 3000


def test_banded_wide_case_fits_the_wide_branch():
    """The banded W 16,385 case: 16 of the pairs cut to 1,000 bases take
    the kernel's wide branch, and its statement (banded_align_ring, held to
    the plain version and JAX in test_torch_align_pallas.py) scores them
    all above 0."""
    from linear_tpu_torch.ops import align_pallas as AP

    qry, ref = KT.band_pairs(np.random.default_rng(4), 16)
    W = KT.BANDED_WIDE_W
    a, bpad, nm = (torch.from_numpy(x) for x in AP.pack_pairs(
        [q[:1000] for q in qry], [r[:1000] for r in ref], W))
    assert W > AP.BANDED_MAX_W  # the wide branch
    assert a.shape == (16, 1024) and bpad.shape == (16, 1024 + 2 * W)
    assert bool((AP.banded_align_ring(a, bpad, nm, W) > 0).all())
