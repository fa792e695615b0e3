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
