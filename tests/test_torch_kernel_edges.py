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
