"""linear_tpu_torch.ops.seeding against linear_tpu: the plain PyTorch
seeding (what a CPU tensor runs) against the JAX kernel
`_seed_superchunk_fused` on JAX-CPU and against the host oracle
`query_anchors`, on the same wire. All comparisons are exact integer
equality (tolerance 0) on the defined part of each output row:
anchors[:count] and the tail column count | probed << 32."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_native_ready  # noqa: F401  (the JAX package's libraries)
from linear_tpu.index import dindex as JDI
from linear_tpu.ops import seeding as JSD
from linear_tpu_torch.map.mapper import Mapper, MapperConfig
from linear_tpu_torch.ops import seeding as SD
from linear_tpu_torch.utils import seqio

PAD = 4096


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 30000).astype(np.uint8)
    # a repeat so some buckets hold several entries and reads overflow m_out
    genome[20000:22000] = genome[2000:4000]
    # low-complexity runs: tied minimizer candidates and an all-A bucket 0
    genome[5000:5080] = 0
    genome[9000:9120] = np.tile(np.array([1, 3], np.uint8), 60)
    genome[12000:12060] = 2
    idx = JDI.build_dindex([genome], threads_emul=4)
    return rng, genome, idx, JSD.upload_index(idx), SD.upload_index(
        idx.dir, idx.hs, "cpu")


def _reads(rng, genome, lens, n_read=None, starts=None):
    reads = []
    for i, ln in enumerate(lens):
        pos = (int(rng.integers(0, len(genome) - ln)) if starts is None
               else starts[i])
        r = genome[pos: pos + ln].copy()
        sub = rng.random(ln) < 0.05
        r[sub] = (r[sub] + 1) % 4
        if i % 2:
            r = seqio.revcomp(r)
        reads.append(r)
    if n_read is not None:
        reads[n_read] = reads[n_read].copy()
        reads[n_read][len(reads[n_read]) // 3] = 4
    return reads


def _jax_fused(wire, jdev, m_out):
    return np.asarray(JSD._seed_superchunk_fused(
        jnp.asarray(wire), jdev.dir_start, jdev.hs_lo, jdev.hs_hi,
        JSD.SPAN, JSD.WEIGHT, JSD.THD_ALPHA, jdev.cap, m_out))


def _assert_defined_equal(got, want):
    assert np.array_equal(got[:, -1], want[:, -1])
    for r in range(want.shape[0]):
        c = int(want[r, -1] & 0xFFFFFFFF)
        assert np.array_equal(got[r, :c], want[r, :c]), f"row {r}"


# rows: forward and reverse reads, lengths 201..PAD including exactly PAD,
# an N row, and padding rows (rows > reads)
CASES = {
    "mixed": dict(lens=[201, 202, 333, 1024, 2500, PAD, 3999, 777, 64],
                  rows=12, n_read=3),
    "short": dict(lens=[201, 250, 300, 57], rows=4, n_read=None),
    "long": dict(lens=[PAD, PAD - 1, 4000, 3500], rows=8, n_read=0),
    # reads starting on or just before the low-complexity runs
    "repeats": dict(lens=[600, 700, 900, 1500, 800, 2000], rows=6,
                    n_read=None,
                    starts=[4990, 5000, 8985, 8999, 11990, 12000]),
}


@pytest.mark.parametrize("m_out", [8, 128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_fused(world, case, m_out):
    rng, genome, idx, jdev, tdev = world
    spec = CASES[case]
    reads = _reads(np.random.default_rng(len(case) * 7 + m_out), genome,
                   spec["lens"], spec["n_read"], spec.get("starts"))
    wire, _ = SD.pack_superchunk(reads, PAD, spec["rows"])
    got = SD.seed_superchunk(torch.from_numpy(wire), tdev, m_out).numpy()
    assert got.shape == (spec["rows"], m_out + 1)
    _assert_defined_equal(got, _jax_fused(wire, jdev, m_out))


def test_first_column_edge_cases(world):
    """Exact reads for the p = 0 column: 21 T then 40 A make the mixed
    window b[14..20) ++ b[41..56) forward with an all-A minimizer (xval 0,
    equal to the dedup's initial 0, so not probed); homopolymer starts tie
    all nine candidates."""
    rng, genome, idx, jdev, tdev = world
    tail = genome[22000:23000]
    reads = [np.concatenate([np.full(21, 3, np.uint8), np.zeros(40, np.uint8),
                             tail]),
             np.concatenate([np.zeros(90, np.uint8), tail]),
             np.concatenate([np.full(90, 2, np.uint8), tail]),
             seqio.revcomp(np.concatenate([np.zeros(90, np.uint8), tail]))]
    wire, _ = SD.pack_superchunk(reads, 2048, 4)
    for m_out in (8, 128):
        got = SD.seed_superchunk(torch.from_numpy(wire), tdev, m_out).numpy()
        _assert_defined_equal(got, _jax_fused(wire, jdev, m_out))
    # one entry in the (here empty) all-A bucket 0: a p = 0 probe of read 0
    # would find it
    dir0 = idx.dir.copy()
    dir0[1:] += 1
    hs0 = np.concatenate([idx.hs[:1], idx.hs])
    jdev0 = JSD.upload_index(JDI.DIndex(idx.span, idx.weight, dir0, hs0))
    got0 = SD.seed_superchunk(torch.from_numpy(wire),
                              SD.upload_index(dir0, hs0, "cpu"), 128).numpy()
    _assert_defined_equal(got0, _jax_fused(wire, jdev0, 128))
    assert np.array_equal(got0[:, -1], got[:, -1])
    for r, row in zip(reads, got):
        host = JDI.query_anchors(idx, r, 0, len(r), thd_alpha=15)
        if row[-1] >> 32 <= 128:
            assert row[: row[-1] & 0xFFFFFFFF].view(np.uint64).tolist() == \
                host.tolist()


def _jax_states(wire):
    """JAX's _minimizer_xy_strided (with its exact mixed first column) on
    the wire's unpacked bases, as batch_seed_anchors_compact calls it."""
    b = wire[:, :-8].astype(np.int32)
    seqs = np.stack([(b >> (2 * i)) & 3 for i in range(4)],
                    axis=-1).reshape(len(wire), -1)
    L = seqs.shape[1]
    ks = np.arange(JSD.SPAN + JSD.THD_ALPHA - 1, L, JSD.THD_ALPHA)
    seqs_p = jnp.pad(jnp.asarray(seqs), ((0, 0), (0, JSD.SPAN + 8)))
    xv, yv, st, _ = JSD._minimizer_xy_strided(
        seqs_p, int(ks[0]), len(ks), JSD.SPAN, JSD.WEIGHT, JSD.THD_ALPHA,
        int((ks < 2 * JSD.SPAN - 1).sum()))
    return np.asarray(xv), np.asarray(yv), np.asarray(st)


# the seed kernel's word arithmetic at its edges: reads of 55-57 and 63-65
# bases (the first call position comes in at 57; a window's last word), a
# read ending mid-byte, the p = 0 mix window (21 T then 40 A: a forward
# all-A window whose hash keeps b[14..20)), homopolymer starts (nine tied
# candidates), and rows of pad 131,072
WORD_CASES = {
    "short": dict(lens=[55, 56, 57, 63, 64, 65], pad=1024),
    "mid_byte": dict(lens=[1021, 1022, 1023, 999], pad=1024),
    "mix_window": dict(lens=[], pad=2048),
    "pad_131072": dict(lens=[131072, 131071, 70001], pad=131072),
}


@pytest.mark.parametrize("case", sorted(WORD_CASES))
def test_word_states_match_reference_and_jax(world, case):
    """superchunk_states_from_words (the kernel's funnel shifts, 2-bit
    reversal and popcounts) equal to seed_superchunk_reference's states and
    to JAX's _minimizer_xy_strided at every call position, exactly."""
    rng, genome, idx, jdev, tdev = world
    spec = WORD_CASES[case]
    if case == "mix_window":
        tail = genome[22000:23000]
        reads = [np.concatenate([np.full(21, 3, np.uint8),
                                 np.zeros(40, np.uint8), tail]),
                 np.concatenate([np.zeros(90, np.uint8), tail]),
                 np.concatenate([np.full(90, 2, np.uint8), tail]),
                 seqio.revcomp(np.concatenate([np.zeros(90, np.uint8),
                                               tail]))]
    elif case == "pad_131072":
        big = np.tile(genome, 5)
        reads = [big[p: p + n] for p, n in zip((0, 7, 30001), spec["lens"])]
    else:
        reads = _reads(np.random.default_rng(len(case)), genome,
                       spec["lens"])
    wire, _ = SD.pack_superchunk(reads, spec["pad"], len(reads) + 1)
    got = SD.superchunk_states_from_words(wire)
    ref = SD.superchunk_states_reference(torch.from_numpy(wire))
    jax_states = _jax_states(wire)
    for g, r, j in zip(got, ref, jax_states):
        assert np.array_equal(g, r.numpy())
        assert np.array_equal(g, j)
    if case == "mix_window":  # the p = 0 hash differs from the plain window
        assert got[0][0, 0] == 0


@pytest.mark.parametrize("m_out", [8, 128])
def test_plain_matches_host_oracle(world, m_out):
    rng, genome, idx, jdev, tdev = world
    reads = _reads(np.random.default_rng(5), genome,
                   [201, 500, 1500, 2500, 3000, PAD, 1200, 2200], n_read=2)
    wire, n_mask = SD.pack_superchunk(reads, PAD, 8)
    handle = SD.dispatch_wire(wire, tdev, m_out)
    got, overflow = SD.collect_wire(handle, len(reads), n_mask, m_out)
    assert n_mask.tolist() == [i == 2 for i in range(8)]
    n_checked = 0
    for i, r in enumerate(reads):
        host = JDI.query_anchors(idx, r, 0, len(r), thd_alpha=15)
        if n_mask[i]:
            assert got[i] is None and not overflow[i]
        elif overflow[i]:
            assert got[i] is None and len(host) > 0
        else:
            assert got[i].tolist() == host.tolist(), f"read {i}"
            n_checked += 1
    assert n_checked > 0


def test_overflow_is_not_an_n_read(world):
    """probed > m_out flags overflow (a tier-2 redispatch), which differs
    from the N-read drop."""
    rng, genome, idx, jdev, tdev = world
    reads = _reads(np.random.default_rng(9), genome, [PAD, 3000, 2000])
    wire, n_mask = SD.pack_superchunk(reads, PAD, 3)
    fused = SD.seed_superchunk(torch.from_numpy(wire), tdev, 8).numpy()
    probed = fused[:, -1] >> 32
    assert (probed > 8).any()
    _, overflow = SD.collect_wire(SD.dispatch_wire(wire, tdev, 8), 3, n_mask, 8)
    assert overflow.tolist() == (probed > 8).tolist()
    assert not n_mask.any()


def test_wire_layout(world):
    """pad/4 bytes of LSB-first 2-bit bases, then 8 little-endian length
    bytes; rows of reads with N are zero on the wire."""
    rng = np.random.default_rng(3)
    reads = [rng.integers(0, 4, n).astype(np.uint8) for n in (1024, 1021, 5)]
    reads[1][7] = 4
    wire, n_mask = SD.pack_superchunk(reads, 1024, 4)
    assert wire.shape == (4, 1024 // 4 + 8)
    assert n_mask.tolist() == [False, True, False, False]
    seqs, lens = SD._unpack_wire(torch.from_numpy(wire))
    assert lens.tolist() == [1024, 1021, 5, 0]
    assert np.array_equal(seqs[0].numpy(), reads[0])
    assert not seqs[1].any() and not seqs[3].any()
    assert np.array_equal(seqs[2, :5].numpy(), reads[2])


def test_upload_index_matches_jax(world):
    rng, genome, idx, jdev, tdev = world
    assert tdev.cap == jdev.cap
    assert tdev.dir_start.dtype == torch.int32
    assert np.array_equal(tdev.dir_start.numpy(), np.asarray(jdev.dir_start))
    hs = tdev.hs.numpy().view(np.uint64)
    lo = np.asarray(jdev.hs_lo).astype(np.uint64)
    hi = np.asarray(jdev.hs_hi).astype(np.uint64)
    assert np.array_equal(hs, (hi << np.uint64(32)) | lo)
    assert np.array_equal(hs, idx.hs)


def test_wrapper_rejects_other_devices(world):
    rng, genome, idx, jdev, tdev = world
    wire, _ = SD.pack_superchunk([genome[:500]], 1024, 1)
    meta = SD.DeviceIndex(tdev.dir_start.to("meta"), tdev.hs.to("meta"),
                          tdev.cap)
    with pytest.raises(ValueError):
        SD.seed_superchunk(torch.from_numpy(wire).to("meta"), meta, 8)
    with pytest.raises(ValueError):  # wire and index on different devices
        SD.seed_superchunk(torch.from_numpy(wire), meta, 8)
    from linear_tpu_torch.ops import _cuda

    with pytest.raises(ValueError):  # the CUDA wrapper takes CUDA tensors only
        _cuda.seed_superchunk(torch.from_numpy(wire), tdev.dir_start, tdev.hs,
                              tdev.cap, 8)


def test_mapper_stream_matches_host_oracle(world, tmp_path):
    """Mapper._device_seed_stream2 on device cpu, with small superchunks so
    both m_out tiers and several superchunks run: every yielded read's
    anchors equal the host oracle's; None only for N reads and reads that
    overflow tier 2."""
    rng, genome, idx, jdev, tdev = world
    seqio.write_fasta(str(tmp_path / "g.fa"), ["chrH x"], [genome])
    m = Mapper([str(tmp_path / "g.fa")], MapperConfig(threads=4), device="cpu")
    m.SEED_SUPERCHUNK, m.SEED_SUPERCHUNK2 = 4, 2
    m.SEED_M_OUT, m.SEED_M_OUT2 = 16, 64
    m.prepare()
    assert np.array_equal(m.index.hs, idx.hs)
    reads = seqio.SeqSet()
    for i, r in enumerate(_reads(np.random.default_rng(11), genome,
                                 [150, 800, 1500, 2500, 3000, 600, 4000,
                                  2000, 1000, 201], n_read=4)):
        reads.ids.append(f"r{i}")
        reads.seqs.append(r)
    seen = {}
    # two chunks, as the pipeline's collector reads a block
    chunks = [(0, reads.seqs[:6]), (6, reads.seqs[6:])]
    tiers = set()
    for m_out, idxs, anchors in m._device_seed_stream2(chunks):
        tiers.add(m_out)
        for i, a in zip(idxs, anchors):
            assert i not in seen
            seen[i] = a
    assert tiers == {m.SEED_M_OUT, m.SEED_M_OUT2}
    assert sorted(seen) == [i for i, r in enumerate(reads.seqs) if len(r) > 200]
    n_seeded = 0
    for i, a in seen.items():
        r = reads.seqs[i]
        host = JDI.query_anchors(idx, r, 0, len(r), thd_alpha=15)
        if a is None:
            assert (r == 4).any() or len(host) > m.SEED_M_OUT2
        else:
            assert a.tolist() == host.tolist(), f"read {i}"
            n_seeded += 1
    assert n_seeded >= 5


def test_device_seeds_drive_the_engine(world, tmp_path):
    """The native engine fed device seeds (device cpu) writes the same SAM
    as when it seeds each read itself."""
    rng, genome, idx, jdev, tdev = world
    seqio.write_fasta(str(tmp_path / "g.fa"), ["chrH x"], [genome])
    m = Mapper([str(tmp_path / "g.fa")], MapperConfig(threads=4), device="cpu")
    m.prepare()
    reads = seqio.SeqSet()
    for i, r in enumerate(_reads(np.random.default_rng(13), genome,
                                 [2500, 3000, 1800, 900, 4000])):
        reads.ids.append(f"r{i} t")
        reads.seqs.append(r)
    seeds = [None] * len(reads)
    for _, idxs, anchors in m._device_seed_stream2([(0, reads.seqs)]):
        for i, a in zip(idxs, anchors):
            seeds[i] = a
    assert sum(s is not None for s in seeds) >= 4
    sam_dev = "".join(m.native_map_read(r, rid, seeds=s)[2]
                      for r, rid, s in zip(reads.seqs, reads.ids, seeds))
    m.reset_gap_parms()
    _, _, sam_host = m.map_block(reads)
    assert sam_dev and sam_dev == sam_host


@pytest.mark.cuda
@pytest.mark.parametrize("m_out", [8, 128])
def test_cuda_kernel_matches_plain(world, m_out):
    """The hand-written kernel against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs this check at the main path's shapes)")
    rng, genome, idx, jdev, tdev = world
    dev = SD.upload_index(idx.dir, idx.hs, "cuda")
    for spec in CASES.values():
        reads = _reads(np.random.default_rng(17), genome, spec["lens"],
                       spec["n_read"], spec.get("starts"))
        wire, _ = SD.pack_superchunk(reads, PAD, spec["rows"])
        w = torch.from_numpy(wire).cuda()
        got = SD.seed_superchunk(w, dev, m_out).cpu().numpy()
        want = SD.seed_superchunk_reference(w, dev.dir_start, dev.hs,
                                            dev.cap, m_out).cpu().numpy()
        _assert_defined_equal(got, want)
