"""The padded seeding of the multi-process path: linear_tpu_torch's plain
scan seeding (K1), closed-form seeding with and without an xval-shard mask
(K2) and anchor compaction (K3), and the host wrappers seed_anchors_batch,
against linear_tpu's batch_seed_anchors, batch_seed_anchors_fast,
_probe_and_anchor, _compact_anchors and seed_anchors_batch on JAX-CPU and
against the host oracle query_anchors. Reads are made with numpy from
fixed seeds: forward and reverse, with N bases (single, runs, a read that
starts with N, reads over a genome's N gaps), at and below the pad. Every
comparison is exact integer equality (tolerance 0): the keep masks whole,
anchors where keep is set (the port writes 0 elsewhere, JAX the unmasked
val2Anchor arithmetic), compacted rows up to their count."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_native_ready  # noqa: F401  (the JAX package's libraries)
from linear_tpu.index import dindex as JDI
from linear_tpu.ops import seeding as JSD
from linear_tpu.parallel import mesh as JMS
from linear_tpu_torch.index import dindex as DI
from linear_tpu_torch.ops import seeding as SD
from linear_tpu_torch.parallel import mesh as MS
from linear_tpu_torch.utils import seqio, simdata

L = 1024


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 30000).astype(np.uint8)
    # a repeat (buckets of several entries) and low-complexity runs
    genome[20000:22000] = genome[2000:4000]
    genome[5000:5080] = 0
    genome[9000:9120] = np.tile(np.array([1, 3], np.uint8), 60)
    idx = JDI.build_dindex([genome], threads_emul=4)
    return genome, idx, JSD.upload_index(idx), SD.upload_index(
        idx.dir, idx.hs, "cpu")


def _reads(genome, seed, lens, n_edits=True):
    rng = np.random.default_rng(seed)
    reads = []
    for i, ln in enumerate(lens):
        pos = int(rng.integers(0, len(genome) - ln))
        r = genome[pos: pos + ln].copy()
        sub = rng.random(ln) < 0.05
        r[sub] = (r[sub] + 1) % 4
        if i % 2:
            r = seqio.revcomp(r)
        reads.append(r)
    if n_edits:
        reads[1][100:103] = 4          # a short N run
        reads[2][len(reads[2]) // 2] = 4
        reads[3][:30] = 4              # hashInit moves past the first window
        reads[4][40:47] = 4            # N inside the first call's window
    return reads


LENS = [L, 900, 1000, 700, 400, 203, 56, 57, 1023, 77]


def _batch(reads):
    seqs, lens = SD.pad_reads(reads, L)
    return seqs, lens


def _assert_grid_equal(got, want):
    ga, gk = (t.numpy() for t in got)
    wa, wk = (np.asarray(t) for t in want)
    assert np.array_equal(gk, wk)
    assert np.array_equal(ga, np.where(wk, wa, 0))


@pytest.mark.parametrize("seed", [3, 4])
def test_scan_stream_matches_jax(world, seed):
    """The rolling-hash streams themselves, N bases and all."""
    genome = world[0]
    seqs, _ = _batch(_reads(genome, seed, LENS))
    got = SD._hash_scan_batch(torch.from_numpy(seqs))
    want = JSD._hash_scan_batch(jnp.asarray(seqs.astype(np.int32)), 21)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("seed,alpha", [(5, 15), (6, 15), (5, 7), (6, 5)])
def test_scan_matches_jax(world, seed, alpha):
    genome, idx, jdev, tdev = world
    seqs, lens = _batch(_reads(genome, seed, LENS))
    got = SD.batch_seed_anchors(torch.from_numpy(seqs), torch.from_numpy(lens),
                                tdev.dir_start, tdev.hs, tdev.cap, alpha)
    want = JSD.batch_seed_anchors(jnp.asarray(seqs), jnp.asarray(lens),
                                  jdev.dir_start, jdev.hs_lo, jdev.hs_hi,
                                  thd_alpha=alpha, cap=jdev.cap)
    _assert_grid_equal(got, want)
    assert got[1].sum() > 50


@pytest.mark.parametrize("alpha", [15, 5, 3])
@pytest.mark.parametrize("seed", [5, 7])
def test_fast_matches_jax(world, seed, alpha):
    """The closed form, N reads included (both add an N's 4 into the
    packs); thd_alpha 5 and 3 put 2 and 6 calls before k = 41, where the
    window still holds the init window's tail."""
    genome, idx, jdev, tdev = world
    seqs, lens = _batch(_reads(genome, seed, LENS))
    got = SD.batch_seed_anchors_fast(
        torch.from_numpy(seqs), torch.from_numpy(lens), tdev.dir_start,
        tdev.hs, tdev.cap, alpha)
    want = JSD.batch_seed_anchors_fast(jnp.asarray(seqs), jnp.asarray(lens),
                                       jdev.dir_start, jdev.hs_lo, jdev.hs_hi,
                                       thd_alpha=alpha, cap=jdev.cap)
    _assert_grid_equal(got, want)


@pytest.mark.parametrize("alpha", [15, 3])
def test_fast_equals_scan_without_n(world, alpha):
    genome, idx, jdev, tdev = world
    seqs, lens = _batch(_reads(genome, 8, LENS, n_edits=False))
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lens)
    fa, fk = SD.batch_seed_anchors_fast(s, ln, tdev.dir_start, tdev.hs,
                                        tdev.cap, alpha)
    sa, sk = SD.batch_seed_anchors(s, ln, tdev.dir_start, tdev.hs, tdev.cap,
                                   alpha)
    assert torch.equal(fk, sk) and torch.equal(fa, sa)


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_shard_index_matches_jax(world, n_shards):
    idx = world[1]
    dir_sh, hs_sh, xb, cap = MS.shard_index_by_xval(idx, n_shards)
    jdir, jlo, jhi, jxb, jcap = JMS.shard_index_by_xval(idx, n_shards)
    assert np.array_equal(dir_sh, jdir) and np.array_equal(xb, jxb)
    assert cap == jcap
    assert np.array_equal(hs_sh, (jhi.astype(np.uint64) << np.uint64(32))
                          | jlo.astype(np.uint64))


@jax.jit
def _jax_minimizers(js, lens):
    """JAX's closed-form states and minimizers at the call positions, as
    the shard_map bodies of linear_tpu/parallel/mesh.py compute them."""
    ks = jnp.arange(35, js.shape[1], 15, dtype=jnp.int64)
    kmat = jnp.broadcast_to(ks[None, :], (js.shape[0], ks.shape[0]))
    in_range = kmat < (lens[:, None] - 21)
    h, crh, x = JSD._closed_form_states(js, kmat, 21, n_mix=1)
    return (kmat, in_range) + JSD._minimizer_xy_batch(js, kmat, h, crh, x,
                                                      21, 13)


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_shard_mask_matches_jax(world, n_shards):
    """K2's probe of one xval shard against JAX's _probe_and_anchor with
    the same (x_base, x_hi) (the shard_map bodies of linear_tpu/parallel/
    mesh.py), and the shards' sum against the unsharded seeding."""
    genome, idx, jdev, tdev = world
    seqs, lens = _batch(_reads(genome, 9, LENS, n_edits=False))
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lens)
    dir_sh, hs_sh, xb, cap = MS.shard_index_by_xval(idx, n_shards)
    _, jlo, jhi, _, _ = JMS.shard_index_by_xval(idx, n_shards)
    kmat, in_range, xv, yv, st = _jax_minimizers(
        jnp.asarray(seqs.astype(np.int32)), jnp.asarray(lens))
    tot_a = tot_k = 0
    for sh in range(n_shards):
        got = SD.batch_seed_anchors_fast(
            s, ln, torch.from_numpy(dir_sh[sh].astype(np.int32)),
            torch.from_numpy(hs_sh[sh].view(np.int64)), cap,
            x_base=int(xb[sh, 0]), x_hi=int(xb[sh, 1]))
        want = JSD._probe_and_anchor(
            kmat, jnp.asarray(lens), xv, yv, st, jnp.asarray(dir_sh[sh]),
            jnp.asarray(jlo[sh]), jnp.asarray(jhi[sh]), cap, in_range,
            x_base=int(xb[sh, 0]), x_hi=int(xb[sh, 1]))
        _assert_grid_equal(got, want)
        tot_a = tot_a + got[0]
        tot_k = tot_k + got[1].int()
    fa, fk = SD.batch_seed_anchors_fast(s, ln, tdev.dir_start, tdev.hs,
                                        tdev.cap)
    assert torch.equal(tot_k > 0, fk) and torch.equal(tot_a, fa)
    assert int(tot_k.max()) == 1


@pytest.mark.parametrize("m_out", [1, 4, 64, 4096])
def test_compact_matches_jax(world, m_out):
    """K3 on the scan's grid: rows up to min(count, m_out) and the counts
    equal JAX's; the port's rows are 0 past that."""
    genome, idx, jdev, tdev = world
    seqs, lens = _batch(_reads(genome, 10, LENS))
    ja, jk = JSD.batch_seed_anchors(jnp.asarray(seqs), jnp.asarray(lens),
                                    jdev.dir_start, jdev.hs_lo, jdev.hs_hi,
                                    cap=jdev.cap)
    wc, wn = (np.asarray(t) for t in JSD._compact_anchors(ja, jk, m_out))
    anc = torch.from_numpy(np.where(np.asarray(jk), np.asarray(ja), 0))
    gc, gn = SD.compact_anchors(anc, torch.from_numpy(np.asarray(jk)), m_out)
    gc, gn = gc.numpy(), gn.numpy()
    assert gn.dtype == np.int32 and np.array_equal(gn, wn)
    for b in range(len(gn)):
        c = min(int(gn[b]), m_out)
        assert np.array_equal(gc[b, :c], wc[b, :c]), f"row {b}"
        assert not gc[b, c:].any()
    assert (gn > m_out).any() == (m_out <= 4)


def _host(idx, reads, alpha=15):
    return [[int(v) for v in DI.query_anchors(idx, r, 0, len(r),
                                              thd_alpha=alpha)] for r in reads]


@pytest.mark.parametrize("alpha", [15, 7])
@pytest.mark.parametrize("n_read", [True, False], ids=["with_n", "n_free"])
@pytest.mark.parametrize("m_out", [16, 8192])
def test_seed_anchors_batch_matches_jax_and_host(world, n_read, m_out, alpha):
    """K1 + K3 (a batch with N) or K2 + K3 (without): each read gives the
    host seeds or None (kept anchors over m_out), and so does JAX's."""
    genome, idx, jdev, tdev = world
    reads = _reads(genome, 11, [2500, 3000, 1800, 900, 4000, 1200],
                   n_edits=n_read)
    got = SD.seed_anchors_batch(reads, tdev, 4096, alpha, m_out)
    want = JSD.seed_anchors_batch(reads, jdev, 4096, alpha, m_out)
    host = _host(idx, reads, alpha)
    for i in range(len(reads)):
        assert got[i] is None or got[i] == host[i], f"read {i}"
        assert want[i] is None or want[i] == host[i], f"read {i}"
    if m_out == 8192:
        assert all(g is not None for g in got)
    else:
        assert any(g is None for g in got)


def test_device_test_case(world):
    """tests/test_device.py:46-53: N bases flow through the scan exactly."""
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 30000).astype(np.uint8)
    idx = JDI.build_dindex([genome], threads_emul=4)
    dev = SD.upload_index(idx.dir, idx.hs, "cpu")

    def mutate(seq):
        out, i = [], 0
        while i < len(seq):
            r = rng.random()
            if r < 0.04:
                out.append((int(seq[i]) + 1) % 4)
                i += 1
            elif r < 0.06:
                out.append(int(rng.integers(0, 4)))
            elif r < 0.08:
                i += 1
            else:
                out.append(int(seq[i]))
                i += 1
        return np.array(out, dtype=np.uint8)

    reads = []
    for i in range(4):
        pos = int(rng.integers(0, 25000))
        r = mutate(genome[pos:pos + 2500])
        if i % 2:
            r = seqio.revcomp(r)
        if i == 3:
            r = r.copy()
            r[100:103] = 4
        reads.append(r)
    got = SD.seed_anchors_batch(reads, dev, pad_len=4096)
    assert got == _host(idx, reads)


def test_reads_longer_than_the_pad_are_cut_as_in_jax(world):
    """seed_anchors_batch seeds a read's first pad_len bases, as JAX's."""
    genome, idx, jdev, tdev = world
    reads = _reads(genome, 12, [3000, 1500, 2600], n_edits=False)
    got = SD.seed_anchors_batch(reads, tdev, 2048)
    want = JSD.seed_anchors_batch(reads, jdev, 2048)
    assert got == want and got[1] == _host(idx, [reads[1]])[0]
    assert got[0] == _host(idx, [reads[0][:2048]])[0]


def test_reads_over_genome_n_gaps():
    """Reads simulated over a genome with assembly N gaps (the corpus
    generator): the scan path gives the host seeds."""
    rng = np.random.default_rng(42)
    genome = simdata.make_genomic_genome(rng, 300000)
    idx = DI.build_dindex([genome], 4)
    reads = [r for r in simdata.simulate_reads(rng, genome, 300, 3000)
             if (r == 4).any()]
    assert len(reads) >= 5
    got = SD.seed_anchors_batch(reads, SD.upload_index(idx.dir, idx.hs, "cpu"),
                                pad_len=8192)
    assert got == _host(idx, reads)


def test_wrappers_reject_other_devices(world):
    tdev = world[3]
    seqs = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    lens = torch.zeros((2,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        SD.batch_seed_anchors(seqs, lens, tdev.dir_start, tdev.hs, tdev.cap)
    with pytest.raises(ValueError):
        SD.batch_seed_anchors_fast(seqs, lens, tdev.dir_start.to("meta"),
                                   tdev.hs.to("meta"), tdev.cap)
    with pytest.raises(ValueError):
        SD.compact_anchors(torch.zeros((2, 3), dtype=torch.int64,
                                       device="meta"),
                           torch.zeros((2, 3), dtype=torch.bool,
                                       device="meta"), 4)


@pytest.mark.parametrize("kernel", ["seed", "compact"])
def test_cuda_launchers_reject_cpu_tensors(world, kernel):
    """The CUDA launchers check their tensors before building anything."""
    from linear_tpu_torch.ops import _cuda

    tdev = world[3]
    with pytest.raises(ValueError, match="CUDA tensors"):
        if kernel == "seed":
            _cuda.seed_anchors(torch.zeros((2, 64), dtype=torch.uint8),
                               torch.zeros((2,), dtype=torch.int64),
                               tdev.dir_start, tdev.hs, tdev.cap, 15, True)
        else:
            _cuda.compact_anchors(torch.zeros((2, 3), dtype=torch.int64),
                                  torch.zeros((2, 3), dtype=torch.bool), 4)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py phase 9 runs this check at the mesh "
                    "path's shapes)")


@pytest.mark.cuda
def test_cuda_scan_matches_plain(world):
    _cuda_or_skip()
    genome, idx = world[0], world[1]
    dev = SD.upload_index(idx.dir, idx.hs, "cuda")
    seqs, lens = (torch.from_numpy(a).cuda()
                  for a in _batch(_reads(genome, 5, LENS)))
    got = SD.batch_seed_anchors(seqs, lens, dev.dir_start, dev.hs, dev.cap)
    want = SD.batch_seed_anchors_reference(seqs, lens, dev.dir_start, dev.hs,
                                           dev.cap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 3])
def test_cuda_fast_matches_plain(world, n_shards):
    _cuda_or_skip()
    genome, idx = world[0], world[1]
    seqs, lens = (torch.from_numpy(a).cuda()
                  for a in _batch(_reads(genome, 9, LENS, n_edits=False)))
    dir_sh, hs_sh, xb, cap = MS.shard_index_by_xval(idx, n_shards)
    for sh in range(n_shards):
        d = torch.from_numpy(dir_sh[sh].astype(np.int32)).cuda()
        h = torch.from_numpy(hs_sh[sh].view(np.int64)).cuda()
        kw = dict(x_base=int(xb[sh, 0]), x_hi=int(xb[sh, 1]))
        got = SD.batch_seed_anchors_fast(seqs, lens, d, h, cap, **kw)
        want = SD.batch_seed_anchors_fast_reference(seqs, lens, d, h, cap,
                                                    **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("m_out", [4, 4096])
def test_cuda_compact_matches_plain(world, m_out):
    _cuda_or_skip()
    genome, idx = world[0], world[1]
    dev = SD.upload_index(idx.dir, idx.hs, "cuda")
    seqs, lens = (torch.from_numpy(a).cuda()
                  for a in _batch(_reads(genome, 10, LENS)))
    anc, keep = SD.batch_seed_anchors(seqs, lens, dev.dir_start, dev.hs,
                                      dev.cap)
    got = SD.compact_anchors(anc, keep, m_out)
    want = SD.compact_anchors_reference(anc, keep, m_out)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------- K1's closed form of the scan

from test_torch_kernel_edges import n_dense_reads  # noqa: E402

N_KINDS = list(n_dense_reads(np.zeros(4000, np.uint8),
                             np.random.default_rng(0)))


@pytest.mark.parametrize("tail", [0, 37], ids=["tight", "padded"])
@pytest.mark.parametrize("kind", N_KINDS)
def test_scan_states_closed_matches_jax(world, kind, tail):
    """_scan_states_closed (what kernel K1 computes at each call position,
    from the pre-pass's k0, init crh share and x bias) against JAX's
    _hash_scan_batch at every position k in [21, L), on reads of one kind
    (three reads, other cuts of the genome) in a row of the read's length or
    37 bases longer (zero padding, clamped reads past the row)."""
    genome = world[0]
    reads = [n_dense_reads(genome, np.random.default_rng(s))[kind]
             for s in (1, 2, 3)]
    L = len(reads[0]) + tail
    seqs, _ = SD.pad_reads(reads, L)
    kmat = torch.arange(21, L)[None, :].expand(len(reads), -1)
    got = SD._scan_states_closed(torch.from_numpy(seqs), kmat)
    want = JSD._hash_scan_batch(jnp.asarray(seqs.astype(np.int32)), 21)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


# ------------------------------------------- K3's chunked decomposition

from test_torch_kernel_edges import compact_rows  # noqa: E402

CHUNK = 16


@pytest.mark.parametrize("n,m_out", [(CHUNK - 1, 5), (CHUNK, 5),
                                     (CHUNK + 1, 5), (3 * CHUNK + 5, 5),
                                     (3 * CHUNK + 5, 16), (3 * CHUNK + 5, 1),
                                     (CHUNK + 1, 40)])
def test_compact_chunked_matches_jax(n, m_out):
    """compact_anchors_chunked (the kernel's chunks, look-back and zero
    stripes, at a chunk of 16 flags) against JAX's _compact_anchors: rows of
    a chunk less one flag, one chunk, one more and a ragged 53 (no multiple
    of 16); nothing kept, every slot kept, each chunk's first and last
    flag, counts m_out - 1, m_out, m_out + 1 with the m_out-th kept slot on
    the first chunk edge, and m_out past n. JAX's rows are min(m_out, n)
    wide; the port's are m_out wide, zero past the kept anchors."""
    rng = np.random.default_rng(n * 100 + m_out)
    anc, keep = compact_rows(rng, n, m_out, CHUNK)
    wc, wn = (np.asarray(t) for t in JSD._compact_anchors(
        jnp.asarray(anc), jnp.asarray(keep), m_out))
    gc, gn = SD.compact_anchors_chunked(torch.from_numpy(anc),
                                        torch.from_numpy(keep), m_out, CHUNK)
    gc, gn = gc.numpy(), gn.numpy()
    assert gn.dtype == np.int32 and np.array_equal(gn, wn)
    assert gn[0] == 0 and gn[1] == n
    width = min(m_out, n)
    for b in range(len(gn)):
        c = min(int(gn[b]), width)
        assert np.array_equal(gc[b, :c], wc[b, :c])
        assert not gc[b, c:].any()
    want = SD.compact_anchors_reference(torch.from_numpy(anc),
                                        torch.from_numpy(keep), m_out)
    assert np.array_equal(gc, want[0].numpy())
    if m_out <= CHUNK - 1 and n > CHUNK:
        # the rows around m_out sit on the chunk edge as planned
        assert set(gn[4:].tolist()) == {m_out - 1, m_out, m_out + 1}
