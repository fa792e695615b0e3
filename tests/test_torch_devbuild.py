"""linear_tpu_torch.ops.devbuild against linear_tpu: the port's plain device
build of the DIndex (what CPU tensors run) against JAX's
`build_dindex_device_host` on JAX-CPU and against the port's host build
(the native builder), at the sizes and -t values of tests/test_devbuild.py.
The sample positions depend on -t. Every comparison is exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from linear_tpu.ops import devbuild as JDB
from linear_tpu_torch.index import dindex as DI
from linear_tpu_torch.ops import devbuild as DB
from linear_tpu_torch.ops import seeding as SD


def _seqs(glen):
    rng = np.random.default_rng(glen)
    return [rng.integers(0, 4, glen).astype(np.uint8),
            rng.integers(0, 4, glen // 2).astype(np.uint8)]


@pytest.mark.parametrize("glen,threads", [(20000, 4), (150011, 16), (60000, 1)])
def test_plain_build_matches_jax_and_host(glen, threads):
    seqs = _seqs(glen)
    port = DB.build_dindex_device_host(seqs, "cpu", threads)
    jax_dev = JDB.build_dindex_device_host(seqs, threads_emul=threads)
    host = DI.build_dindex(seqs, threads)
    assert port.dir.dtype == np.int32 and port.hs.dtype == np.uint64
    for ref in (jax_dev, host):
        assert np.array_equal(port.dir, ref.dir)
        assert np.array_equal(port.hs, ref.hs)


def test_block_starts_restart_runs():
    """Poly-A stretches across the -t 4 block boundaries (5000, 10000,
    15000 of 20000), each starting at another phase of the 9-base sample
    stride: the samples on both sides share one xval (the all-T minimizer
    of the reverse strand), so only the block start restarts the run and
    sets the emission phase."""
    g = _seqs(20000)[0]
    for k, b in enumerate((5000, 10000, 15000)):
        g[b - 107 - 7 * k: b + 120] = 0
    port = DB.build_dindex_device_host([g], "cpu", 4)
    host = DI.build_dindex([g], 4)
    jax_dev = JDB.build_dindex_device_host([g], threads_emul=4)
    assert np.diff(host.dir)[-1] > 0  # the poly-A windows (all-T minimizer)
    for ref in (host, jax_dev):
        assert np.array_equal(port.dir, ref.dir)
        assert np.array_equal(port.hs, ref.hs)


def test_omitted_buckets_drop_out():
    """A repeat makes buckets of more than omit_block (400) emitted
    samples: they leave dir and hs, as in the host build."""
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 45).astype(np.uint8)
    g = np.concatenate([rng.integers(0, 4, 20000).astype(np.uint8),
                        np.tile(unit, 1200),
                        rng.integers(0, 4, 20000).astype(np.uint8)])
    host = DI.build_dindex([g], 4)
    dirp, hs, largest = DB.build_dindex_device([g], "cpu", 4)
    assert np.array_equal(dirp.numpy(), host.dir)
    assert np.array_equal(hs.numpy().view(np.uint64), host.hs)
    assert largest == int(np.diff(host.dir).max()) <= 400
    # the same samples without the omit cut: the repeat's buckets exceed it
    j, bs = DB._samples(len(g), 4)
    jt = torch.from_numpy(j)
    xv, yv, st = DB.sample_states(torch.from_numpy(g), jt)
    _, hs_all, largest_all = DB.emit_count_sort(
        xv, yv, st, jt, torch.zeros_like(jt), torch.from_numpy(bs),
        omit_block=1 << 30)
    assert largest_all > 400 and len(hs_all) > len(hs)
    idx = DB.device_build_to_index(dirp, hs, largest)
    up = SD.upload_index(host.dir, host.hs, "cpu")
    assert idx.cap == up.cap
    assert torch.equal(idx.dir_start, up.dir_start)
    assert torch.equal(idx.hs, up.hs)


def test_sample_states_match_jax():
    g = _seqs(30000)[0]
    j = np.arange(29, 29000, 9, dtype=np.int64)
    got = DB.sample_states(torch.from_numpy(g), torch.from_numpy(j))
    want = JDB._sample_states(jnp.asarray(g, dtype=jnp.int32),
                              jnp.asarray(j), 21, 13)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_genome_with_n_raises_before_device_work():
    seq = np.zeros(1000, dtype=np.uint8)
    seq[500] = 4
    with pytest.raises(ValueError):
        DB.build_dindex_device([_seqs(2000)[0], seq], "meta", 4)


@pytest.mark.cuda
@pytest.mark.parametrize("glen,threads", [(20000, 4), (150011, 16)])
def test_cuda_build_matches_plain(glen, threads):
    """The hand-written kernels against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py runs this check on the 4.6 Mb genome)")
    seqs = _seqs(glen)
    want = DB.build_dindex_device_host(seqs, "cpu", threads)
    got = DB.build_dindex_device_host(seqs, "cuda", threads)
    assert np.array_equal(got.dir, want.dir)
    assert np.array_equal(got.hs, want.hs)


def _repeat_genome(seed, glen, copies):
    """Random bases around a tandem repeat of a 45-base unit: its five
    sample phases put `copies` emitted samples in each of five buckets."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, 45).astype(np.uint8)
    half = rng.integers(0, 4, glen).astype(np.uint8)
    return np.concatenate([half[: glen // 2], np.tile(unit, copies),
                           half[glen // 2:]])


_ORDER_SETS = {
    "one_over": lambda: [_repeat_genome(11, 20000, 1200)],
    "one_under": lambda: [_repeat_genome(12, 20000, 300)],
    "three_over": lambda: [_repeat_genome(13, 16000, 1200),
                           np.random.default_rng(14).integers(
                               0, 4, 9000).astype(np.uint8),
                           np.random.default_rng(15).integers(
                               0, 4, 3001).astype(np.uint8)],
    "two_under": lambda: [np.random.default_rng(16).integers(
                              0, 4, 12000).astype(np.uint8),
                          _repeat_genome(17, 8000, 300)],
}


@pytest.mark.parametrize("threads", [1, 4, 8])
@pytest.mark.parametrize("kind", sorted(_ORDER_SETS))
def test_hs_is_a_stable_sort_by_xval_and_strand(kind, threads):
    """The order the CUDA build rests on: a stable sort of the kept samples,
    in sample order, by 2 * xval + strand gives the hs of JAX's device build
    and of the port's plain version (yval never decides the order: samples
    come in (gid, j) order and j is unique within a genome)."""
    seqs = _ORDER_SETS[kind]()
    parts = []
    for gid, g in enumerate(seqs):
        j, bs = DB._samples(len(g), threads)
        jt = torch.from_numpy(j)
        xv, yv, st = DB.sample_states(torch.from_numpy(g), jt)
        parts.append((xv, yv, st, jt, torch.full_like(jt, gid),
                      torch.from_numpy(bs)))
    xv, yv, st, jj, gid, bs = (torch.cat(c) for c in zip(*parts))
    idx = torch.arange(len(xv))
    prev = torch.nn.functional.pad(xv[:-1], (1, 0), value=-1)
    start = torch.cummax(torch.where((xv != prev) | bs.bool(), idx, 0),
                         dim=0).values
    emit = (idx - start) % DB.Q == 0
    counts = torch.bincount(xv[emit], minlength=DB.N_BUCKETS)
    over = counts > 400
    kept = emit & ~over[xv]
    assert bool(over.any()) == kind.endswith("over")
    order = torch.sort(2 * xv[kept] + st[kept], stable=True).indices
    cord = (((gid << 30) + (jj + DB.CONST_ANCHOR_ZERO)) << 20) + yv + (st << 61)
    got = cord[kept][order].numpy().view(np.uint64)
    jax_dev = JDB.build_dindex_device_host(seqs, threads_emul=threads)
    _, hs, _ = DB.emit_count_sort_reference(xv, yv, st, jj, gid, bs)
    assert np.array_equal(got, jax_dev.hs)
    assert np.array_equal(got, hs.numpy().view(np.uint64))
