"""linear_tpu_torch.ops.extend_dev against linear_tpu: the port's plain
_filterHits + path_dst_2 (what CPU tensors run) against JAX's
`batch_filter_extend_packed` on JAX-CPU, on the corpora of
tests/test_extend_dev.py (uniform seed 7, repeat seed 77) with the hits of
the native first pass, a batch with C cut so that rows overflow, and
hand-built hits (an end-flagged hit dropped right after the header, hit
counts 0..2). Also upload_genome_feats and NativeEngine.apx_hits against
JAX's. Every comparison is exact: cords, counts and overflow flags."""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

import difftest as DT  # noqa: E402
import test_torch_native_ready  # noqa: E402,F401  (the JAX package's libraries)
from linear_tpu.index import dindex as JDI  # noqa: E402
from linear_tpu.map import nengine as JNE  # noqa: E402
from linear_tpu.map import pmpfinder as PMP  # noqa: E402
from linear_tpu.ops import extend_dev as JED  # noqa: E402
from linear_tpu.ops import features as JF  # noqa: E402
from linear_tpu.utils import cordscalar as JCS  # noqa: E402
from linear_tpu_torch.index import dindex as DI  # noqa: E402
from linear_tpu_torch.map import nengine as NE  # noqa: E402
from linear_tpu_torch.ops import extend_dev as ED  # noqa: E402
from linear_tpu_torch.utils import seqio  # noqa: E402

# one JAX compile per C: every batch is padded to these shapes
B, PAD, H = 48, 16384, 256
C_FULL = H + PAD // 32
R = ED.feature_rows(PAD)


def _engine(mod, genomes, f2, index):
    return mod.NativeEngine(genomes, f2, index, [f"g{i}" for i in
                                                 range(len(genomes))],
                            thd_DI=80, thd_X=200, gap_len_min=50, f_dup=0,
                            f_chain=1, sequence_sam=0, reform_ccs=0)


@pytest.fixture(scope="module", params=[("uniform", 7), ("repeat", 77)],
                ids=["uniform", "repeat"])
def world(request):
    kind, seed = request.param
    rng = np.random.default_rng(seed)
    if kind == "repeat":
        genomes = [DT.make_repeat_genome(rng, 120000)]
    else:
        genomes = [rng.integers(0, 4, 100000).astype(np.uint8)
                   for _ in range(2)]
    f2 = [NE.build_features_native(g, 4) for g in genomes]
    index = DI.build_dindex(genomes, 4)
    reads = [r for r in DT.simulate(rng, genomes, 48)
             if len(r) > 200 and not (r == 4).any()]
    eng = _engine(NE, genomes, f2, index)
    hits = [eng.apx_hits(r) for r in reads]
    keep = [i for i, h in enumerate(hits) if len(h) <= H]
    assert len(keep) >= 30
    return dict(genomes=genomes, f2=f2, index=index,
                reads=[reads[i] for i in keep], hits=[hits[i] for i in keep])


def _batch(reads, hits):
    packed, lens = ED.pack_rows(reads, PAD)
    pk = np.zeros((B, PAD // 4), np.uint8)
    ln = np.zeros(B, np.int64)
    hm = np.zeros((B, H), np.uint64)
    hn = np.zeros(B, np.int32)
    pk[: len(reads)], ln[: len(reads)] = packed, lens
    for i, h in enumerate(hits):
        hm[i, : len(h)] = h
        hn[i] = len(h)
    return pk, ln, hm.view(np.int64), hn


def _port(batch, f2, C):
    pk, ln, hm, hn = batch
    gf = ED.upload_genome_feats(f2, "cpu")
    cords, ncords, ovf = ED.filter_extend(
        torch.from_numpy(pk), torch.from_numpy(ln), torch.from_numpy(hm),
        torch.from_numpy(hn), gf, C)
    return cords.numpy(), ncords.numpy(), ovf.numpy()


def _jax(batch, f2, C):
    pk, ln, hm, hn = batch
    gf = JED.upload_genome_feats(f2)
    cords, ncords, ovf = JED.batch_filter_extend_packed(
        jnp.asarray(pk), jnp.asarray(ln), jnp.asarray(hm), jnp.asarray(hn),
        gf.cat, gf.off, gf.rows, H=H, C=C, R=R, max_iter=4 * H + 2 * C + 16)
    return np.asarray(cords), np.asarray(ncords), np.asarray(ovf)


def _assert_same(got, want):
    cords, ncords, ovf = got
    assert np.array_equal(ovf, want[2])
    assert np.array_equal(ncords, want[1])
    assert np.array_equal(cords, want[0])


@pytest.mark.parametrize("C", [C_FULL, 40], ids=["C_full", "C_cut"])
def test_plain_matches_jax(world, C):
    batch = _batch(world["reads"][:B], world["hits"][:B])
    got = _port(batch, world["f2"], C)
    _assert_same(got, _jax(batch, world["f2"], C))
    n = len(world["reads"][:B])
    if C == C_FULL:
        assert not got[2][:n].any() and (got[1][:n] > 1).sum() >= 20
    else:
        assert got[2][:n].sum() >= 5 and not got[2][:n].all()


def test_plain_matches_host_oracle(world):
    """The cords of the non-overflowing rows equal the Python oracle's
    filter_hits + path_dst_2 (linear_tpu.map.pmpfinder)."""
    reads, hits = world["reads"][:12], world["hits"][:12]
    cords, ncords, ovf = _port(_batch(reads, hits), world["f2"], C_FULL)
    f2 = [PMP.Feats(a) for a in world["f2"]]
    for i, (r, h) in enumerate(zip(reads, hits)):
        f1 = [PMP.Feats(JF.create_features_serial(r)),
              PMP.Feats(JF.create_features_serial(seqio.revcomp(r)))]
        hl, want = [int(v) for v in h], []
        if len(hl) >= 2:
            PMP.filter_hits(hl, f1, f2)
            PMP.run_serial(PMP.path_dst_2(hl, f1, f2, want, 0, len(r), len(r)))
        assert not ovf[i]
        assert cords[i, : ncords[i]].view(np.uint64).tolist() == want, i


def test_hand_built_hits_match_jax(world):
    """Exact-substring reads with hand-placed hits: an end-flagged hit that
    the filter drops right after the header (its flag lands on slot 0), a
    dropped end-flagged hit in mid-block (its flag lands on the kept hit
    before it), and reads with 0, 1 and 2 hits."""
    g = world["genomes"][0]
    rng = np.random.default_rng(3)
    reads, hits = [], []
    kinds = ["drop_first", "drop_mid", "none", "good", "drop_first",
             "drop_mid", "two", "header", "good"]
    for kind in kinds:
        ln = int(rng.integers(3000, 9000))
        p = int(rng.integers(0, len(g) - ln))
        reads.append(g[p: p + ln].copy())
        good = [JCS.make_cord(0, p + y, y, 0) for y in range(0, ln - 600, 480)]
        bad = JCS.set_end(JCS.make_cord(0, (p + 50000) % (len(g) - ln), 700, 0))
        h = {"drop_first": [JCS.FLAG_END, bad] + good,
             "drop_mid": [JCS.FLAG_END] + good[:3] + [bad] + good[3:],
             "none": [], "good": [JCS.FLAG_END] + good,
             "two": [JCS.FLAG_END, good[0]], "header": [JCS.FLAG_END]}[kind]
        if h:
            h[-1] = JCS.set_end(h[-1])
        hits.append(np.array(h, dtype=np.uint64))
    batch = _batch(reads, hits)
    got = _port(batch, world["f2"], C_FULL)
    _assert_same(got, _jax(batch, world["f2"], C_FULL))
    ncords = got[1][: len(kinds)]
    assert [int(n) > 1 for n in ncords] == [
        k not in ("none", "two", "header") for k in kinds]
    assert (ncords[[2, 6, 7]] == 0).all()


def test_upload_genome_feats_matches_jax(world):
    gf = ED.upload_genome_feats(world["f2"], "cpu")
    jgf = JED.upload_genome_feats(world["f2"])
    assert gf.cat.dtype == torch.int32
    assert np.array_equal(gf.cat.numpy().view(np.uint32), np.asarray(jgf.cat))
    assert np.array_equal(gf.off.numpy(), np.asarray(jgf.off))
    assert np.array_equal(gf.rows.numpy(), np.asarray(jgf.rows))


def test_apx_hits_match_jax(world):
    """NativeEngine.apx_hits of the port and of linear_tpu, host-seeded and
    fed the host oracle's anchors as device seeds."""
    jidx = JDI.build_dindex(world["genomes"], threads_emul=4)
    jeng = _engine(JNE, world["genomes"], world["f2"], jidx)
    eng = _engine(NE, world["genomes"], world["f2"], world["index"])
    for r in world["reads"][:16]:
        want = jeng.apx_hits(r)
        assert np.array_equal(eng.apx_hits(r), want)
        seeds = JDI.query_anchors(jidx, r, 0, len(r), thd_alpha=15)
        assert np.array_equal(eng.apx_hits(r, seeds=seeds), want)
    assert len(eng.apx_hits(world["reads"][0][:200])) == 0


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(world):
    """The hand-written kernel against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs this check at the main path's shapes)")
    for C in (C_FULL, 40):
        pk, ln, hm, hn = _batch(world["reads"][:B], world["hits"][:B])
        gf = ED.upload_genome_feats(world["f2"], "cuda")
        args = [torch.from_numpy(a).cuda() for a in (pk, ln, hm, hn)]
        got = [t.cpu().numpy() for t in ED.filter_extend(*args, gf, C)]
        want = [t.cpu().numpy() for t in ED.filter_extend_reference(
            *args, gf, C, R)]
        _assert_same(got, want)


def test_work_count_matches_host_oracle(world, monkeypatch):
    """The plain version's count of the work (count_work, which the smoke's
    bound of the kernel reads) against the Python oracle's calls: window
    steps (previous_window / next_window calls) in all and of the longest
    read, in-range window evaluations of the filter and the sweeps, and the
    distinct genome feature rows they read. The outputs do not change."""
    reads, hits = world["reads"][:12], world["hits"][:12]
    batch = _batch(reads, hits)
    pk, ln, hm, hn = (torch.from_numpy(a) for a in batch)
    gf = ED.upload_genome_feats(world["f2"], "cpu")
    want = ED.filter_extend(pk, ln, hm, hn, gf, C_FULL)
    *got, work = ED.filter_extend_reference(pk, ln, hm, hn, gf, C_FULL, R,
                                            count_work=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    calls, evals, rows = [0], [0], set()
    orig_u, orig_c = PMP.window_dist_u, PMP.window_dist_c

    def counted(fn, d):
        def wrap(f1, f2, a, b):
            if a >= 0 and b >= 0 and a + d < len(f1.rows) \
                    and b + d < len(f2.rows):
                evals[0] += 1
                rows.update({(id(f2), b), (id(f2), b + 3)})
            return fn(f1, f2, a, b)
        return wrap

    def stepped(gen_fn):
        def wrap(*args):
            calls[0] += 1
            return (yield from gen_fn(*args))
        return wrap

    monkeypatch.setattr(PMP, "window_dist_u", counted(orig_u, 3))
    monkeypatch.setattr(PMP, "window_dist_c", counted(orig_c, 4))
    monkeypatch.setattr(PMP, "previous_window", stepped(PMP.previous_window))
    monkeypatch.setattr(PMP, "next_window", stepped(PMP.next_window))
    f2 = [PMP.Feats(a) for a in world["f2"]]
    steps = []
    for r, h in zip(reads, hits):
        f1 = [PMP.Feats(JF.create_features_serial(r)),
              PMP.Feats(JF.create_features_serial(seqio.revcomp(r)))]
        hl, cords, before = [int(v) for v in h], [], calls[0]
        if len(hl) >= 2:
            PMP.filter_hits(hl, f1, f2)
            PMP.run_serial(PMP.path_dst_2(hl, f1, f2, cords, 0, len(r),
                                          len(r)))
        steps.append(calls[0] - before)
    assert work["steps"] == sum(steps) > 0
    assert work["max_steps"] == max(steps)
    assert work["window_evals"] == evals[0]
    assert work["lane_distances"] == 30 * evals[0]
    assert work["genome_rows"] == len(rows)
    n1 = [2 * (1 + max(0, (len(r) - 50) >> 4)) for r, h in zip(reads, hits)
          if len(h) >= 2]
    assert work["read_rows"] == sum(n1)
    assert work["read_chunks"] == sum(n1) + 4 * len(n1)
