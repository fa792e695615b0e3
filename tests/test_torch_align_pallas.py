"""linear_tpu_torch.ops.align_pallas against linear_tpu.ops.align_pallas:
the port's banded_align_scores on the CPU (the plain version of the
kernel) against JAX's Pallas kernel in interpret mode and its numpy oracle,
for several seeds and band half-widths W (64 and 128 of JAX's tests, 100 of
the -a path, and narrow bands), on mutated, unrelated and length-skewed
pairs, empty queries and references, and pairs with N on both sides; the
host traceback against JAX's; and the dispatch. Scores are integers: every
comparison is exact (tolerance 0)."""
import re

import numpy as np
import pytest
import torch

from linear_tpu.ops import align_pallas as JAP
from linear_tpu_torch.ops import align_pallas as AP


def _mutate(seq, rng, err=0.1):
    """tests/test_align_pallas.py's generator: substitutions, insertions,
    deletions."""
    out = []
    for c in seq:
        x = rng.random()
        if x < err * 0.4:
            out.append(int(rng.integers(0, 4)))
        elif x < err * 0.7:
            out.append(int(rng.integers(0, 4)))
            out.append(int(c))
        elif x < err:
            continue
        else:
            out.append(int(c))
    return np.array(out, dtype=np.uint8)


def _pairs(seed, W):
    """Mutated, unrelated and length-skewed (by more than W) pairs, pairs
    with N (4) on both sides, an empty query and an empty reference."""
    rng = np.random.default_rng(seed)
    qry, ref = [], []
    for i in range(8):
        base = rng.integers(0, 4, int(rng.integers(30, 160))).astype(np.uint8)
        q = _mutate(base, rng)
        r = base.copy()
        if i % 4 == 1:  # unrelated
            r = rng.integers(0, 4, len(base)).astype(np.uint8)
        if i % 4 == 2:  # skewed: the reference longer by more than W
            r = np.concatenate([rng.integers(0, 4, W + 9).astype(np.uint8), r])
        if i % 4 == 3:  # N on both sides, some at the same places
            q[::6] = 4
            r[::6] = 4
            r[1::9] = 4
        qry.append(q)
        ref.append(r)
    qry.append(rng.integers(0, 4, W + 20).astype(np.uint8))  # skewed query
    ref.append(rng.integers(0, 4, 12).astype(np.uint8))
    qry += [np.zeros(0, np.uint8), rng.integers(0, 4, 25).astype(np.uint8)]
    ref += [rng.integers(0, 4, 30).astype(np.uint8), np.zeros(0, np.uint8)]
    return qry, ref


@pytest.mark.parametrize("W", [64, 100, 128])
@pytest.mark.parametrize("seed", [17, 29, 41, 53])
def test_scores_match_jax_and_oracle(seed, W):
    qry, ref = _pairs(seed, W)
    got = AP.banded_align_scores(qry, ref, W=W, device="cpu")
    want = JAP.banded_align_scores(qry, ref, W=W)
    assert got.dtype == np.int32 and got.shape == (len(qry),)
    assert np.array_equal(got, want)
    oracle = [JAP.banded_align_oracle(q, r, W=W) for q, r in zip(qry, ref)]
    assert got.tolist() == oracle
    assert got.tolist() == [AP.banded_align_oracle(q, r, W=W)
                            for q, r in zip(qry, ref)]
    assert got[-2:].tolist() == [0, 0] and got.max() > 100


def _kind_pairs(kind, W, rng):
    """Batches of one kind of pair, each probing one edge of the kernel:
    identical pairs (the diagonal alone), drift (deletions push the best
    path toward the band's edge), query or reference longer by more than W,
    runs of N on both sides (N matches N), tiny pairs (1-10 bases), and
    lengths at the 128-base padding boundaries."""
    qry, ref = [], []
    for t in range(6):
        base = rng.integers(0, 4, int(rng.integers(60, 300))).astype(np.uint8)
        q, r = base.copy(), base.copy()
        if kind == "drift":
            keep = rng.random(len(base)) > 0.25
            q = base[keep]
        elif kind == "skew_query":
            q = np.concatenate([base, rng.integers(0, 4, W + 5 + 7 * t)
                                .astype(np.uint8)])
        elif kind == "skew_ref":
            r = np.concatenate([rng.integers(0, 4, W + 5 + 7 * t)
                                .astype(np.uint8), base])
        elif kind == "n_runs":
            q = _mutate(base, rng)
            q[5: 5 + 4 * t] = 4
            r[len(r) // 2: len(r) // 2 + 3 * t + 1] = 4
        elif kind == "tiny":
            q = rng.integers(0, 4, t + 1).astype(np.uint8)
            r = rng.integers(0, 4, 10 - t).astype(np.uint8)
        elif kind == "pad_edge":
            n = (128, 129, 127, 256, 255, 257)[t]
            q = rng.integers(0, 4, n).astype(np.uint8)
            r = _mutate(q, rng, err=0.05)[:n]
        qry.append(q)
        ref.append(r)
    return qry, ref


@pytest.mark.parametrize("W", [64, 100, 128])
@pytest.mark.parametrize("kind", ["identical", "drift", "skew_query",
                                  "skew_ref", "n_runs", "tiny", "pad_edge"])
def test_pair_kinds_match_jax(kind, W):
    """One kind of pair a batch, against JAX's kernel and the oracle."""
    rng = np.random.default_rng(sum(map(ord, kind)) + W)
    qry, ref = _kind_pairs(kind, W, rng)
    got = AP.banded_align_scores(qry, ref, W=W, device="cpu")
    assert np.array_equal(got, JAP.banded_align_scores(qry, ref, W=W))
    assert got.tolist() == [JAP.banded_align_oracle(q, r, W=W)
                            for q, r in zip(qry, ref)]
    if kind == "identical":
        assert got.tolist() == [3 * len(q) for q in qry]


@pytest.mark.parametrize("W", [1, 5])
def test_narrow_bands_and_fixed_L(W):
    """Bands narrower than the length skew, and an L wider than needed:
    equal to JAX's kernel. (JAX's oracle is not the yardstick here: it
    starts free begin gaps H[i][0] = 0 in every row, the kernel only in
    the band's rows i <= W, so the two differ at W = 1.)"""
    qry, ref = _pairs(3, W)
    got = AP.banded_align_scores(qry, ref, W=W, L=384, device="cpu")
    assert np.array_equal(got, JAP.banded_align_scores(qry, ref, W=W, L=384))
    assert got.max() > 0


@pytest.mark.parametrize("seed", [23, 41])
def test_cigar_matches_jax(seed):
    """The port's host traceback equals JAX's, and its CIGAR replays to its
    score."""
    rng = np.random.default_rng(seed)
    for trial in range(4):
        base = rng.integers(0, 4, int(rng.integers(40, 160))).astype(np.uint8)
        q = _mutate(base, rng)
        r = base if trial % 2 else np.concatenate(
            [rng.integers(0, 4, 30).astype(np.uint8), base])
        got = AP.banded_align_cigar(q, r, W=64)
        assert got == JAP.banded_align_cigar(q, r, W=64)
        score, cig, (q0, q1), (r0, r1) = got
        i, j, s = q0, r0, 0
        for cnt, op in re.findall(r"(\d+)([=XID])", cig):
            for _ in range(int(cnt)):
                if op in "=X":
                    s += AP.S_MATCH if q[i] == r[j] else AP.S_MISMATCH
                    i, j = i + 1, j + 1
                else:
                    s += AP.S_GAP
                    i, j = (i + 1, j) if op == "I" else (i, j + 1)
        assert (i, j, s) == (q1, r1, score)


def test_dispatch():
    """CPU tensors run the plain version and launch nothing; other devices,
    mixed devices and misshapen inputs raise."""
    qry, ref = _pairs(5, 64)
    a, bpad, nm = (torch.from_numpy(x) for x in AP.pack_pairs(qry, ref, 64))
    assert a.dtype == torch.uint8 and nm.shape == (len(qry), 2)
    assert bpad.shape == (len(qry), a.shape[1] + 128)
    before = AP.launches
    got = AP.banded_align(a, bpad, nm, 64)
    assert torch.equal(got, AP.banded_align_reference(a, bpad, nm, 64))
    assert AP.launches == before
    with pytest.raises(ValueError):
        AP.banded_align(a.to("meta"), bpad.to("meta"), nm.to("meta"), 64)
    with pytest.raises(ValueError):
        AP.banded_align(a, bpad.to("meta"), nm, 64)
    with pytest.raises(ValueError):
        AP.banded_align(a, bpad, nm, 32)
    with pytest.raises(ValueError):
        AP.pack_pairs(qry, ref, 64, L=16)
    assert AP.banded_align_scores([], [], device="cpu").shape == (0,)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The hand-written kernel against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs this check on the corpus' regions)")
    for W in (1, 64, 100, 128, 512):
        qry, ref = _pairs(7, W)
        args = [torch.from_numpy(x).cuda()
                for x in AP.pack_pairs(qry, ref, W)]
        assert torch.equal(AP.banded_align(*args, W),
                           AP.banded_align_reference(*args, W))


@pytest.mark.parametrize("W", [513])
def test_bands_past_1024_diagonals_match_jax(W):
    """KW = 2W past 1,024 (the kernel's block of 1,024 threads then gives
    each thread two diagonals): the plain version against JAX's Pallas
    kernel in interpret mode and the oracle."""
    qry, ref = _pairs(W, W)
    got = AP.banded_align_scores(qry, ref, W=W, device="cpu")
    assert np.array_equal(got, JAP.banded_align_scores(qry, ref, W=W))
    assert got.tolist() == [AP.banded_align_oracle(q, r, W=W)
                            for q, r in zip(qry, ref)]


from test_torch_kernel_edges import banded_edge_pairs  # noqa: E402


@pytest.mark.parametrize("W", [1, 15, 16, 17, 31, 32, 33, 100, 513])
def test_lane_decomposition_matches_jax(W):
    """banded_align_lanes (the kernel's c diagonals a lane, in-lane running
    max, scan across lanes and warps, second pass) against JAX's Pallas
    kernel in interpret mode and the plain version, at band widths around a
    lane's and a warp's diagonals, on the edge pairs: n = 0, m = 0, a query
    past m + W, m far past n, identical, all mismatches, N against N."""
    qry, ref = banded_edge_pairs(np.random.default_rng(W), W)
    a, bpad, nm = (torch.from_numpy(x) for x in AP.pack_pairs(qry, ref, W))
    got = AP.banded_align_lanes(a, bpad, nm, W).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, JAP.banded_align_scores(qry, ref, W=W))
    assert np.array_equal(got, AP.banded_align_reference(a, bpad, nm, W))
    assert got[0] == 0 and got[1] == 0 and got[4] == 3 * len(qry[4])
    assert got[5] == 0 and got[6] == 3 * 50


@pytest.mark.parametrize("W,shape", [(1, (1, 1)), (16, (1, 1)), (17, (1, 2)),
                                     (100, (1, 7)), (128, (1, 8)),
                                     (129, (2, 5)), (600, (5, 8)),
                                     (4096, (32, 8)), (4097, (17, 16)),
                                     (8192, (32, 16)), (8193, (32, 32)),
                                     (13000, (32, 32)), (16384, (32, 32))])
def test_banded_shape(W, shape):
    """The launch shape (warps a pair, diagonals a lane) and the lanes'
    diagonals: every diagonal of the band owned once, in order; in the
    exact layout each lane owns c or c - 1 (one pad slot at most), in the
    padded one (c 1 and 32) whole lanes past the band are pad."""
    KW = 2 * W
    nw, c = AP.banded_shape(W)
    assert (nw, c) == shape
    k0, vl = AP.banded_lanes(W)
    assert len(k0) == 32 * nw and int(vl.sum()) == KW
    owned = torch.cat([torch.arange(int(s), int(s + v))
                       for s, v in zip(k0, vl)])
    assert torch.equal(owned, torch.arange(KW))
    if 1 < c < 32:
        assert set(vl.tolist()) <= {c, c - 1} and int(vl[0]) == c
    with pytest.raises(ValueError):
        AP.banded_shape(AP.BANDED_MAX_W + 1)


# ------------------------------------------------ past the register design

def _pallas_interpret(qry, ref, W, L=128):
    """JAX's Pallas kernel (_ba_kernel, the repo's one pl.pallas_call) in
    interpret mode on a batch, as banded_align_scores calls it, with the
    substitution tensor sub[b, i, k] = (bpad[b, i + k] == a[b, i] ? +3 :
    -2) built in numpy: banded_align_scores stacks KW slices in XLA, whose
    trace at W 16,385 (32,770 slices) takes the CPU minutes."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    SB = JAP.SUBBATCH
    B0, KW = len(qry), 2 * W
    B = -(-B0 // SB) * SB
    a = np.full((B, L), 7, np.int32)
    bpad = np.full((B, L + KW), 9, np.int32)
    nm = np.zeros((B, 128), np.int32)
    for i, (q, r) in enumerate(zip(qry, ref)):
        a[i, : len(q)] = q
        bpad[i, W: W + len(r)] = r
        nm[i, :2] = len(q), len(r)
    win = bpad[:, np.arange(L)[:, None] + np.arange(KW)[None, :]]
    sub = np.where(win == a[:, :, None], JAP.S_MATCH,
                   JAP.S_MISMATCH).astype(np.int32)
    sub3 = (sub.reshape(B // SB, SB, L, KW).transpose(0, 2, 1, 3)
            .reshape((B // SB) * L, SB, KW))
    with jax.enable_x64(False):
        out = pl.pallas_call(
            partial(JAP._ba_kernel, L=L, W=W, KW=KW, SB=SB),
            grid=(B // SB, L),
            in_specs=[
                pl.BlockSpec((1, SB, KW), lambda p, i: (p * L + i, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, SB, 128), lambda p, i: (p, 0, 0),
                             memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((1, SB, 128), lambda p, i: (p, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((B // SB, SB, 128), jnp.int32),
            scratch_shapes=[pltpu.VMEM((SB, KW), jnp.int32),
                            pltpu.VMEM((SB, 128), jnp.int32)],
            interpret=True,
        )(jnp.asarray(sub3), jnp.asarray(nm.reshape(B // SB, SB, 128)))
    return np.asarray(out).reshape(B, 128)[:B0, 0]


def _short_pairs(rng, W):
    """Short pairs (up to 120 bases, rows of L 128): the edge pairs cut to
    fit, and mutated copies with a reference shifted by up to 60 bases."""
    qry, ref = banded_edge_pairs(rng, 7)
    for _ in range(5):
        r = rng.integers(0, 4, int(rng.integers(40, 120))).astype(np.uint8)
        q = r[int(rng.integers(0, 30)):].copy()
        q[rng.random(len(q)) < 0.1] = 3
        qry.append(q[:120])
        ref.append(r)
    return [q[:120] for q in qry], [r[:120] for r in ref]


@pytest.mark.parametrize("W", [100, 16385])
def test_wide_band_matches_jax_pallas(W):
    """W 16,385, the first band past the register design (the kernel's wide
    branch on the card): the plain version, which the CPU entry point runs
    and the kernel is held to, against JAX's Pallas kernel in interpret
    mode and the oracle, on short rows (at W 16,385 one Pallas sub-batch of
    eight of them, whose interpretation at 32,770 diagonals is the slow
    part), and the wide kernel's statement banded_align_ring. At W 100 the
    helper that feeds the Pallas kernel is itself held to JAX's
    banded_align_scores."""
    qry, ref = _short_pairs(np.random.default_rng(W), W)
    if W > AP.BANDED_MAX_W:  # one Pallas sub-batch: n = 0, m = 0, identical,
        keep = [0, 1, 4, 8, 9, 10, 11, 12]  # the five mutated pairs
        qry, ref = [qry[k] for k in keep], [ref[k] for k in keep]
    want = _pallas_interpret(qry, ref, W)
    if W == 100:
        assert np.array_equal(want, JAP.banded_align_scores(qry, ref, W=W))
    got = AP.banded_align_scores(qry, ref, W=W, L=128, device="cpu")
    assert np.array_equal(got, want)
    assert got.tolist() == [AP.banded_align_oracle(q, r, W=W)
                            for q, r in zip(qry, ref)]
    assert got.max() > 100
    packed = (torch.from_numpy(x) for x in AP.pack_pairs(qry, ref, W, 128))
    assert np.array_equal(AP.banded_align_ring(*packed, W).numpy(), got)


@pytest.mark.parametrize("W,L", [(1, None), (2, None), (16, None),
                                 (33, 384), (100, None), (513, None)])
def test_ring_decomposition_matches_jax(W, L):
    """banded_align_ring (the wide kernel's rows cut to their diagonals
    inside the matrix, the row before read from a ring of min(2W, m + 1) + 1
    cells) against JAX's banded_align_scores (its Pallas kernel in interpret
    mode) and the plain version, on the edge pairs: n = 0, m = 0, a query
    past m + W (the band leaves the matrix), m far past n (the ring as wide
    as the band), identical, all mismatches, N against N; W 33 also in rows
    padded past the longest sequence."""
    qry, ref = banded_edge_pairs(np.random.default_rng(W + 5), W)
    a, bpad, nm = (torch.from_numpy(x) for x in AP.pack_pairs(qry, ref, W, L))
    got = AP.banded_align_ring(a, bpad, nm, W).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, JAP.banded_align_scores(qry, ref, W=W, L=L))
    assert np.array_equal(got, AP.banded_align_reference(a, bpad, nm, W))
    assert got[0] == 0 and got[1] == 0 and got[4] == 3 * len(qry[4])
