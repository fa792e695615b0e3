"""The multi-process mesh path: linear_tpu_torch.parallel.mesh's steps run
by 2 and 4 spawned gloo ranks on the CPU (`python -m
linear_tpu_torch.parallel.e2e steps`, once per world size for the whole
module, every case in one launch) against linear_tpu.parallel.mesh's same
steps on the virtual CPU mesh with the same shard counts (under jax.jit:
the shard_map bodies run op by op otherwise, ~90 s a call), the cases of
tests/test_mesh_shard.py: index-sharded seeding at 2 shards, the grid
mapping step at (dp, ix) = (2, 1), (1, 2) and (2, 2), the dp-sharded
mapping step and extension at dp 2. Compared as test_mesh_shard.py
compares them, exactly: keep masks, counts and overflow whole; anchors
where kept; sorted anchors, p2, score and length below n_anchors; cords,
counts and overflow of the extension whole. Also: init_distributed is a
no-op without the environment, a mesh must match the world, and the
2-rank map->SAM run (`python -m linear_tpu_torch.parallel.e2e --device
cpu`, tools/e2e_multiproc.py's 64-read world) writes the single-process
SAM byte for byte. And the anchor sort of the mapping steps alone
(ops.chain_dp.sort_anchors, what CPU tensors run: its plain version)
against the sort lines of linear_tpu's mapping_step under jax.jit, every
column and count exactly equal: fewer kept than n_max, more, ties in
anchor-x, nothing kept, n_max past the row, and a grid from JAX's seeder."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import equal as torch_equal

import jax
import jax.numpy as jnp

import test_torch_native_ready  # noqa: F401  (the JAX package's libraries)
from linear_tpu.index import dindex as JDI
from linear_tpu.ops import chain_dp as JCD
from linear_tpu.ops import extend_dev as JED
from linear_tpu.ops import features as JFE
from linear_tpu.ops import seeding as JSD
from linear_tpu.parallel import mesh as JMS
from linear_tpu.utils.cordscalar import FLAG_END, make_cord, set_end

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("anc", "n", "p2", "score", "length", "overflow")
N_MAX = 32
# the extension batch of test_mesh_shard.py:77
EB, EPAD, EH = 8, 1024, 32
EC = EH + EPAD // 32
ER = ((EPAD - 48) >> 4) + 1


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """test_mesh_shard.py's world: a 20 kb genome (seed 11), 4 reads of
    450 bases at pad 512, and its 8-read extension batch at pad 1024."""
    from linear_tpu_torch.ops import extend_dev as ED

    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    idx = JDI.build_dindex([g], threads_emul=4)
    B, L = 4, 512
    seqs = np.zeros((B, L), np.uint8)
    lens = np.zeros((B,), np.int64)
    for i in range(B):
        r = g[i * 500: i * 500 + 450]
        seqs[i, : len(r)] = r
        lens[i] = len(r)
    seqs2 = np.zeros((EB, EPAD), dtype=np.uint8)
    lens2 = np.zeros((EB,), dtype=np.int64)
    hitm = np.zeros((EB, EH), dtype=np.uint64)
    hitn = np.zeros((EB,), dtype=np.int32)
    for i in range(EB):
        pos = int(rng.integers(0, len(g) - 900))
        r = g[pos: pos + 800]
        seqs2[i, : len(r)] = r
        lens2[i] = len(r)
        hs = [FLAG_END]
        for k in range(0, 600, 192):
            hs.append(make_cord(0, pos + k, k, 0))
        hs[-1] = set_end(hs[-1])
        hitm[i, : len(hs)] = np.array(hs, dtype=np.uint64)
        hitn[i] = len(hs)
    s4 = seqs2.reshape(EB, -1, 4).astype(np.uint16)
    packed = (s4[:, :, 0] | (s4[:, :, 1] << 2) | (s4[:, :, 2] << 4)
              | (s4[:, :, 3] << 6)).astype(np.uint8)
    f2 = [JFE.create_features_genome(g, 4)]
    gf = ED.upload_genome_feats(f2, "cpu")
    path = str(d / "world.npz")
    np.savez(path, seqs=seqs, lens=lens, dir=idx.dir, hs=idx.hs, n_max=N_MAX,
             ext_packed=packed, ext_lens=lens2, ext_hits=hitm.view(np.int64),
             ext_n_hits=hitn, gf_cat=gf.cat.numpy(), gf_off=gf.off.numpy(),
             gf_rows=gf.rows.numpy(), ext_C=EC)
    return dict(dir=d, path=path, idx=idx, seqs=seqs, lens=lens, f2=f2,
                ext=(packed, lens2, hitm.view(np.int64), hitn))


def _run_steps(world, ranks, layouts):
    out = str(world["dir"] / f"steps{ranks}.npz")
    p = subprocess.run(
        [sys.executable, "-m", "linear_tpu_torch.parallel.e2e", "steps",
         "--inputs", world["path"], "--ranks", str(ranks), "--layouts",
         layouts, "--device", "cpu", "--out", out, "--timeout", "400"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=500)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "STEPS OK" in p.stdout
    return dict(np.load(out))


@pytest.fixture(scope="module")
def ranks2(world):
    return _run_steps(world, 2, "2x1,1x2")


@pytest.fixture(scope="module")
def ranks4(world):
    return _run_steps(world, 4, "2x2,4x1,1x4")


def _jax_index(world):
    return JSD.upload_index(world["idx"])


def _masked_equal(got, want):
    n = np.asarray(want[1])
    assert np.array_equal(got["n"], n)
    assert np.array_equal(got["overflow"], np.asarray(want[5]))
    msk = np.arange(N_MAX)[None, :] < n[:, None]
    for name, w in zip(("anc", "p2", "score", "length"),
                       (want[0], want[2], want[3], want[4])):
        g, w = got[name], np.asarray(w)
        assert g.shape == w.shape, name
        assert np.array_equal(np.where(msk, g, 0), np.where(msk, w, 0)), name


def _step(res, prefix):
    return {k: res[f"{prefix}_{k}"] for k in NAMES}


@pytest.mark.parametrize("n_ix", [2, 4])
def test_index_sharded_seed_matches_jax(world, ranks2, ranks4, n_ix):
    res = ranks2 if n_ix == 2 else ranks4
    dev = _jax_index(world)
    m = JMS.Mesh(np.array(jax.devices()[:n_ix]), ("ix",))
    dir_sh, lo_sh, hi_sh, xb, cap = JMS.shard_index_by_xval(world["idx"], n_ix)
    anc, keep = jax.jit(lambda *a: JMS.index_sharded_seed_step(m, *a, cap))(
        jnp.asarray(world["seqs"].astype(np.int32)),
        jnp.asarray(world["lens"]), dir_sh, lo_sh, hi_sh, xb)
    keep = np.asarray(keep)
    assert np.array_equal(res[f"ix{n_ix}_keep"], keep) and keep.sum() > 20
    assert np.array_equal(res[f"ix{n_ix}_anc"],
                          np.where(keep, np.asarray(anc), 0))
    # and the unsharded closed form, as the ranks' parent checked it
    ref_a, ref_k = JSD.batch_seed_anchors_fast(
        jnp.asarray(world["seqs"]), jnp.asarray(world["lens"]),
        dev.dir_start, dev.hs_lo, dev.hs_hi, cap=dev.cap)
    assert np.array_equal(res["ref_seed_keep"], np.asarray(ref_k))


@pytest.mark.parametrize("layout", [(2, 1), (1, 2), (2, 2), (4, 1), (1, 4)],
                         ids=["2x1", "1x2", "2x2", "4x1", "1x4"])
def test_grid_mapping_step_matches_jax(world, ranks2, ranks4, layout):
    n_dp, n_ix = layout
    res = ranks4 if n_dp * n_ix == 4 else ranks2
    gmesh = JMS.make_grid_mesh(n_dp, n_ix, jax.devices()[: n_dp * n_ix])
    dir_sh, lo_sh, hi_sh, xb, cap = JMS.shard_index_by_xval(world["idx"], n_ix)
    want = jax.jit(lambda *a: JMS.grid_mapping_step(gmesh, *a, cap,
                                                    n_max=N_MAX))(
        jnp.asarray(world["seqs"].astype(np.int32)),
        jnp.asarray(world["lens"]), dir_sh, lo_sh, hi_sh, xb)
    got = _step(res, f"grid_{n_dp}x{n_ix}")
    _masked_equal(got, want)
    assert got["n"].min() > 0


def test_mapping_step_matches_jax(world, ranks2):
    """The parent's single-device mapping_step, closed form and scan."""
    dev = _jax_index(world)
    for fast in (True, False):
        want = JMS.mapping_step(
            jnp.asarray(world["seqs"].astype(np.int32)),
            jnp.asarray(world["lens"]), dev.dir_start, dev.hs_lo, dev.hs_hi,
            cap=dev.cap, n_max=N_MAX, fast=fast)
        _masked_equal(_step(ranks2, f"ref_{'fast' if fast else 'scan'}"),
                      want)


@pytest.mark.parametrize("n_dp", [2, 4])
def test_sharded_mapping_step_matches_jax(world, ranks2, ranks4, n_dp):
    dev = _jax_index(world)
    mesh = JMS.make_dp_mesh(jax.devices()[:n_dp])
    want = JMS.sharded_mapping_step(
        mesh, world["seqs"].astype(np.int32), world["lens"], dev.dir_start,
        dev.hs_lo, dev.hs_hi, cap=dev.cap, n_max=N_MAX)
    _masked_equal(_step(ranks2 if n_dp == 2 else ranks4, f"dp{n_dp}_map"),
                  want)


@pytest.mark.parametrize("n_dp", [2, 4])
def test_sharded_extend_matches_jax(world, ranks2, ranks4, n_dp):
    res = ranks2 if n_dp == 2 else ranks4
    packed, lens2, hits, hitn = world["ext"]
    gf = JED.upload_genome_feats(world["f2"])
    mesh = JMS.make_dp_mesh(jax.devices()[:n_dp])
    want = JMS.sharded_extend_step(
        mesh, jnp.asarray(packed), jnp.asarray(lens2), jnp.asarray(hits),
        jnp.asarray(hitn), gf, H=EH, C=EC, R=ER, max_iter=4 * EH + 2 * EC + 16)
    for name, w in zip(("cords", "ncords", "ovf"), want):
        assert np.array_equal(res[f"dp{n_dp}_ext_{name}"], np.asarray(w)), name
    assert (res[f"dp{n_dp}_ext_ncords"] > 1).sum() >= 4


def test_init_distributed_is_a_noop_without_the_environment(monkeypatch):
    import torch.distributed as dist

    from linear_tpu_torch.parallel.dist import init_distributed

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed("gloo") == 0
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed("nccl") == 0
    assert not dist.is_initialized()


def test_init_distributed_takes_no_other_backend(monkeypatch):
    from linear_tpu_torch.parallel.dist import init_distributed

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="backend"):
        init_distributed("mpi")


@pytest.mark.parametrize("n,n_dp,n_ix", [(64, 2, 1), (64, 1, 2), (61, 2, 2),
                                         (10240, 2, 1), (7, 4, 1)])
def test_task_owners_partition_the_tasks(n, n_dp, n_ix):
    """Every task has one owner: a rank of the dp block its reads lie in,
    the ix ranks of a block taking its tasks in turn."""
    from linear_tpu_torch.parallel import e2e

    rows, owner = e2e._layout(n, n_dp, n_ix)
    assert rows % e2e.TASK == 0 and len(owner) == -(-n // e2e.TASK)
    for ti, r in enumerate(owner):
        d, i = divmod(r, n_ix)
        assert d * rows <= ti * e2e.TASK < (d + 1) * rows
        assert i == (ti - d * rows // e2e.TASK) % n_ix
    assert set(owner) <= set(range(n_dp * n_ix))


def test_layouts_must_fill_the_world():
    from linear_tpu_torch.parallel import e2e

    assert e2e._parse_layouts("", 4) == [(4, 1), (2, 2), (1, 4)]
    assert e2e._parse_layouts("2x2,1x4", 4) == [(2, 2), (1, 4)]
    with pytest.raises(ValueError):
        e2e._parse_layouts("2x1", 4)


def test_local_index_shard_of_one_rank(world):
    """A 1-rank mesh holds the whole index as its one shard."""
    from linear_tpu_torch.ops import seeding as SD
    from linear_tpu_torch.parallel import mesh as MS

    mesh = MS.make_grid_mesh(1, 1, "cpu")
    shard = MS.local_index_shard(mesh, MS.shard_index_by_xval(world["idx"], 1))
    dev = SD.upload_index(world["idx"].dir, world["idx"].hs, "cpu")
    assert shard.dir_start.dtype == dev.dir_start.dtype
    assert torch_equal(shard.dir_start, dev.dir_start)
    assert torch_equal(shard.hs, dev.hs) and shard.cap == dev.cap
    assert (shard.x_base, shard.x_hi) == (0, len(world["idx"].dir) - 1)


def test_mesh_must_match_the_world():
    from linear_tpu_torch.parallel import mesh as MS

    m = MS.make_grid_mesh(1, 1, "cpu")
    assert m.coord("dp") == 0 and m.size("ix") == 1 and not m.groups
    with pytest.raises(ValueError):
        MS.make_grid_mesh(2, 1, "cpu")


@pytest.mark.parametrize("ranks,ix", [(2, 1), (2, 2), (4, 2)])
def test_e2e_map_is_byte_identical(tmp_path, ranks, ix):
    """Gloo ranks as a (ranks / ix, ix) grid: the merged SAM equals the
    single-process host-seeded SAM of the same task schedule (the tool
    checks it and exits non-zero otherwise)."""
    out = tmp_path / "merged.sam"
    p = subprocess.run(
        [sys.executable, "-m", "linear_tpu_torch.parallel.e2e", "--device",
         "cpu", "--ranks", str(ranks), "--ix", str(ix), "--out", str(out),
         "--timeout", "400"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=500)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert f"E2E OK: 64 reads, 8 tasks over {ranks} ranks" in p.stdout
    block = 64 // (ranks // ix)
    assert p.stdout.count(f"seeded on the device {block},") == ranks
    assert out.read_bytes().startswith(b"@")


# ------------------------------------------------------------- anchor sort


def _jax_sort(anc, keep, n_max):
    """The sort lines of linear_tpu.parallel.mesh.mapping_step (:44-52),
    jitted as there."""
    @jax.jit
    def run(anc, keep):
        B = anc.shape[0]
        flat = anc.reshape(B, -1)
        kflat = keep.reshape(B, -1)
        n_anchors = jnp.minimum(jnp.sum(kflat, axis=1), n_max).astype(jnp.int32)
        key = jnp.where(kflat, -JCD._anchor_x(flat), jnp.int64(1) << 62)
        order = jnp.argsort(key, axis=1)[:, :n_max]
        return jnp.take_along_axis(flat, order, axis=1), n_anchors

    srt, n = run(jnp.asarray(anc), jnp.asarray(keep))
    return np.asarray(srt), np.asarray(n)


def _sort_grid(kind, seed=5, B=6, P=40, cap=8):
    """(anchors (B, P, cap) int64, keep) from a numpy seed: random strands,
    x and y fields; `kind` sets how many slots are kept and how many
    distinct anchor-x values there are."""
    rng = np.random.default_rng(seed)
    # anchor-x is the x field plus y: both narrow for ties
    x_lo, x_hi, y_hi = ((1 << 21, (1 << 21) + 16, 4) if kind == "ties"
                        else (0, 1 << 30, 1 << 20))
    anc = ((rng.integers(0, 2, (B, P, cap)) << 61)
           | (rng.integers(x_lo, x_hi, (B, P, cap)) << 20)
           | rng.integers(0, y_hi, (B, P, cap))).astype(np.int64)
    dens = {"few": 0.05, "many": 0.6, "ties": 0.5, "none": 0.0, "all": 1.0}
    keep = rng.random((B, P, cap)) < dens[kind]
    if kind == "few":
        keep[0] = False  # a row with nothing kept beside rows with some
    return anc, keep


@pytest.mark.parametrize("n_max", [32, 1000])
@pytest.mark.parametrize("kind", ["few", "many", "ties", "none", "all"])
def test_sort_anchors_matches_jax(kind, n_max):
    """n_max 32: rows of `few` keep fewer, of `many`, `ties` and `all`
    more; n_max 1000 is past the row's 320 slots, and every slot comes
    back."""
    from linear_tpu_torch.ops import chain_dp as CD

    anc, keep = _sort_grid(kind)
    want_a, want_n = _jax_sort(anc, keep, n_max)
    got_a, got_n = CD.sort_anchors(torch.from_numpy(anc),
                                   torch.from_numpy(keep), n_max)
    kept = keep.reshape(len(keep), -1).sum(1)
    assert got_n.dtype == torch.int32
    assert np.array_equal(got_n.numpy(), np.minimum(kept, n_max))
    assert np.array_equal(got_n.numpy(), want_n)
    assert got_a.shape == want_a.shape == (len(anc), min(n_max, 320))
    assert np.array_equal(got_a.numpy(), want_a)
    if kind == "ties":  # the stable order is decided by the flat index
        ax = JCD._anchor_x(jnp.asarray(want_a[:, :32]))
        assert (np.diff(np.asarray(ax), axis=1) == 0).sum() > 20


def test_sort_anchors_on_the_jax_seeders_grid(world):
    """A grid from linear_tpu's seeder (its unkept slots hold whatever the
    probe read): the same input through both sorts, all columns equal."""
    from linear_tpu_torch.ops import chain_dp as CD

    dev = _jax_index(world)
    anc, keep = JSD.batch_seed_anchors_fast(
        jnp.asarray(world["seqs"]), jnp.asarray(world["lens"]),
        dev.dir_start, dev.hs_lo, dev.hs_hi, cap=dev.cap)
    anc, keep = np.asarray(anc).astype(np.int64), np.asarray(keep)
    assert keep.sum() > 20 and (anc[~keep] != 0).any()
    for n_max in (8, N_MAX, 4096):
        want_a, want_n = _jax_sort(anc, keep, n_max)
        got_a, got_n = CD.sort_anchors(torch.from_numpy(anc),
                                       torch.from_numpy(keep), n_max)
        assert np.array_equal(got_n.numpy(), want_n)
        assert np.array_equal(got_a.numpy(), want_a)


def _chunk_rows(kind, n_max, seed=7):
    """One row a kept count of `kind` on rows of 3 chunks of the kernel and
    a ragged tail (B = 1): chunk edges (each chunk's first and last flag),
    none, n_max - 1, n_max, n_max + 1, all, and one under, at and one over
    the items a row sorts in registers and those of a shared-memory tile."""
    from linear_tpu_torch.ops import chain_dp as CD

    rng = np.random.default_rng(seed)
    n = 3 * CD.SORT_CHUNK + 77
    anc = ((rng.integers(0, 2, (1, n)) << 61)
           | (rng.integers(1 << 21, (1 << 21) + 2048, (1, n)) << 20)
           | rng.integers(0, 64, (1, n))).astype(np.int64)
    keep = np.zeros((1, n), dtype=bool)
    if kind == "edges":
        starts = np.arange(0, n, CD.SORT_CHUNK)
        keep[0, starts] = True
        keep[0, np.minimum(starts + CD.SORT_CHUNK, n) - 1] = True
    elif kind == "all":
        keep[:] = True
    elif kind != "none":
        k = {"n_max-1": n_max - 1, "n_max": n_max, "n_max+1": n_max + 1,
             "reg-1": CD.SORT_REG_ITEMS - 1, "reg": CD.SORT_REG_ITEMS,
             "reg+1": CD.SORT_REG_ITEMS + 1,
             "tile-1": CD.SORT_TILE - 1, "tile": CD.SORT_TILE,
             "tile+1": CD.SORT_TILE + 1}[kind]
        keep[0, rng.choice(n, k, replace=False)] = True
    return anc, keep


@pytest.mark.parametrize("n_max", [256, 8192])
@pytest.mark.parametrize("kind", ["edges", "none", "n_max-1", "n_max",
                                  "n_max+1", "all", "reg-1", "reg", "reg+1",
                                  "tile-1", "tile", "tile+1"])
def test_sort_anchors_chunked_matches_jax(kind, n_max):
    """The kernel's decomposition (sort_anchors_chunked: chunk counts and
    regions, the sorting network over the composite items, the unkept fill)
    equal to the plain version and to JAX's sort lines, every column and
    count; its chunk counts are the kept flags of each chunk, and the rows
    past the register capacity take the other branch."""
    from linear_tpu_torch.ops import chain_dp as CD

    anc, keep = _chunk_rows(kind, n_max)
    want_a, want_n = _jax_sort(anc, keep, n_max)
    a, k = torch.from_numpy(anc), torch.from_numpy(keep)
    got_a, got_n, chunk_kept, in_regs = CD.sort_anchors_chunked(a, k, n_max)
    ref_a, ref_n = CD.sort_anchors_reference(a, k, n_max)
    assert np.array_equal(got_a.numpy(), want_a)
    assert np.array_equal(got_n.numpy(), want_n)
    assert torch.equal(got_a, ref_a) and torch.equal(got_n, ref_n)
    pad = np.zeros(chunk_kept.shape[1] * CD.SORT_CHUNK, bool)
    pad[: keep.shape[1]] = keep[0]
    assert chunk_kept[0].tolist() == pad.reshape(-1, CD.SORT_CHUNK).sum(
        1).tolist()
    assert bool(in_regs[0]) == (keep.sum() <= CD.SORT_REG_ITEMS)


@pytest.mark.parametrize("chunk", [64, 16])
def test_sort_anchors_chunked_small_chunks(chunk):
    """Chunks of 64 and 16 flags (5 and 20 chunks a row of 320 slots):
    still equal to JAX's sort lines on every grid kind."""
    from linear_tpu_torch.ops import chain_dp as CD

    for kind in ("few", "many", "ties", "none", "all"):
        anc, keep = _sort_grid(kind)
        for n_max in (32, 1000):
            want_a, want_n = _jax_sort(anc, keep, n_max)
            got_a, got_n, _, _ = CD.sort_anchors_chunked(
                torch.from_numpy(anc), torch.from_numpy(keep), n_max,
                chunk=chunk)
            assert np.array_equal(got_a.numpy(), want_a)
            assert np.array_equal(got_n.numpy(), want_n)


def test_sorting_network_sorts():
    """The network against a sort: lengths around powers of two, the
    scan grid's 191,488 items, and repeated values."""
    from linear_tpu_torch.ops import chain_dp as CD

    rng = np.random.default_rng(8)
    for K in (0, 1, 2, 3, 255, 256, 257, 1000, 544 * 352):
        a = torch.from_numpy(rng.integers(0, 1 << 62, K))
        assert torch.equal(CD.sorting_network(a), torch.sort(a).values)
    a = torch.from_numpy(rng.integers(0, 5, 777))
    assert torch.equal(CD.sorting_network(a), torch.sort(a).values)


def test_sort_anchors_takes_one_device():
    from linear_tpu_torch.ops import chain_dp as CD

    anc, keep = _sort_grid("few")
    with pytest.raises(ValueError, match="no anchor sort kernel"):
        CD.sort_anchors(torch.from_numpy(anc).to("meta"),
                        torch.from_numpy(keep).to("meta"), 8)
    assert CD.sort_launches == 0  # CPU tensors launch nothing


@pytest.mark.cuda
def test_sort_anchors_cuda_kernel_matches_plain():
    """The hand-written kernel against the plain version on the card, all
    columns and counts, on every kind of grid and a row of 20,000 slots."""
    from linear_tpu_torch.ops import chain_dp as CD

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs this check at the mesh step's "
                    "shapes)")
    for kind in ("few", "many", "ties", "none", "all"):
        for shape in (dict(), dict(B=3, P=2500, cap=8)):
            anc, keep = (torch.from_numpy(a).cuda()
                         for a in _sort_grid(kind, **shape))
            for n_max in (32, 256, 8192):
                got = CD.sort_anchors(anc, keep, n_max)
                want = CD.sort_anchors_reference(anc, keep, n_max)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
    assert CD.sort_launches > 0
