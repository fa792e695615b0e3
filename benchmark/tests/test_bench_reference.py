"""The plain reference against the port on tiny inputs (the tests may
import the port; the reference imports nothing of it)."""
import ast
import os

import numpy as np
import pytest

import bench_tiny
from gen import donor as DN
from gen import genome as GG
from gen import reads as GR
from reference import dindex as RD
from reference import placement as RP
from reference import seeds as RS


def _genome(seed, n_mode):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 400_000).astype(np.uint8)
    if n_mode:
        # N runs at a block start, inside blocks, short runs, a run at the end
        g[0:30000] = 4
        g[150000:150500] = 4
        g[200017:200030] = 4
        g[300000:300003] = 4
        g[399000:] = 4
        if n_mode == 2:
            g[rng.random(len(g)) < 0.001] = 4
    rep = rng.integers(0, 4, 300).astype(np.uint8)
    for s in rng.integers(30000, 390000, 600).tolist():
        g[s: s + 300] = rep
    return g


@pytest.mark.parametrize("n_mode", [0, 1, 2])
@pytest.mark.parametrize("threads", [3, 8])
def test_dindex_equals_the_port_build(n_mode, threads):
    from linear_tpu_torch.index import dindex as PD

    gs = [_genome(11 + n_mode, n_mode),
          np.random.default_rng(2).integers(0, 4, 50000).astype(np.uint8)]
    d, h = RD.build(gs, threads)
    idx = PD.build_dindex(gs, threads)
    assert np.array_equal(d, idx.dir)
    assert np.array_equal(h, idx.hs)


def test_dindex_of_the_chr21_like_genome():
    from linear_tpu_torch.index import dindex as PD

    c = bench_tiny.cell("human_chr21.clr")
    g, _ = GG.make(np.random.default_rng(8), c["config"]["genome"])
    d, h = RD.build([g], 8)
    idx = PD.build_dindex([g], 8)
    assert np.array_equal(d, idx.dir) and np.array_equal(h, idx.hs)


@pytest.fixture(scope="module")
def bacterial():
    rng = np.random.default_rng(7)
    g, _ = GG.make(rng, {"model": "bacterial", "length": 400_000})
    d, h = RD.build([g], 4)
    t = {"length": {"dist": "lognormal", "median": 3000, "sigma": 0.8,
                    "min": 100, "max": 30000},
         "errors": {"sub": 0.01, "ins": 0.01, "del": 0.01},
         "reverse_share": 1 / 3}
    reads, _ = GR.make_file(rng, DN.identity(g), t, 60)
    return g, d, h, reads


def test_seeds_equal_the_port_query(bacterial):
    from linear_tpu_torch.index import dindex as PD

    _, d, h, reads = bacterial
    idx = PD.DIndex(span=21, weight=13, dir=d, hs=h)
    for r in reads:
        assert np.array_equal(RS.anchors(r, d, h)[0],
                              PD.query_anchors(idx, r, 0, len(r)))


def test_seeds_and_probes_equal_the_device_path(bacterial):
    """The device path's plain version (the CUDA kernel's contract): the
    anchors of every read that does not overflow, and every probe count."""
    from linear_tpu_torch.ops import seeding as SD

    _, d, h, reads = bacterial
    reads = [r for r in reads if len(r) > 56]
    dev = SD.upload_index(d, h, "cpu")
    pad = 1 << int(np.ceil(np.log2(max(map(len, reads)))))
    w, nm = SD.pack_superchunk(reads, pad, len(reads))
    handle = SD.dispatch_wire(w, dev, 512)
    probed = handle.out.numpy()[:, -1] >> 32
    res, ov = SD.collect_wire(handle, len(reads), nm, 512)
    for r, a, o, p in zip(reads, res, ov, probed.tolist()):
        anc, pr = RS.anchors(r, d, h)
        assert pr == p
        assert o == (pr > 512)
        if not o:
            assert np.array_equal(a, anc)


def test_placement():
    sam = ("@SQ\tSN:g\tLN:100000\n"
           "a\t0\tg\t1001\t255\t10S90=5D\t*\t0\t0\t*\t*\n"
           "a\t2048\tg\t50001\t255\t100=\t*\t0\t0\t*\t*\n"
           "b\t16\tg\t5001\t255\t100M\t*\t0\t0\t*\t*\n"
           "c\t0\tg\t9001\t255\t100M\t*\t0\t0\t*\t*\n"
           "d\t4\t*\t0\t255\t*\t*\t0\t0\t*\t*\n")
    pl = RP.sam_primaries(sam)
    n_prim = pl.pop(None)
    assert pl["a"] == (False, 1000, 1095) and n_prim["a"] == 1
    truth = np.array([[1050, 1200, 0, 1], [5000, 5100, 1, 1],
                      [100, 200, 0, 1], [0, 100, 0, 1]])
    assert RP.misplaced(pl, ["a", "b", "c", "d"], truth) == 2
    apf = ("@ a 100 0 95 + g 100000 1000 1095\n| 1 1000 0 0 +\n"
           "@ a 100 0 95 - g 100000 50000 50100\n"
           "@ b 100 0 95 + g 100000 5000 5100\n")
    assert RP.misplaced(RP.apf_first_blocks(apf), ["a", "b"],
                        truth[:2]) == 1


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(bench_tiny.BENCH, "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and not node.level else [])
            for n in names:
                assert n.split(".")[0] in ("numpy", "re", "__future__"), (
                    f, n)
