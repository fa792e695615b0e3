"""The HIndex (-i 2) and SIndex (-i 3) of linear_tpu_torch against
linear_tpu's, exactly: the tables of the Python HIndex build, of the native
HIndex build (lt_engine's le_build_hindex) and of the SIndex build equal
linear_tpu's arrays; the queries on an index carried over from linear_tpu
(port_index) give linear_tpu's anchors; `filter -i 2` (native engine, and
the Python engine with LINEAR_TPU_ENGINE=py) and `filter -i 3` (Python
engine) write linear_tpu's SAM and APF byte for byte; a native HIndex's
arrays stay valid after the index object is gone. With --device cpu these
run no device work and say so."""
import gc
import os

import numpy as np
import pytest

import test_torch_native_ready as NR
from linear_tpu.index import dindex as JDI
from linear_tpu.index import hindex as JHI
from linear_tpu.index import sindex as JSI
from linear_tpu.map import nengine as JNE
from linear_tpu.map.mapper import Mapper as JMapper
from linear_tpu.map.mapper import MapperConfig as JConfig
from linear_tpu.utils.cordscalar import MAX_CORD_ID, MAX_CORD_X, make_cord
from linear_tpu_torch.index import dindex as DI
from linear_tpu_torch.index import hindex as HI
from linear_tpu_torch.index import sindex as SI
from linear_tpu_torch.map import nengine as NE
from linear_tpu_torch.map.mapper import Mapper, MapperConfig
from linear_tpu_torch.utils import seqio

OUT = ("out.sam", "out.apf")
H_FIELDS = ("ysa", "xs_val1", "xs_val2")


def port_index(jidx):
    """An index object built by linear_tpu (numpy arrays) as the port's
    class of the same kind, so that both packages compute on one table."""
    if isinstance(jidx, JHI.HIndex):
        return HI.HIndex(span=jidx.span, weight=jidx.weight, ysa=jidx.ysa,
                         xs_val1=jidx.xs_val1, xs_val2=jidx.xs_val2,
                         xs_mask=jidx.xs_mask, empty_dir=jidx.empty_dir)
    if isinstance(jidx, JSI.SIndex):
        return SI.SIndex(span=jidx.span, weight=jidx.weight, dir=jidx.dir,
                         hs=jidx.hs)
    if isinstance(jidx, JDI.DIndex):
        return DI.DIndex(span=jidx.span, weight=jidx.weight,
                         dir=np.ascontiguousarray(jidx.dir, dtype=np.int32),
                         hs=jidx.hs, nz=jidx.nz)
    raise TypeError(f"not an index of linear_tpu: {type(jidx)!r}")


def same_hindex(a, b) -> None:
    assert (a.span, a.weight, a.xs_mask, a.empty_dir) == \
        (b.span, b.weight, b.xs_mask, b.empty_dir)
    for f in H_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _genomes(seed, with_n):
    rng = np.random.default_rng(seed)
    gs = [rng.integers(0, 4, n).astype(np.uint8) for n in (40000, 9000)]
    gs[0][3000:3800] = gs[0][20000:20800]  # a repeat: a bucket of two
    if with_n:
        gs[0][5000:5007] = 4
    return gs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hindex"))
    genome, reads, ids = NR.small_corpus(d, seed=27, n_reads=14)
    return {"dir": d, "genome": genome, "reads": reads, "ids": ids}


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("with_n", [False, True])
def test_python_hindex_build_matches_jax(with_n, threads):
    gs = _genomes(31, with_n)
    got = HI.build_hindex(gs, threads_emul=threads)
    same_hindex(got, JHI.build_hindex(gs, threads_emul=threads))
    assert len(got.ysa) > 5000 and got.empty_dir > 0


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("with_n", [False, True])
def test_native_hindex_build_matches_jax(with_n, threads):
    """le_build_hindex through the port's binding: equal to linear_tpu's
    binding of it and to the Python build."""
    gs = _genomes(32, with_n)
    args = (HI.DEFAULT_SPAN, HI.DEFAULT_STEP, HI.DEFAULT_BLOCKLIMIT,
            HI.DEFAULT_ALPHA, threads)
    got = NE.build_hindex_native(gs, *args)
    assert isinstance(got, HI.HIndex)
    same_hindex(got, JNE.build_hindex_native(gs, *args))
    same_hindex(got, HI.build_hindex(gs, threads_emul=threads))


def test_native_hindex_arrays_outlive_the_index():
    """Each array holds the native build's buffers alive by itself: kept
    past the index object (and the other arrays), it reads what it read."""
    gs = _genomes(33, False)
    idx = NE.build_hindex_native(gs, HI.DEFAULT_SPAN, HI.DEFAULT_STEP,
                                 HI.DEFAULT_BLOCKLIMIT, HI.DEFAULT_ALPHA, 2)
    def owner(arr):  # the ctypes buffer under the array (numpy may wrap
        base = arr.base  # it in a memoryview)
        return getattr(base, "obj", base)

    handle = owner(idx.ysa)._keepalive
    assert isinstance(handle, NE._BuildHandle)
    assert owner(idx.xs_val1)._keepalive is handle
    freed = []
    free = handle._lib.le_hindex_build_free
    handle._lib = type("Lib", (), {"le_hindex_build_free": staticmethod(
        lambda h: (freed.append(h), free(h)))})
    del handle
    ysa, want = idx.ysa, idx.ysa.copy()
    del idx
    gc.collect()
    assert not freed and np.array_equal(ysa, want)
    del ysa
    gc.collect()
    assert len(freed) == 1  # with the last array the build is freed, once


@pytest.mark.parametrize("threads", [1, 4])
def test_sindex_tables_match_jax(threads):
    gs = _genomes(34, True)
    got = SI.build_sindex(gs, threads_emul=threads)
    want = JSI.build_sindex(gs, threads_emul=threads)
    assert (got.span, got.weight) == (want.span, want.weight)
    for f in ("dir", "hs"):
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert len(got.hs) > 3000


def test_queries_on_a_carried_index_match_jax(corpus):
    """port_index(linear_tpu's index) through the port's query functions:
    whole reads and the partial ranges the re-apx path asks for."""
    g = [corpus["genome"]]
    jh, js = JHI.build_hindex(g, threads_emul=4), JSI.build_sindex(g, threads_emul=4)
    ph, ps = port_index(jh), port_index(js)
    assert isinstance(ph, HI.HIndex) and isinstance(ps, SI.SIndex)
    n_h = n_s = 0
    for r in corpus["reads"]:
        for a, b, alpha in ((0, len(r), 15), (len(r) // 3, len(r), 15),
                            (0, len(r) // 2, 7)):
            ms = make_cord(0, 0, a, 0)
            me = make_cord(MAX_CORD_ID, MAX_CORD_X, b, 0)
            got = HI.query_anchors(ph, r, ms, me, thd_alpha=alpha)
            assert np.array_equal(got, JHI.query_anchors(jh, r, ms, me,
                                                         thd_alpha=alpha))
            n_h += len(got)
            got = SI.query_anchors(ps, r, a, b, thd_alpha=alpha)
            assert np.array_equal(got, JSI.query_anchors(js, r, a, b,
                                                         thd_alpha=alpha))
            n_s += len(got)
    assert n_h > 500 and n_s > 500


@pytest.mark.parametrize("index_type", [1, 2, 3])
def test_mapper_on_a_carried_index_matches_jax(corpus, index_type):
    """Mapper.map_block with linear_tpu's own index object carried over:
    cords and SAM equal linear_tpu's, and equal the port's own build."""
    g = os.path.join(corpus["dir"], "g.fa")
    block = next(seqio.read_blocks(os.path.join(corpus["dir"], "r.fa")))
    jm = JMapper([g], JConfig(threads=4, bal_flag=0, index_type=index_type))
    jm.prepare()
    want = jm.map_block(block)
    outs = []
    for carried in (True, False):
        m = Mapper([g], MapperConfig(threads=4, bal_flag=0,
                                     index_type=index_type), device="host")
        if carried:
            m.index = port_index(jm.index)
        m.prepare()
        assert m.use_native() == (index_type != 3)
        outs.append(m.map_block(block))
    assert outs[0] == tuple(want) and outs[1] == tuple(want)
    assert outs[0][2].count("\n") >= 12


@pytest.mark.parametrize("args,tag", [
    (("-i", "2"), "i2"), (("-i", "2", "-b", "0"), "i2b0"),
    (("-i", "3"), "i3"), (("-i", "3", "-b", "0", "-t", "1"), "i3b0")])
def test_cli_matches_jax(corpus, args, tag):
    _, pp = NR.both_clis(corpus["dir"], tag,
                         ["../r.fa", "../g.fa", "-t", "4", *args, "-ot", "3",
                          "-o", "out"], OUT)
    with open(os.path.join(corpus["dir"], f"p_{tag}", "out.sam")) as fh:
        assert sum(not ln.startswith("@") for ln in fh) >= 12


def test_python_engine_on_the_hindex_matches_jax_and_native(corpus):
    """LINEAR_TPU_ENGINE=py: the Python HIndex build and query; equal to
    linear_tpu's with the variable, and to the native engine's files."""
    d = corpus["dir"]
    args = ["../r.fa", "../g.fa", "-t", "4", "-i", "2", "-ot", "3", "-o", "out"]
    env = NR.cli_env(LINEAR_TPU_ENGINE="py")
    NR.run_cli("linear_tpu", os.path.join(d, "j_i2py"), args, env=env)
    NR.run_cli("linear_tpu_torch", os.path.join(d, "p_i2py"), args, env=env)
    NR.run_cli("linear_tpu_torch", os.path.join(d, "p_i2nat"), args)
    NR.same_files(os.path.join(d, "p_i2py"), os.path.join(d, "j_i2py"), OUT)
    NR.same_files(os.path.join(d, "p_i2py"), os.path.join(d, "p_i2nat"), OUT)


@pytest.mark.parametrize("index_type", ["2", "3"])
def test_device_run_does_no_device_work(corpus, index_type):
    d = corpus["dir"]
    args = ["../r.fa", "../g.fa", "-t", "4", "-i", index_type, "-b", "0",
            "-ot", "3", "-o", "out"]
    p = NR.run_cli("linear_tpu_torch", os.path.join(d, f"p_dev{index_type}"),
                   [*args, "--device", "cpu"])
    note = [ln for ln in p.stderr.splitlines() if ln.startswith("--Device")]
    assert note == [f"--Device (cpu): -i {index_type} runs no device work; "
                    "the host engines map the reads"]
    NR.run_cli("linear_tpu", os.path.join(d, f"j_dev{index_type}"),
               [*args, "--device", "tpu"])
    NR.same_files(os.path.join(d, f"p_dev{index_type}"),
                  os.path.join(d, f"j_dev{index_type}"), OUT)
