"""Feature types -f 0 (1_16) and -f 1 (1_32) of linear_tpu_torch against
linear_tpu's: `filter -f 0/1` as subprocesses, pipeline (-b 1) and serial
loop (-b 0), SAM and APF byte-identical (tolerance 0); the genome feature
arrays of Mapper.create_features equal; the per-thread read-feature buffers
(Mapper._f1_bufs: a shorter read leaves the previous read's tail rows in
place, and the window distance reads them) equal linear_tpu's over two
blocks, within a block, across the blocks of a run and across the tasks of
a pipeline worker. These configurations run the Python engine; with
--device cpu the run says that it does no device work, and writes the host
run's files."""
import os

import numpy as np
import pytest

import test_torch_native_ready as NR
from linear_tpu.map import pmpfinder as JPMP
from linear_tpu.map.mapper import Mapper as JMapper
from linear_tpu.map.mapper import MapperConfig as JConfig
from linear_tpu_torch.map import pmpfinder as PMP
from linear_tpu_torch.map.mapper import Mapper, MapperConfig
from linear_tpu_torch.utils import seqio

OUT = ("out.sam", "out.apf")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("feat1"))
    genome, reads, ids = NR.small_corpus(d, seed=17, n_reads=12)
    # a second file whose first read is shorter than the first file's last
    NR.small_corpus(d, seed=18, n_reads=5, name="r2.fa", genome=genome)
    return d


@pytest.fixture
def feature_type_2():
    """Both packages keep the feature type in module state: back to 2_48
    after a test that mapped in process with another."""
    yield
    PMP.set_feature_type(2)
    JPMP.set_feature_type(2)


@pytest.mark.parametrize("bal", ["1", "0"])
@pytest.mark.parametrize("ft", ["0", "1"])
def test_cli_matches_jax(corpus, ft, bal):
    _, pp = NR.both_clis(corpus, f"f{ft}b{bal}",
                         ["../r.fa", "../g.fa", "-t", "4", "-f", ft, "-b", bal,
                          "-ot", "3", "-o", "out"], OUT)
    with open(os.path.join(corpus, f"p_f{ft}b{bal}", "out.sam")) as fh:
        assert sum(not ln.startswith("@") for ln in fh) >= 10
    assert "--Device" not in pp.stderr


def test_two_read_files_share_the_threads_buffers(corpus):
    """One worker (-t 1) keeps its buffers from the first file's reads into
    the second's: equal to linear_tpu, shared output."""
    NR.both_clis(corpus, "f1two", ["../r.fa", "../r2.fa", "x", "../g.fa", "-t",
                                   "1", "-f", "1", "-ot", "3", "-o", "out"],
                 OUT)


@pytest.mark.parametrize("ft", ["0", "1"])
def test_device_run_does_no_device_work(corpus, ft):
    """--device cpu with -f 0/1 maps on the host engine, as linear_tpu
    --device tpu does, and says so; its files are the host run's."""
    args = ["../r.fa", "../g.fa", "-t", "4", "-f", ft, "-ot", "3", "-o", "out"]
    p = NR.run_cli("linear_tpu_torch", os.path.join(corpus, f"p_dev{ft}"),
                   [*args, "--device", "cpu"])
    note = [ln for ln in p.stderr.splitlines() if ln.startswith("--Device")]
    assert note == [f"--Device (cpu): -f {ft} runs no device work; the host "
                    "engines map the reads"]
    NR.run_cli("linear_tpu", os.path.join(corpus, f"j_dev{ft}"),
               [*args, "--device", "tpu"])
    NR.same_files(os.path.join(corpus, f"p_dev{ft}"),
                  os.path.join(corpus, f"j_dev{ft}"), OUT)


def _mappers(corpus, ft, bal):
    g = os.path.join(corpus, "g.fa")
    jm = JMapper([g], JConfig(threads=3, bal_flag=bal, feature_t=ft))
    m = Mapper([g], MapperConfig(threads=3, bal_flag=bal, feature_t=ft),
               device="cpu")
    jm.prepare()
    m.prepare()
    return jm, m


@pytest.mark.parametrize("ft", [0, 1])
def test_genome_features_match_jax(corpus, ft, feature_type_2):
    jm, m = _mappers(corpus, ft, 1)
    assert not m.use_native() and not m.device_work()
    assert PMP.FT == JPMP.FT == ft
    assert len(m.f2) == len(jm.f2) == 1
    assert m.f2[0].arr.dtype == jm.f2[0].arr.dtype
    assert np.array_equal(m.f2[0].arr, jm.f2[0].arr) and len(m.f2[0].arr) > 100


@pytest.mark.parametrize("bal", [0, 1])
@pytest.mark.parametrize("ft", [0, 1])
def test_buffers_over_two_blocks_match_jax(corpus, ft, bal, feature_type_2):
    """map_block twice (-b 0: three emulated threads, each with its own
    buffers; -b 1: one): cords and SAM equal, and after each block every
    thread's forward and reverse buffer equal linear_tpu's, stale tail and
    capacity included. A block starts with fresh buffers."""
    jm, m = _mappers(corpus, ft, bal)
    for name in ("r.fa", "r2.fa"):
        block = next(seqio.read_blocks(os.path.join(corpus, name)))
        want = jm.map_block(block)
        got = m.map_block(block)
        assert got == tuple(want) and "\t" in got[2]
        assert sorted(m._f1_bufs) == sorted(jm._f1_bufs)
        assert len(m._f1_bufs) == (3 if bal == 0 else 1)
        for tid, bufs in m._f1_bufs.items():
            for b, jb in zip(bufs, jm._f1_bufs[tid]):
                assert b.len == jb.len and np.array_equal(b.buf, jb.buf)
        longest = max(len(r) for r in block.seqs)
        last = m._f1_bufs[max(m._f1_bufs)][0]
        if len(block.seqs[-1]) < longest and bal == 1:
            assert last.len < len(last.buf)  # a tail past the last read's rows


def test_worker_keeps_its_buffers_across_tasks(corpus, feature_type_2):
    """A pipeline worker that never resets (one worker) maps its second task
    with the buffers its first left: py_map_reads twice equals linear_tpu's
    generators run the same way, buffers included; reset_gap_parms (a new
    task of one worker among several) drops them."""
    jm, m = _mappers(corpus, 1, 1)
    b1 = next(seqio.read_blocks(os.path.join(corpus, "r.fa")))
    b2 = next(seqio.read_blocks(os.path.join(corpus, "r2.fa")))
    sams = []
    for block in (b1, b2):
        n = len(block.seqs)
        out = m.py_map_reads(block.seqs, block.ids, [None] * n, [None] * n,
                             [0] * n)
        sams.append("".join(o[2] for o in out))
        mapped = JPMP.run_lockstep([jm.map_read_gen(r) for r in block.seqs])
        want = []
        for r, rid, (cs, ce, _, rc, f1) in zip(block.seqs, block.ids, mapped):
            jm.gap_phase(r, rc, cs, ce, f1)
            want.append(jm.read_output(r, rid, cs, ce)[0])
        assert sams[-1] == "".join(want)
    for b, jb in zip(m._f1_bufs[0], jm._f1_bufs[0]):
        assert b.len == jb.len and np.array_equal(b.buf, jb.buf)
    m.reset_gap_parms()
    assert m._f1_bufs == {}
