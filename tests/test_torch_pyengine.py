"""The Python engine of linear_tpu_torch (LINEAR_TPU_ENGINE=py, and -a 1)
against linear_tpu's, on a 60 kb genome with an N-gap and 14 reads (a read
at or below the 200-base cut, a 6 kb read, an N read, a chimera, every
third reverse-complemented): the host modules it runs on (numpy features,
the DIndex samples and query, the std::sort permutation), Mapper.map_block
and the -b 1 pipeline in process, and the CLI as subprocesses. SAM (and
APF) must be byte-identical to linear_tpu's with the same variable and to
the port's native engine; with --device cpu the plain chain DP runs and the
SAM stays the same. -a 1 on 3 reads equals linear_tpu's -a 1."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import test_torch_native_ready  # noqa: F401  (the JAX package's libraries)
from linear_tpu.index import dindex as JDI
from linear_tpu.map.mapper import Mapper as JMapper
from linear_tpu.map.mapper import MapperConfig as JConfig
from linear_tpu.ops import features as JF
from linear_tpu.utils import cxxsort as JCXS
from linear_tpu_torch.index import dindex as DI
from linear_tpu_torch.map import nengine as NE
from linear_tpu_torch.map.mapper import Mapper, MapperConfig
from linear_tpu_torch.ops import features as F
from linear_tpu_torch.parallel.pipeline import PipelineMapper
from linear_tpu_torch.utils import cxxsort as CXS
from linear_tpu_torch.utils import seqio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(engine="py"):
    return dict(os.environ, JAX_PLATFORMS="cpu", LINEAR_TPU_ENGINE=engine,
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("pyengine")
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 60000).astype(np.uint8)
    genome[30000:30300] = 4
    seqio.write_fasta(str(d / "g.fa"), ["chr1 test"], [genome])
    reads = []
    for i in range(14):
        ln = [150, 201, 6000][i] if i < 3 else int(rng.integers(1000, 4000))
        pos = int(rng.integers(0, 60000 - ln))
        r = genome[pos: pos + ln].copy()
        sub = rng.random(ln) < 0.05
        r[sub] = (r[sub] + 1) % 4
        if i == 7:  # a chimera of two distant segments
            p2 = int(rng.integers(0, 55000))
            r = np.concatenate([r, genome[p2: p2 + 1500]])
        if i % 3 == 2:
            r = seqio.revcomp(r)
        if i == 5:
            r[100:103] = 4
        reads.append(r)
    ids = [f"read{i} t" for i in range(14)]
    seqio.write_fasta(str(d / "r.fa"), ids, reads)
    seqio.write_fasta(str(d / "r3.fa"), ids[2:5], reads[2:5])
    return {"dir": str(d), "genome": genome, "reads": reads, "ids": ids}


def test_numpy_features_equal_native(corpus):
    """Mapper.create_features wraps the native 2_48 build: bit-equal to the
    port's numpy builder and to linear_tpu's."""
    g = corpus["genome"]
    nat = NE.build_features_native(g, 4)
    assert np.array_equal(F.create_features_genome(g, 4), nat)
    assert np.array_equal(JF.create_features_genome(g, 4), nat)


def test_sampled_minimizers_match_jax(corpus):
    g = corpus["genome"]
    got = DI.sampled_minimizers(g, 21, 13, 8, 10, 4)
    want = JDI.sampled_minimizers(g, 21, 13, 8, 10, 4)
    assert len(got[0]) > 1000
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_query_anchors_match_jax(corpus):
    """getDIndexMatchAll on the native table, whole reads and the partial
    ranges the re-apx path asks for, against linear_tpu on its own
    (numpy-built) table."""
    g = corpus["genome"]
    idx = DI.build_dindex([g], 4)
    jidx = JDI.build_dindex([g], threads_emul=4)
    for r in corpus["reads"][1:]:
        for a, b, alpha in ((0, len(r), 15), (len(r) // 3, len(r), 15),
                            (0, len(r) // 2, 7)):
            got = DI.query_anchors(idx, r, a, b, thd_alpha=alpha)
            want = JDI.query_anchors(jidx, r, a, b, thd_alpha=alpha)
            assert np.array_equal(got, want)


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("n", [0, 1, 16, 17, 300, 5000])
def test_std_sort_matches_the_python_replica(n, desc):
    """The native lt_sort permutation equals linear_tpu's statement-level
    replica of libstdc++'s introsort, ties included."""
    keys = np.random.default_rng(n).integers(0, max(2, n // 8), n)
    assert CXS.std_sort_perm(keys, desc=desc).tolist() == \
        JCXS._py_sort_perm(keys.tolist(), desc)


def _port_map(corpus, device, engine, monkeypatch, bal=0, aln=0):
    monkeypatch.setenv("LINEAR_TPU_ENGINE", engine)
    m = Mapper([os.path.join(corpus["dir"], "g.fa")],
               MapperConfig(threads=4, bal_flag=bal, aln_flag=aln),
               device=device)
    m.prepare()
    block = next(seqio.read_blocks(os.path.join(corpus["dir"], "r.fa")))
    return m, m.map_block(block)


@pytest.mark.parametrize("bal", [0, 1])
def test_map_block_matches_jax_and_native(corpus, monkeypatch, bal):
    """-b 0 emulates `threads` compute threads (per-thread GapParms), -b 1
    one; the port's Python engine equals linear_tpu's and the native
    engine, cords and SAM."""
    monkeypatch.setenv("LINEAR_TPU_ENGINE", "py")
    jm = JMapper([os.path.join(corpus["dir"], "g.fa")],
                 JConfig(threads=4, bal_flag=bal))
    jm.prepare()
    assert jm.native_engine() is None
    want = jm.map_block(next(seqio.read_blocks(
        os.path.join(corpus["dir"], "r.fa"))))
    m, got = _port_map(corpus, "host", "py", monkeypatch, bal)
    assert not m.use_native() and m._nengine is None
    _, nat = _port_map(corpus, "host", "native", monkeypatch, bal)
    assert "\t" in got[2]
    assert got == want
    assert got == nat


def test_device_cpu_chains_and_keeps_the_sam(corpus, monkeypatch):
    """device cpu: seeds and the plain chain DP; the engine starts from the
    DP tables of every read chained there, and the SAM is the host's."""
    from linear_tpu_torch.map import chaining as CH

    base = CH.chain_anchors_base
    from_tables = []

    def counting(*args, **kw):
        from_tables.append(kw.get("pre_recs") is not None)
        return base(*args, **kw)

    monkeypatch.setattr(CH, "chain_anchors_base", counting)
    m, got = _port_map(corpus, "cpu", "py", monkeypatch)
    monkeypatch.setattr(CH, "chain_anchors_base", base)
    _, want = _port_map(corpus, "host", "py", monkeypatch)
    cc = m.chain_counters
    assert cc.seeded == 12  # 14 reads: 1 at or below 200 bases, 1 with N
    assert cc.chained > 0 and sum(from_tables) == cc.chained
    assert cc.chained + cc.host_few + cc.host_many + cc.host_overflow == 12
    assert got == want


@pytest.mark.parametrize("collect_cords", [False, True])
def test_pipeline_python_engine(corpus, monkeypatch, collect_cords):
    """-b 1: the pipeline with the Python engine (device cpu: the collector
    chains each superchunk's seeded reads; small superchunks give several)
    writes the SAM of the host Python engine and of the native engine."""
    sams = {}
    for device, engine in (("cpu", "py"), ("host", "py"), ("host", "native")):
        monkeypatch.setenv("LINEAR_TPU_ENGINE", engine)
        m = Mapper([os.path.join(corpus["dir"], "g.fa")],
                   MapperConfig(threads=4), device=device)
        m.SEED_SUPERCHUNK = 8
        with PipelineMapper(m, n_workers=2, csize_workers=4) as pipe:
            res = list(pipe.run(os.path.join(corpus["dir"], "r.fa"),
                                collect_cords=collect_cords))
        sams[(device, engine)] = "".join(br.sam for br in res)
        if collect_cords:
            assert sum(len(br.cords_str) for br in res) == 14
        if device == "cpu":
            cc = m.chain_counters
            assert cc.seeded == 12 and cc.chained > 0
            assert (cc.chained + cc.host_few + cc.host_many
                    + cc.host_overflow) == 12
    assert sams[("cpu", "py")] and len(set(sams.values())) == 1


def _filter(pkg, d, device, name, extra=(), reads="r.fa", engine="py"):
    p = subprocess.run(
        [sys.executable, "-m", pkg, "filter", reads, "g.fa", "-t", "4",
         "--device", device, "-o", name, "-ot", "3", *extra], cwd=d,
        env=_env(engine), capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    outs = []
    for ext in ("sam", "apf"):
        with open(os.path.join(d, f"{name}.{ext}"), "rb") as fh:
            outs.append(fh.read())
    return outs, p.stderr


def _chaining_counts(stderr):
    m = re.search(r"--Device chaining \(cpu\): chained on the device (\d+) of "
                  r"(\d+) seeded reads, kernel launches (\d+); host DP: (\d+) "
                  r"with fewer than 2 anchors, (\d+) over 8192 anchors, (\d+) "
                  r"overflowing W", stderr)
    assert m, stderr[-2000:]
    return [int(v) for v in m.groups()]


@pytest.mark.parametrize("bal", ["0", "1"])
def test_cli_matches_jax(corpus, bal):
    """LINEAR_TPU_ENGINE=py filter: the port on device host and cpu against
    linear_tpu on host; the cpu run accounts for every seeded read."""
    d = corpus["dir"]
    want, _ = _filter("linear_tpu", d, "host", f"j{bal}", ("-b", bal))
    got, _ = _filter("linear_tpu_torch", d, "host", f"p{bal}", ("-b", bal))
    dev, err = _filter("linear_tpu_torch", d, "cpu", f"c{bal}", ("-b", bal))
    assert want[0] and got == want and dev == want
    chained, seeded, launches, few, many, ovf = _chaining_counts(err)
    assert seeded == 12 and chained > 0 and launches == 0
    assert chained + few + many + ovf == seeded
    assert "--Device extension" not in err


def test_align_matches_jax(corpus):
    """-a 1 (the Python engine whatever LINEAR_TPU_ENGINE says) on 3 reads:
    the port on host, on device cpu with -b 0 and -b 1, against
    linear_tpu's -a 1."""
    d = corpus["dir"]
    want, _ = _filter("linear_tpu", d, "host", "ja", ("-a", "1", "-b", "0"),
                      "r3.fa", "native")
    got, _ = _filter("linear_tpu_torch", d, "host", "pa", ("-a", "1", "-b", "0"),
                     "r3.fa", "native")
    dev0, err = _filter("linear_tpu_torch", d, "cpu", "ca0",
                        ("-a", "1", "-b", "0"), "r3.fa", "native")
    dev1, _ = _filter("linear_tpu_torch", d, "cpu", "ca1", ("-a", "1"),
                      "r3.fa", "native")
    assert re.search(rb"\t\d+=\d+X", want[0])  # base-level CIGARs
    assert got == want and dev0 == want and dev1 == want
    assert _chaining_counts(err)[0] > 0


@pytest.mark.parametrize("extra,engine", [
    (("-b", "1"), "py"), (("-b", "0"), "py"), (("-a", "1"), "native")],
    ids=["py-b1", "py-b0", "a1"])
def test_cuda_without_a_card_exits_1(corpus, extra, engine):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    p = subprocess.run(
        [sys.executable, "-m", "linear_tpu_torch", "filter", "r3.fa", "g.fa",
         "-t", "4", "--device", "cuda", *extra], cwd=corpus["dir"],
        env=_env(engine), capture_output=True, text=True, timeout=300)
    assert p.returncode == 1, p.stderr[-2000:]
    assert "E[dev]" in p.stderr and "no CUDA device" in p.stderr
    assert "Traceback" not in p.stderr
