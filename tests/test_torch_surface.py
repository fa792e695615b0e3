"""The rest of linear_tpu's surface in the port, against linear_tpu on the
CPU: DIndex.full_size / query, block seeding (ops.seeding.seed_block_dispatch
/ seed_block_collect and Mapper._device_seed_block, the plain seed kernel on
CPU tensors, against JAX's on JAX-CPU), Mapper.map_read read by read,
Mapper.warmup, and the pipeline's live dashboard (LINEAR_TPU_DASH). The
corpus is test_torch_pyengine's: a 60 kb genome with an N-gap and 14 reads
(one at or below 200 bases, a 6 kb read, a read with N, a chimera, every
third reverse-complemented). Tolerance 0: anchors as uint64 arrays, None
at the same reads, cords and SAM byte for byte."""
import os
import subprocess
import sys

import numpy as np
import pytest

import test_torch_native_ready  # noqa: F401  (the JAX package's libraries)
from linear_tpu.index import dindex as JDI
from linear_tpu.map.mapper import Mapper as JMapper
from linear_tpu.map.mapper import MapperConfig as JConfig
from linear_tpu.ops import seeding as JSD
from linear_tpu_torch.index import dindex as DI
from linear_tpu_torch.map.mapper import Mapper, MapperConfig
from linear_tpu_torch.ops import seeding as SD
from linear_tpu_torch.parallel.pipeline import PipeCounters, PipelineMapper
from linear_tpu_torch.utils import seqio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a per-read anchor cap that some N-free reads of the corpus overflow, and
# superchunks of 4 reads, so that a block takes several
SMALL_M_OUT = 96
SMALL_SUPERCHUNK = 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("surface")
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
    return {"dir": str(d), "g": str(d / "g.fa"), "r": str(d / "r.fa"),
            "genome": genome, "reads": reads, "ids": ids}


def _same_entries(got, want):
    assert len(got) == len(want)
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == np.uint64
            assert np.array_equal(g, np.asarray(w, dtype=np.uint64))


def test_dindex_query_and_full_size(corpus):
    idx = DI.build_dindex([corpus["genome"]], 4)
    jidx = JDI.build_dindex([corpus["genome"]], threads_emul=4)
    assert idx.full_size == jidx.full_size == (1 << 26) + 1
    counts = np.diff(idx.dir)
    busy = int(np.flatnonzero(counts)[len(np.flatnonzero(counts)) // 2])
    for x in (0, busy, idx.full_size - 2):
        got = idx.query(x)
        assert got.dtype == np.uint64
        assert np.array_equal(got, jidx.query(x))
    assert len(idx.query(busy)) == counts[busy] > 0


def test_seed_block_dispatch_collect_match_jax(corpus):
    """The block functions on the uploaded host index: one entry a read,
    every superchunk dispatched before the first collect, None for the read
    with N and for reads whose probe passes m_out."""
    idx = DI.build_dindex([corpus["genome"]], 4)
    jidx = JDI.build_dindex([corpus["genome"]], threads_emul=4)
    reads = [r for r in corpus["reads"] if len(r) > 200]
    pad = 8192
    disp = SD.seed_block_dispatch(reads, SD.upload_index(idx.dir, idx.hs,
                                                         "cpu"),
                                  pad, m_out=SMALL_M_OUT,
                                  superchunk=SMALL_SUPERCHUNK)
    assert len(disp) == -(-len(reads) // SMALL_SUPERCHUNK)
    got = SD.seed_block_collect(disp, m_out=SMALL_M_OUT)
    want = JSD.seed_block_collect(
        JSD.seed_block_dispatch(reads, JSD.upload_index(jidx), pad,
                                m_out=SMALL_M_OUT,
                                superchunk=SMALL_SUPERCHUNK),
        m_out=SMALL_M_OUT)
    _same_entries(got, want)
    has_n = [bool((r == 4).any()) for r in reads]
    assert sum(g is None for g, n in zip(got, has_n) if not n) >= 1
    assert all(g is None for g, n in zip(got, has_n) if n)
    assert sum(g is not None for g in got) >= 3
    with pytest.raises(ValueError):
        SD.seed_block_dispatch(reads, None, pad, thd_alpha=7)


@pytest.mark.parametrize("m_out", [SMALL_M_OUT, Mapper.SEED_M_OUT])
def test_mapper_device_seed_block_matches_jax(corpus, m_out):
    """Mapper._device_seed_block on cpu against JAX's on JAX-CPU
    (tests/test_device.py:102-121 runs it so): None for the read at or
    below 200 bases, the read with N and the overflows, the rest equal."""
    jm = JMapper([corpus["g"]], JConfig(threads=4), device="tpu")
    jm.prepare()
    m = Mapper([corpus["g"]], MapperConfig(threads=4), device="cpu")
    m.prepare()
    for mp in (jm, m):
        mp.SEED_M_OUT = m_out
        mp.SEED_SUPERCHUNK = SMALL_SUPERCHUNK
    block = next(seqio.read_blocks(corpus["r"]))
    got = m._device_seed_block(block)
    _same_entries(got, jm._device_seed_block(block))
    assert got[0] is None and got[5] is None
    assert sum(g is not None for g in got) >= 3
    empty = seqio.SeqSet(ids=["s"], seqs=[block.seqs[0]])
    assert m._device_seed_block(empty) == [None]


@pytest.mark.parametrize("gap_len", [0, 50])
def test_map_read_matches_jax(corpus, gap_len):
    """Mapper.map_read read by read, in order (the gap phase carries its
    GapParms from read to read): (cords_str, cords_end, cords_info) equal
    to linear_tpu's, with host seeds and with the device's (cpu)."""
    jm = JMapper([corpus["g"]], JConfig(threads=4, gap_len=gap_len))
    jm.prepare()
    want = [jm.map_read(r) for r in corpus["reads"]]
    assert sum(len(w[0]) for w in want) > 0
    for device in ("host", "cpu"):
        m = Mapper([corpus["g"]], MapperConfig(threads=4, gap_len=gap_len),
                   device=device)
        m.prepare()
        seeds = ([None] * len(corpus["reads"]) if device == "host" else
                 m._device_seed_block(seqio.SeqSet(ids=corpus["ids"],
                                                   seqs=corpus["reads"])))
        got = [m.map_read(r, seed_anchors=s)
               for r, s in zip(corpus["reads"], seeds)]
        assert got == want


def _pipeline_sam(corpus, device, warm=False):
    m = Mapper([corpus["g"]], MapperConfig(threads=4), device=device)
    with PipelineMapper(m, n_workers=2, csize_workers=4) as pipe:
        if warm:
            m.warmup()
        return "".join(br.sam for br in pipe.run(corpus["r"]))


def test_warmup_cpu_keeps_the_sam(corpus, monkeypatch):
    """warmup on cpu launches the plain versions at the production shapes
    (the seed superchunk at (1024, 8192, 128) and (256, 8192, 512), the
    windowed DP at (256, 64..1024)), and a -b 1 run after it writes the
    SAM of a run without it."""
    from linear_tpu_torch.ops import chain_dp as CDP

    calls = []
    base = CDP.chain_dp_windowed

    def spy(a, c, **kw):
        calls.append(tuple(a.shape))
        return base(a, c, **kw)

    monkeypatch.setattr(CDP, "chain_dp_windowed", spy)
    warm = _pipeline_sam(corpus, "cpu", warm=True)
    monkeypatch.setattr(CDP, "chain_dp_windowed", base)
    assert calls == [(256, n) for n in (64, 128, 256, 512, 1024)]
    assert warm and warm == _pipeline_sam(corpus, "cpu") == \
        _pipeline_sam(corpus, "host")


@pytest.mark.parametrize("device,cfg", [("host", {}), ("cpu", {"index_type": 2})])
def test_warmup_raises_without_device_work(corpus, device, cfg):
    m = Mapper([corpus["g"]], MapperConfig(threads=4, **cfg), device=device)
    m.prepare()
    with pytest.raises(ValueError, match="does not seed"):
        m.warmup()
    with pytest.raises(ValueError, match="does not seed"):
        m._device_seed_block(seqio.SeqSet(ids=["r"], seqs=corpus["reads"][:1]))


def test_cuda_without_a_card_raises(corpus):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot run")
    m = Mapper([corpus["g"]], MapperConfig(threads=4), device="cuda")
    m.prepare()
    for call in (m.warmup, lambda: m._device_seed_block(
            seqio.SeqSet(ids=["r"], seqs=corpus["reads"][2:3]))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("dash,rows", [("1", True), ("0", False),
                                       (None, False)])
def test_dashboard_in_process(corpus, monkeypatch, capsys, dash, rows):
    """LINEAR_TPU_DASH=1 draws the four rows while the run lasts and a
    final one with the run's counts; =0, and unset with stderr not a
    terminal, draw nothing. The SAM is the same either way."""
    if dash is None:
        monkeypatch.delenv("LINEAR_TPU_DASH", raising=False)
    else:
        monkeypatch.setenv("LINEAR_TPU_DASH", dash)
    m = Mapper([corpus["g"]], MapperConfig(threads=4), device="cpu")
    with PipelineMapper(m, n_workers=2, csize_workers=4) as pipe:
        sam = "".join(br.sam for br in pipe.run(corpus["r"]))
        c = pipe.counters
    err = capsys.readouterr().err
    assert c.enabled is rows
    assert c.fetched == c.computed == c.emitted == 14
    assert c.seeded == 12 - c.host_overflow
    names = ("I/O::in", "Seeded", "Compute", "Processed")
    if rows:
        for name, cnt in zip(names, (14, c.seeded, 14, 14)):
            assert f"\x1b[2K  {name}:\t{cnt}\ttime:" in err
        assert err.endswith("[reads/s]\n")
    else:
        assert not any(name + ":" in err for name in names)
    assert sam == _pipeline_sam(corpus, "host")


def test_dashboard_render_cursor(monkeypatch, capsys):
    """Each redraw moves the cursor up over the four rows drawn before;
    the final draw leaves it below them."""
    monkeypatch.setenv("LINEAR_TPU_DASH", "1")
    c = PipeCounters(interval=60)
    c.fetched = 3
    c._render()
    c._render()
    c._render(final=True)
    c._render()
    err = capsys.readouterr().err
    assert err.count("\x1b[4A") == 2
    assert err.count("I/O::in:\t3\t") == 4


def _cli(corpus, dash, d):
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("LINEAR_TPU_DASH", None)
    if dash is not None:
        env["LINEAR_TPU_DASH"] = dash
    p = subprocess.run(
        [sys.executable, "-m", "linear_tpu_torch", "filter", corpus["r"],
         corpus["g"], "-t", "4", "--device", "host", "-o", "out", "-ot", "3"],
        cwd=d, env=env, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    files = []
    for ext in ("sam", "apf"):
        with open(os.path.join(d, "out." + ext), "rb") as fh:
            files.append(fh.read())
    return files, p.stderr


def test_dashboard_cli_files_unchanged(corpus):
    """The CLI with the dashboard on, off and unset (stderr a pipe): the
    same SAM and APF; only =1 draws the rows on stderr, and the stderr
    lines the CLI prints itself are the same."""
    runs = {d: _cli(corpus, d, os.path.join(corpus["dir"], f"dash{d}"))
            for d in ("1", "0", None)}
    assert runs["1"][0] == runs["0"][0] == runs[None][0]
    assert "Processed:\t14\t" in runs["1"][1]
    for d in ("0", None):
        assert "\x1b[" not in runs[d][1]

    def own(err):
        return [ln for ln in err.splitlines()
                if "\x1b" not in ln and "time" not in ln.lower()
                and "speed" not in ln]

    assert own(runs["1"][1]) == own(runs["0"][1]) == own(runs[None][1])
