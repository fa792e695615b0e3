"""BAM and pbsv BAM output of linear_tpu_torch (-ot bits 4 and 8) against
linear_tpu's: `filter -ot 15` as subprocesses in the pipeline (-b 1) and in
the serial loop (-b 0), with one shared -o prefix over two read files and
with an output set a read file; the .bam and _pbsv.bam (and .sam, .apf)
must be byte-identical (tolerance 0), and the "Result files:" lines equal.
Also: the files are BGZF-framed BAM, the two BAMs differ in their header
only, a device run (--device cpu: device seeds, and with -b 0 the device's
extension) writes the host run's BAM, the Python engine's BAM lines equal
the native engine's, and out.bam's encoders equal linear_tpu's."""
import gzip
import os

import numpy as np
import pytest

import test_torch_native_ready as NR
from linear_tpu.map.mapper import Mapper as JMapper
from linear_tpu.map.mapper import MapperConfig as JConfig
from linear_tpu.out import bam as JBAM
from linear_tpu_torch.map.mapper import Mapper, MapperConfig
from linear_tpu_torch.out import bam as BAM
from linear_tpu_torch.utils import seqio

ALL = ("out.sam", "out.apf", "out.bam", "out_pbsv.bam")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bam"))
    genome = NR.small_corpus(d, seed=7, n_reads=16)[0]
    NR.small_corpus(d, seed=8, n_reads=6, name="r2.fa", genome=genome)
    return d


def _result_line(p):
    return [ln for ln in p.stderr.splitlines() if ln.startswith("Result files")]


@pytest.mark.parametrize("bal", ["1", "0"])
def test_shared_prefix_over_two_read_files(corpus, bal):
    """-o routes both read files into one output set: one header, the
    records of both files in the one .bam."""
    pj, pp = NR.both_clis(
        corpus, f"shared{bal}",
        ["../r.fa", "../r2.fa", "x", "../g.fa", "-t", "4", "-b", bal, "-ot",
         "15", "-o", "out"], ALL)
    assert _result_line(pj) == _result_line(pp) == [
        "Result files: out.apf out.sam out.bam out_pbsv.bam"]


@pytest.mark.parametrize("bal", ["1", "0"])
def test_an_output_set_per_read_file(corpus, bal):
    pj, pp = NR.both_clis(
        corpus, f"perfile{bal}",
        ["../r.fa", "../r2.fa", "x", "../g.fa", "-t", "4", "-b", bal, "-ot",
         "15"], [f"{r}{ext}" for r in ("r", "r2")
                 for ext in (".sam", ".apf", ".bam", "_pbsv.bam")])
    assert _result_line(pj) == _result_line(pp) and len(_result_line(pp)) == 2


def test_bam_alone_and_pbsv_alone(corpus):
    """-ot 4 writes the .bam only, -ot 8 the _pbsv.bam only."""
    for ot, name in (("4", "out.bam"), ("8", "out_pbsv.bam")):
        NR.both_clis(corpus, f"ot{ot}", ["../r.fa", "../g.fa", "-t", "4",
                                         "-ot", ot, "-o", "out"], [name])
        assert sorted(os.listdir(os.path.join(corpus, f"p_ot{ot}"))) == [name]


def test_files_are_bgzf_bam(corpus):
    """Both files gunzip to a BAM stream; they differ in the header text
    only (the pbsv header's @HD/@PG lines), not in a record."""
    NR.run_cli("linear_tpu_torch", os.path.join(corpus, "p_frame"),
               ["../r.fa", "../g.fa", "-t", "4", "-ot", "12", "-o", "out"])
    raw = {}
    for name in ("out.bam", "out_pbsv.bam"):
        with gzip.open(os.path.join(corpus, "p_frame", name), "rb") as fh:
            raw[name] = fh.read()
        assert raw[name][:4] == b"BAM\x01"
    texts = {}
    for name, data in raw.items():
        l_text = int.from_bytes(data[4:8], "little")
        texts[name] = data[8: 8 + l_text]
        raw[name] = data[8 + l_text:]
    assert texts["out.bam"] != texts["out_pbsv.bam"]
    assert raw["out.bam"] == raw["out_pbsv.bam"] and len(raw["out.bam"]) > 500


@pytest.mark.parametrize("bal", ["1", "0"])
def test_device_run_writes_the_host_bam(corpus, bal):
    """--device cpu seeds on the device (and with -b 0 extends there); the
    BAM lines come from the same cords."""
    args = ["../r.fa", "../g.fa", "-t", "4", "-b", bal, "-ot", "15", "-o", "out"]
    p = NR.run_cli("linear_tpu_torch", os.path.join(corpus, f"p_dev{bal}"),
                   [*args, "--device", "cpu"])
    NR.run_cli("linear_tpu_torch", os.path.join(corpus, f"p_host{bal}"), args)
    NR.same_files(os.path.join(corpus, f"p_dev{bal}"),
                  os.path.join(corpus, f"p_host{bal}"), ALL)
    seed = [ln for ln in p.stderr.splitlines() if "--Device seeding (cpu)" in ln]
    assert seed and int(seed[0].split("seeded reads ")[1].split()[0]) > 8


def _block(corpus):
    return next(seqio.read_blocks(os.path.join(corpus, "r.fa")))


def _plain(lines):
    """BAM lines with each package's Cigar objects as (op, count) pairs."""
    return [dict(ln, cigar=[(c.op, c.count) for c in ln["cigar"]])
            for ln in lines]


@pytest.mark.parametrize("engine", ["native", "py"])
def test_map_block_bam_lines_match_jax(corpus, monkeypatch, engine):
    """Mapper.map_block(collect_bam=True) in process: cords, SAM and the
    BAM line dictionaries equal linear_tpu's, with either engine."""
    monkeypatch.setenv("LINEAR_TPU_ENGINE", engine)
    g = os.path.join(corpus, "g.fa")
    jm = JMapper([g], JConfig(threads=4, bal_flag=0, output_type=15))
    jm.prepare()
    want = jm.map_block(_block(corpus), collect_bam=True)
    m = Mapper([g], MapperConfig(threads=4, bal_flag=0, output_type=15),
               device="host")
    m.prepare()
    got = m.map_block(_block(corpus), collect_bam=True)
    assert m.use_native() == (engine == "native")
    assert len(got) == 4 and len(got[3]) >= 14
    assert got[:3] == tuple(want[:3])
    assert _plain(got[3]) == _plain(want[3])
    assert len(m.map_block(_block(corpus))) == 3  # no BAM lines unasked


def test_write_bam_matches_jax(corpus, tmp_path):
    """out.bam's record encoder and BGZF writer on the same BAM lines."""
    g = os.path.join(corpus, "g.fa")
    m = Mapper([g], MapperConfig(threads=4, sequence_sam=1), device="host")
    m.prepare()
    lines = m.map_block(_block(corpus), collect_bam=True)[3]
    assert any(ln.get("seq") for ln in lines) or lines
    for mod, name in ((BAM, "port.bam"), (JBAM, "jax.bam")):
        mod.write_bam(str(tmp_path / name), m.sam_header(), m.genome_ids,
                      m.genome_lens, lines)
    assert (tmp_path / "port.bam").read_bytes() == \
        (tmp_path / "jax.bam").read_bytes()
    rng = np.random.default_rng(1)
    blob = rng.integers(0, 256, 200000).astype(np.uint8).tobytes()
    assert BAM.bgzf_compress(blob) == JBAM.bgzf_compress(blob)
