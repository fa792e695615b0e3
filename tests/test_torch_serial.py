"""Index files (--save-index / --load-index) of linear_tpu_torch against
linear_tpu's: same .npz format and fingerprint, so each package loads the
other's file. For each index kind (-i 1, 2, 3): the files the two CLIs
save hold equal arrays; a run that loads the other package's file writes
the SAM of a run that builds; in process, save_index / load_index round
trip the tables exactly and across the packages. A file of another index
kind, or of genomes of other lengths, exits 1 with linear_tpu's message."""
import os

import numpy as np
import pytest

import test_torch_native_ready as NR
from linear_tpu.index import serial as JSER
from linear_tpu.map.mapper import Mapper as JMapper
from linear_tpu.map.mapper import MapperConfig as JConfig
from linear_tpu_torch.index import dindex as DI
from linear_tpu_torch.index import hindex as HI
from linear_tpu_torch.index import serial as SER
from linear_tpu_torch.index import sindex as SI
from linear_tpu_torch.map.mapper import Mapper, MapperConfig
from linear_tpu_torch.utils import seqio
from test_torch_hindex import port_index

KINDS = {1: ("dindex", DI.DIndex), 2: ("hindex", HI.HIndex),
         3: ("sindex", SI.SIndex)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serial"))
    NR.small_corpus(d, seed=37, n_reads=10)
    other = os.path.join(d, "other")
    os.makedirs(other)
    NR.small_corpus(other, seed=38, n_reads=2, genome_len=50000)
    return d


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def saved(corpus):
    """Each package's CLI builds and saves each index kind, and maps."""
    for it in (1, 2, 3):
        NR.both_clis(corpus, f"save{it}",
                     ["../r.fa", "../g.fa", "-t", "4", "-i", it, "-o", "out",
                      "--save-index", f"idx{it}"], ["out.sam"])
    return corpus


@pytest.mark.parametrize("index_type", [1, 2, 3])
def test_saved_files_hold_equal_arrays(saved, index_type):
    a = _npz(os.path.join(saved, f"j_save{index_type}", f"idx{index_type}.npz"))
    b = _npz(os.path.join(saved, f"p_save{index_type}", f"idx{index_type}.npz"))
    assert str(a["kind"]) == KINDS[index_type][0] and sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert np.array_equal(b["genome_lens"], [60000])


@pytest.mark.parametrize("index_type", [1, 2, 3])
def test_each_package_loads_the_others_file(saved, index_type):
    """--load-index of the other package's file: the SAM of the run that
    built its index. The port also loads it on a device run (-i 1 seeds
    from the loaded tables)."""
    it = str(index_type)
    built = os.path.join(saved, f"p_save{it}")
    jfile = os.path.join("..", f"j_save{it}", f"idx{it}")
    pfile = os.path.join("..", f"p_save{it}", f"idx{it}.npz")
    args = ["../r.fa", "../g.fa", "-t", "4", "-i", it, "-o", "out"]
    p = NR.run_cli("linear_tpu_torch", os.path.join(saved, f"p_load{it}"),
                   [*args, "--load-index", jfile])
    assert f"--Index loaded  {jfile}" in p.stderr
    NR.run_cli("linear_tpu", os.path.join(saved, f"j_load{it}"),
               [*args, "--load-index", pfile])
    p = NR.run_cli("linear_tpu_torch", os.path.join(saved, f"p_loadcpu{it}"),
                   [*args, "--load-index", jfile, "--device", "cpu"])
    assert ("--Device seeding (cpu)" in p.stderr) == (index_type == 1)
    for run in (f"p_load{it}", f"j_load{it}", f"p_loadcpu{it}"):
        NR.same_files(os.path.join(saved, run), built, ["out.sam"])


@pytest.mark.parametrize("index_type", [1, 2, 3])
def test_round_trip_in_process(saved, tmp_path, index_type):
    """save_index / load_index of both packages on both packages' index
    objects: the port's class comes back, tables exactly equal."""
    g = os.path.join(saved, "g.fa")
    jm = JMapper([g], JConfig(threads=4, index_type=index_type))
    m = Mapper([g], MapperConfig(threads=4, index_type=index_type),
               device="host")
    jm.create_index()
    m.create_index()
    SER.save_index(str(tmp_path / "port"), m.index, m.genome_lens)
    JSER.save_index(str(tmp_path / "jax"), jm.index, jm.genome_lens)
    SER.save_index(str(tmp_path / "carried"), port_index(jm.index),
                   m.genome_lens)
    got = [SER.load_index(str(tmp_path / n), index_type, m.genome_lens)
           for n in ("port", "jax", "carried")]
    want = JSER.load_index(str(tmp_path / "port.npz"), index_type,
                           jm.genome_lens)
    fields = ("ysa", "xs_val1", "xs_val2") if index_type == 2 else ("dir", "hs")
    for idx in got:
        assert type(idx) is KINDS[index_type][1]
        for f in fields:
            x, y = getattr(idx, f), getattr(want, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
            assert np.array_equal(x, getattr(m.index, f)), f
    block = next(seqio.read_blocks(os.path.join(saved, "r.fa")))
    m.create_features()
    sam = m.map_block(block)[2]
    m2 = Mapper([g], MapperConfig(threads=4, index_type=index_type),
                device="host")
    m2.index = got[1]
    m2.prepare()
    assert sam.count("\n") >= 8 and m2.map_block(block)[2] == sam


@pytest.mark.parametrize("args,code", [
    (("-i", "2", "--load-index", "../p_save1/idx1"), "E[12]"),
    (("-i", "1", "--load-index", "../p_save3/idx3.npz"), "E[12]"),
    (("-i", "1", "--load-index", "../p_save1/idx1", "OTHER"), "E[13]")])
def test_wrong_file_exits_1_with_jaxs_message(saved, args, code):
    """Another index kind (E[12]) or genomes of other lengths (E[13]): exit
    1, no SAM, and the message linear_tpu prints."""
    genome = "../other/g.fa" if "OTHER" in args else "../g.fa"
    args = ["../r.fa", genome, "-t", "4", "-o", "out",
            *(a for a in args if a != "OTHER")]
    tag = code[2:4] + args[args.index("-i") + 1]
    pj = NR.run_cli("linear_tpu", os.path.join(saved, f"j_bad{tag}"), args,
                    rc=1)
    pp = NR.run_cli("linear_tpu_torch", os.path.join(saved, f"p_bad{tag}"),
                    args, rc=1)
    msg = [ln for ln in pp.stderr.splitlines() if ln.startswith("E[")]
    assert len(msg) == 1 and msg[0].startswith(code)
    assert msg == [ln for ln in pj.stderr.splitlines() if ln.startswith("E[")]
    assert "Traceback" not in pp.stderr
    assert not os.path.exists(os.path.join(saved, f"p_bad{tag}", "out.sam"))
