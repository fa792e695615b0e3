"""The slice end to end: `python -m linear_tpu_torch filter` against
`python -m linear_tpu filter`, as subprocesses, on a 60 kb genome with an
N-gap and 30 reads (an N read, reads at or below the 200-base cut, an
8 kb+ read), in the pipeline (-b 1) and in the serial loop (-b 0, where
the device also extends), and on the same genome without N (the device
builds the index). SAM and APF must be byte-identical (tolerance 0). Also:
no flag of linear_tpu's CLI is refused (-i 2/3, -f 0/1, -ot 4/8, -a 1, the
index files: each runs and matches linear_tpu), --device cuda without a
card exits 1, and importing the port loads neither jax nor linear_tpu."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import test_torch_native_ready  # noqa: F401  (the JAX package's libraries)
from linear_tpu_torch.utils import seqio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", LINEAR_TPU_DASH="0",
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _filter(pkg, d, device, extra=(), out=None):
    cmd = [sys.executable, "-m", pkg, "filter", "r.fa", "g.fa", "-t", "4",
           "--device", device, *extra]
    if out:
        cmd += ["-o", out, "-ot", "3"]
    return subprocess.run(cmd, cwd=d, env=_env(), capture_output=True,
                          text=True, timeout=600)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 60000).astype(np.uint8)
    genome[30000:30300] = 4
    seqio.write_fasta(str(d / "g.fa"), ["chr1 test"], [genome])
    reads = []
    for i in range(30):
        ln = [150, 201, 8500][i] if i < 3 else int(rng.integers(1000, 5000))
        pos = int(rng.integers(0, 60000 - ln))
        r = genome[pos: pos + ln].copy()
        sub = rng.random(ln) < 0.05
        r[sub] = (r[sub] + 1) % 4
        if i % 3 == 2:
            r = seqio.revcomp(r)
        if i == 5:
            r[100:103] = 4
        reads.append(r)
    ids = [f"read{i} t" for i in range(30)]
    seqio.write_fasta(str(d / "r.fa"), ids, reads)
    seqio.write_fasta(str(d / "r3.fa"), ids[3:6], reads[3:6])
    return str(d)


@pytest.fixture(scope="module")
def outputs(corpus):
    runs = {"port_cpu": ("linear_tpu_torch", "cpu"),
            "port_host": ("linear_tpu_torch", "host"),
            "jax_tpu": ("linear_tpu", "tpu"),
            "jax_host": ("linear_tpu", "host")}
    res = {}
    for name, (pkg, device) in runs.items():
        p = _filter(pkg, corpus, device, out=name)
        assert p.returncode == 0, p.stderr[-3000:]
        res[name] = {"stderr": p.stderr}
        for ext in ("sam", "apf"):
            with open(os.path.join(corpus, f"{name}.{ext}"), "rb") as fh:
                res[name][ext] = fh.read()
    return res


@pytest.mark.parametrize("ext", ["sam", "apf"])
@pytest.mark.parametrize("other", ["jax_tpu", "jax_host", "port_host"])
def test_port_cpu_output_is_identical(outputs, other, ext):
    assert outputs["port_cpu"][ext], "empty output"
    assert outputs["port_cpu"][ext] == outputs[other][ext]


def test_port_cpu_reports_seeding(outputs):
    err = outputs["port_cpu"]["stderr"]
    line = [ln for ln in err.splitlines() if "--Device seeding (cpu)" in ln]
    assert line, err[-2000:]
    seeded = int(line[0].split("seeded reads ")[1].split()[0])
    assert 0 < seeded <= 28  # 30 reads, 1 at or below 200 bases, 1 with N
    # no task ships before its seeds land: every seeded read uses them
    assert f"mapped with device seeds {seeded}," in line[0]
    assert "seed kernel launches 0" in line[0]  # the CPU runs no kernel
    assert "--Device seeding" not in outputs["port_host"]["stderr"]


@pytest.mark.parametrize("extra", [
    ["-i", "2"], ["-i", "3"], ["-f", "0"], ["-f", "1"], ["-a", "1", "-ot", "4"],
    ["-ot", "4"], ["-ot", "10"], ["--save-index", "x.npz"],
    ["--load-index", "x.npz"], ["-b", "0", "--device", "cpu", "-i", "2"],
])
def test_unported_flags_exit_1(corpus, extra):
    """No flag of linear_tpu's CLI is unported: each of these, which a
    partial port would refuse with exit 1, runs in the port and writes
    linear_tpu's files byte for byte (SAM, or the BAMs that -ot names; the
    index file that --load-index reads is the one linear_tpu saved)."""
    tag = "".join(c for c in "".join(extra) if c.isalnum())
    out = f"flags_{tag}"
    if "--load-index" in extra:
        assert os.path.exists(os.path.join(corpus, "x.npz")) or _filter(
            "linear_tpu", corpus, "host",
            extra=["--save-index", "x.npz", "-o", "flags_x"]).returncode == 0
    ot = extra[extra.index("-ot") + 1] if "-ot" in extra else "2"
    names = [ext for bit, ext in ((2, ".sam"), (4, ".bam"), (8, "_pbsv.bam"))
             if int(ot) & bit]
    files = {}
    for pkg, device in (("linear_tpu_torch", "host"), ("linear_tpu", "host")):
        # -a 1 aligns every read base by base: the three reads of r3.fa
        cmd = [sys.executable, "-m", pkg, "filter",
               "r3.fa" if "-a" in extra else "r.fa", "g.fa", "-t", "4", "-o",
               f"{out}_{pkg}", *extra]
        if "--device" not in extra:
            cmd += ["--device", device]
        elif pkg == "linear_tpu":
            cmd[cmd.index("cpu")] = "tpu"
        if "--save-index" in extra:
            cmd[cmd.index("x.npz")] = f"{out}_{pkg}.npz"
        p = subprocess.run(cmd, cwd=corpus, env=_env(), capture_output=True,
                           text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        assert "E[port]" not in p.stderr
        files[pkg] = []
        for ext in names:
            with open(os.path.join(corpus, f"{out}_{pkg}{ext}"), "rb") as fh:
                files[pkg].append(fh.read())
    assert all(len(f) > 100 for f in files["linear_tpu_torch"])
    assert files["linear_tpu_torch"] == files["linear_tpu"]
    if "--save-index" in extra:
        a, b = (dict(np.load(os.path.join(corpus, f"{out}_{pkg}.npz")))
                for pkg in files)
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_serial_block_loop_matches(corpus, outputs):
    """-b 0 (host seeding, serial loop) runs in the port too; with -t 1 it
    equals the JAX package's -b 0 byte for byte."""
    for pkg, name in (("linear_tpu_torch", "p_b0"), ("linear_tpu", "j_b0")):
        p = subprocess.run(
            [sys.executable, "-m", pkg, "filter", "r.fa", "g.fa", "-t", "1",
             "-b", "0", "-o", name, "-ot", "3", "--device", "host"],
            cwd=corpus, env=_env(),
            capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
    for ext in ("sam", "apf"):
        with open(os.path.join(corpus, f"p_b0.{ext}"), "rb") as a, \
                open(os.path.join(corpus, f"j_b0.{ext}"), "rb") as b:
            assert a.read() == b.read()


def test_cuda_without_a_card_exits_nonzero(corpus):
    """Both block loops: the pipeline (-b 1) and the serial loop (-b 0),
    which has no pipeline to close."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    for extra, out in (((), "nocard"), (("-b", "0"), "nocard_b0")):
        p = _filter("linear_tpu_torch", corpus, "cuda", extra=extra, out=out)
        assert p.returncode == 1, p.stderr[-2000:]
        assert "E[dev]" in p.stderr and "no CUDA device" in p.stderr
        assert "Traceback" not in p.stderr
        assert not os.path.exists(os.path.join(corpus, f"{out}.sam"))


def test_default_device_is_cuda(corpus):
    """Without --device the port runs on the card; without a card it exits
    non-zero naming the missing CUDA device, and writes no SAM."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    p = subprocess.run(
        [sys.executable, "-m", "linear_tpu_torch", "filter", "r.fa", "g.fa",
         "-t", "4", "-o", "nodevice"], cwd=corpus, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0, p.stderr[-2000:]
    assert "no CUDA device" in p.stderr and "--device cuda" in p.stderr
    assert not os.path.exists(os.path.join(corpus, "nodevice.sam"))


@pytest.fixture(scope="module")
def serial_outputs(corpus):
    """-b 0 runs: the port on device cpu (seeding and extension in the
    plain PyTorch versions) and host, and the JAX package's device path
    (--device tpu on JAX-CPU) and host loop."""
    runs = {"port_cpu": ("linear_tpu_torch", "cpu"),
            "port_host": ("linear_tpu_torch", "host"),
            "jax_tpu": ("linear_tpu", "tpu"),
            "jax_host": ("linear_tpu", "host")}
    res = {}
    for name, (pkg, device) in runs.items():
        p = _filter(pkg, corpus, device, extra=("-b", "0"), out=f"b0_{name}")
        assert p.returncode == 0, p.stderr[-3000:]
        res[name] = {"stderr": p.stderr}
        for ext in ("sam", "apf"):
            with open(os.path.join(corpus, f"b0_{name}.{ext}"), "rb") as fh:
                res[name][ext] = fh.read()
    return res


@pytest.mark.parametrize("ext", ["sam", "apf"])
@pytest.mark.parametrize("other", ["jax_tpu", "jax_host", "port_host"])
def test_serial_device_output_is_identical(serial_outputs, other, ext):
    assert serial_outputs["port_cpu"][ext], "empty output"
    assert serial_outputs["port_cpu"][ext] == serial_outputs[other][ext]


def _extension_counts(stderr):
    line = [ln for ln in stderr.splitlines()
            if ln.startswith("--Device extension")]
    assert len(line) == 1, stderr[-2000:]
    m = re.search(r"extended on the device (\d+) of (\d+) eligible, kernel "
                  r"launches (\d+); host re-map: (\d+) with N, (\d+) over 256 "
                  r"hits, (\d+) overflowing C, (\d+) re-apx", line[0])
    assert m, line[0]
    return [int(v) for v in m.groups()]


def test_serial_extension_accounts_for_every_read(serial_outputs):
    """Every eligible read (above 200 bases) is extended on the device or
    counted under exactly one host re-map reason; the CPU runs no kernel."""
    ext, elig, launches, n_n, n_hits, n_ovf, n_reapx = _extension_counts(
        serial_outputs["port_cpu"]["stderr"])
    assert elig == 29  # 30 reads, 1 at or below 200 bases
    assert ext > 20 and n_n == 1 and launches == 0
    assert ext + n_n + n_hits + n_ovf + n_reapx == elig
    err = serial_outputs["port_cpu"]["stderr"]
    assert "--Device index (cpu): uploaded (genome has N)" in err
    seed = [ln for ln in err.splitlines() if "--Device seeding (cpu)" in ln][0]
    seeded = int(seed.split("seeded reads ")[1].split()[0])
    assert seeded == 28 and f"mapped with device seeds {seeded}," in seed
    assert "--Device extension" not in serial_outputs["port_host"]["stderr"]


@pytest.mark.parametrize("ext_h,bases", [(8, 1 << 23), (256, 1 << 15)])
def test_serial_extension_counters_add_up(corpus, ext_h, bases):
    """Mapper.map_block on device cpu with a low hits cap (reads over it
    are mapped on the host) or batches of a few reads: the counters add
    up to the eligible reads, and the SAM stays the host loop's."""
    from linear_tpu_torch.map.mapper import Mapper, MapperConfig

    sams = {}
    for device in ("cpu", "host"):
        m = Mapper([os.path.join(corpus, "g.fa")],
                   MapperConfig(threads=4, bal_flag=0), device=device)
        m.prepare()
        m.EXT_H, m.EXT_BASES = ext_h, bases
        sams[device] = "".join(
            m.map_block(b)[2]
            for b in seqio.read_blocks(os.path.join(corpus, "r.fa")))
        ec = m.ext_counters
        if device == "cpu":
            assert ec.eligible == 29 and ec.host_n == 1
            assert ec.eligible == (ec.extended + ec.host_n + ec.host_hits
                                   + ec.host_overflow + ec.host_reapx)
            assert (ec.host_hits > 0) == (ext_h == 8)
            assert ec.extended > 0
    assert sams["cpu"] and sams["cpu"] == sams["host"]


@pytest.fixture(scope="module")
def nfree(corpus):
    """The corpus genome with its N-gap filled: the device builds the
    DIndex itself."""
    d = os.path.join(corpus, "nfree")
    os.makedirs(d, exist_ok=True)
    g = seqio.load_genomes([os.path.join(corpus, "g.fa")]).seqs[0].copy()
    n = g == 4
    g[n] = np.random.default_rng(43).integers(0, 4, int(n.sum()))
    seqio.write_fasta(os.path.join(d, "g.fa"), ["chr1 test"], [g])
    os.symlink(os.path.join(corpus, "r.fa"), os.path.join(d, "r.fa"))
    return d


@pytest.mark.parametrize("bal", ["1", "0"])
def test_nfree_genome_builds_the_index_on_the_device(nfree, bal):
    outs = {}
    for device in ("cpu", "host"):
        p = _filter("linear_tpu_torch", nfree, device, extra=("-b", bal),
                    out=f"nf{bal}_{device}")
        assert p.returncode == 0, p.stderr[-3000:]
        with open(os.path.join(nfree, f"nf{bal}_{device}.sam"), "rb") as fh:
            outs[device] = (fh.read(), p.stderr)
    assert "--Device index (cpu): built on the card in" in outs["cpu"][1]
    assert outs["cpu"][0] and outs["cpu"][0] == outs["host"][0]


def test_seeding_error_fails_the_run(corpus):
    """An exception in the device seeding thread reaches the caller of
    PipelineMapper.run; the run does not carry on without the device."""
    from linear_tpu_torch.map.mapper import Mapper, MapperConfig
    from linear_tpu_torch.parallel.pipeline import PipelineMapper

    m = Mapper([os.path.join(corpus, "g.fa")], MapperConfig(threads=2),
               device="cpu")

    def broken(reads):
        raise RuntimeError("device lost")
        yield  # noqa: unreachable; makes this a generator like the real one

    m._device_seed_stream2 = broken
    with PipelineMapper(m, n_workers=2) as pipe:
        with pytest.raises(RuntimeError, match="device lost"):
            for _ in pipe.run(os.path.join(corpus, "r.fa")):
                pass


@pytest.mark.parametrize("collect_cords", [False, True])
def test_pipeline_ships_every_task_seeded(corpus, collect_cords):
    """With small superchunks and m_out tiers (several chunks, both tiers),
    the pipeline on device cpu hands no task to the pool before its seeds
    land, accounts for every eligible read, and writes the SAM of the host
    pipeline. collect_cords False reads the chunks from byte ranges, True
    from the parsed block."""
    from linear_tpu_torch.map.mapper import Mapper, MapperConfig
    from linear_tpu_torch.parallel.pipeline import PipelineMapper

    sams = {}
    for device in ("cpu", "host"):
        m = Mapper([os.path.join(corpus, "g.fa")], MapperConfig(threads=4),
                   device=device)
        m.SEED_SUPERCHUNK, m.SEED_SUPERCHUNK2 = 8, 2
        m.SEED_M_OUT, m.SEED_M_OUT2 = 16, 64
        with PipelineMapper(m, n_workers=2, csize_workers=4) as pipe:
            sams[device] = "".join(
                br.sam for br in pipe.run(os.path.join(corpus, "r.fa"),
                                          collect_cords=collect_cords))
            c = pipe.counters
        if device == "cpu":
            assert c.fetched == 30
            assert 0 < c.seeded == c.shipped_seeded
            assert set(c.superchunks) == {16, 64}
            # 29 reads above 200 bases; 1 of them has N
            assert sum(c.tier_reads.values()) == 29
            assert c.seeded + c.host_n + c.host_overflow == 29
            assert c.host_n == 1
    assert sams["cpu"] and sams["cpu"] == sams["host"]


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import linear_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, 'linear_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'linear_tpu'))\n"
        "need = ['linear_tpu_torch.parallel.' + m for m in\n"
        "        ('mesh', 'dist', 'e2e', 'pipeline')]\n"
        "need += ['linear_tpu_torch.ops.' + m for m in\n"
        "         ('gap_dev', 'align_pallas', 'chain_dp')]\n"
        "need += ['linear_tpu_torch.' + m for m in\n"
        "         ('out.bam', 'index.hindex', 'index.sindex',\n"
        "          'index.serial')]\n"
        "need += ['linear_tpu_torch.tools.' + m for m in\n"
        "         ('common', 'profile_stages', 'profile_residual',\n"
        "          'bench_devbuild', 'bench_scale', 'diffstage')]\n"
        "bad += [m + ' not imported' for m in need if m not in sys.modules]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "torch" in subprocess.run(
        [sys.executable, "-c", "import sys, linear_tpu_torch.ops.seeding;"
         "print(' '.join(sys.modules))"], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300).stdout.split()
