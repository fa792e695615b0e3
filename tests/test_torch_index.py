"""linear_tpu_torch's host modules against linear_tpu's: the native DIndex
and features, the synthetic corpus, sequence I/O, the cord bit helpers and
the APF / SAM-header writers. Inputs come from numpy seeds; every
comparison is exact equality."""
import gzip
import os

import numpy as np
import pytest

import test_torch_native_ready  # noqa: F401  (the JAX package's libraries)
from linear_tpu.index import dindex as JDI
from linear_tpu.ops import features as JF
from linear_tpu.out import apf as JAPF
from linear_tpu.out import bamlink as JBL
from linear_tpu.utils import cordscalar as JCS
from linear_tpu.utils import seqio as JSQ
from linear_tpu.utils import simdata as JSIM
from linear_tpu_torch.index import dindex as DI
from linear_tpu_torch.map import nengine as NE
from linear_tpu_torch.out import apf as APF
from linear_tpu_torch.out import bamlink as BL
from linear_tpu_torch.utils import cordscalar as CS
from linear_tpu_torch.utils import seqio as SQ
from linear_tpu_torch.utils import simdata as SIM


def _genome(kind: str) -> np.ndarray:
    rng = np.random.default_rng(31)
    if kind == "genomic":
        return SIM.make_genomic_genome(rng, 150_000)
    g = rng.integers(0, 4, 40_000).astype(np.uint8)
    if kind == "with_n":
        g[10_000:10_500] = 4
        g[31_000] = 4
    return g


@pytest.mark.parametrize("threads", [1, 4, 16])
@pytest.mark.parametrize("kind", ["random", "with_n", "genomic"])
def test_native_dindex_matches_jax(kind, threads):
    g = _genome(kind)
    port = DI.build_dindex([g, g[:20_000].copy()], threads)
    ref = JDI.build_dindex([g, g[:20_000].copy()], threads_emul=threads)
    assert (port.span, port.weight) == (ref.span, ref.weight)
    assert np.array_equal(port.dir, ref.dir)
    assert np.array_equal(port.hs, ref.hs)
    assert np.array_equal(port.ensure_nz(), ref.ensure_nz())


@pytest.mark.parametrize("threads", [1, 4])
def test_native_features_match_jax(threads):
    g = _genome("with_n")[:30_000]
    assert np.array_equal(NE.build_features_native(g, threads),
                          JF.create_features_genome(g, threads))


@pytest.mark.parametrize("seed,length", [(42, 200_000), (7, 130_000)])
def test_simdata_same_genome(seed, length):
    a = SIM.make_genomic_genome(np.random.default_rng(seed), length)
    b = JSIM.make_genomic_genome(np.random.default_rng(seed), length)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_simulate_reads_shape():
    rng = np.random.default_rng(42)
    g = SIM.make_genomic_genome(rng, 200_000)
    reads = SIM.simulate_reads(rng, g, 60, 3000)
    lens = np.array([len(r) for r in reads])
    assert len(reads) == 60 and all(r.dtype == np.uint8 for r in reads)
    assert 2700 < lens.mean() < 3300 and int(max(r.max() for r in reads)) <= 4
    again = SIM.simulate_reads(np.random.default_rng(5), g, 6, 3000)
    assert [r.tolist() for r in again] == [
        r.tolist() for r in SIM.simulate_reads(np.random.default_rng(5), g,
                                               6, 3000)]


@pytest.fixture(scope="module")
def seqfiles(tmp_path_factory):
    d = tmp_path_factory.mktemp("seqs")
    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 5, int(n)).astype(np.uint8)
            for n in rng.integers(0, 400, 9)]
    ids = [f"r{i} desc {i}" for i in range(len(seqs))]
    fa = str(d / "r.fa")
    SQ.write_fasta(fa, ids, seqs, width=60)
    fq = str(d / "r.fq")
    with open(fq, "w") as fh:
        for rid, s in zip(ids, seqs):
            fh.write(f"@{rid}\n{SQ.decode(s).lower()}\n+\n{'I' * len(s)}\n")
    gz = str(d / "r.fa.gz")
    with open(fa, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    return {"fasta": fa, "fastq": fq, "gzip": gz}, ids, seqs


@pytest.mark.parametrize("fmt", ["fasta", "fastq", "gzip"])
def test_seqio_matches_jax(seqfiles, fmt):
    paths, ids, seqs = seqfiles
    path = paths[fmt]
    port = list(SQ.read_blocks(path, block_size=4))
    ref = list(JSQ.read_blocks(path, block_size=4))
    assert [b.ids for b in port] == [b.ids for b in ref]
    assert [[s.tolist() for s in b.seqs] for b in port] == [
        [s.tolist() for s in b.seqs] for b in ref]
    assert [i for b in port for i in b.ids] == ids
    g = SQ.load_genomes([path])
    assert [s.tolist() for s in g.seqs] == [s.tolist() for s in seqs]
    offs = SQ.scan_record_offsets(path)
    ref_offs = JSQ.scan_record_offsets(path)
    if fmt == "gzip":
        assert offs is None and ref_offs is None
        return
    assert offs.tolist() == ref_offs.tolist()
    for a, b in [(0, 3), (3, 9), (2, 5)]:
        pids, pseqs = SQ.parse_records_range(path, int(offs[a]), int(offs[b]))
        rids, rseqs = JSQ.parse_records_range(path, int(offs[a]), int(offs[b]))
        assert pids == rids == ids[a:b]
        assert [s.tolist() for s in pseqs] == [s.tolist() for s in rseqs]


def test_seqio_codes_match_jax():
    txt = "ACGTacgtNnRYx-"
    assert SQ.encode(txt).tolist() == JSQ.encode(txt).tolist()
    codes = np.random.default_rng(2).integers(0, 5, 100).astype(np.uint8)
    assert SQ.revcomp(codes).tolist() == JSQ.revcomp(codes).tolist()
    assert SQ.decode(codes) == JSQ.decode(codes)


def test_seqio_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        SQ.load_genomes([str(tmp_path / "nope.fa")])
    bad = tmp_path / "bad.fa"
    bad.write_text("not a sequence file\n")
    with pytest.raises(ValueError):
        list(SQ.read_seq_records(str(bad)))


def test_cordscalar_matches_jax():
    rng = np.random.default_rng(8)
    vals = [int(v) for v in rng.integers(0, 1 << 63, 200, dtype=np.int64)]
    vals += [v | (1 << 63) for v in vals[:50]] + [0, (1 << 64) - 1]
    for name in ("cy", "cx", "cid", "strand", "is_end"):
        f, g = getattr(CS, name), getattr(JCS, name)
        assert [f(v) for v in vals] == [g(v) for v in vals], name
    for name in ("MASK_Y", "MASK_X30", "MASK_ID", "FLAG_END", "FLAG_STRAND"):
        assert getattr(CS, name) == getattr(JCS, name), name


def test_apf_and_sam_header_match_jax():
    rng = np.random.default_rng(12)
    cords_set = []
    for k in range(6):
        n = int(rng.integers(0, 8))
        cs = [0] + [JCS.make_cord(int(rng.integers(0, 2)), int(rng.integers(0, 1 << 20)),
                                 int(rng.integers(0, 1 << 15)), int(rng.integers(0, 2)))
                    for _ in range(n)]
        for j in range(1, len(cs)):
            if rng.random() < 0.3:
                cs[j] = JCS.set_end(cs[j])
        cords_set.append(cs if n else [])
    args = (cords_set, [1 << 21, 5000], ["chrA", "chrB"],
            [int(rng.integers(300, 9000)) for _ in range(6)],
            [f"read{k} x" for k in range(6)])
    assert APF.print_cords_apf(*args) == JAPF.print_cords_apf(*args)
    hdr = (["chr1", "chr2"], [100, 2000], "rg1", "s1", "")
    assert BL.sam_header(*hdr) == JBL.sam_header(*hdr)
    assert BL.INF60 == JBL.INF60


def test_native_build_is_in_the_port_build_dir():
    from linear_tpu_torch import native

    so = native.build("lt_engine")
    assert os.path.dirname(so) == native.BUILD_DIR
    port = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert native.SRC_DIR == os.path.join(port, "native", "src")
    assert os.path.isfile(os.path.join(native.SRC_DIR, "lt_engine.cpp"))


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _without_timers(text: str) -> str:
    """The JAX package's C++ source with the gap module's wall timers taken
    out, as the port keeps it: CtNsScope, GapNsScope, g_ct_ns, g_gap_ns,
    le_ct_stage_ns and le_gap_stage_ns, which nothing read. A block that
    only scoped a timer loses its braces, and a wrapper that only timed its
    callee gives the callee its name."""
    import re

    text = re.sub(r"// gap-module wall accumulators.*?\n"
                  r"(?:extern i64 g_(?:gap|ct)_ns\[4\];.*\n)+"
                  r"struct CtNsScope \{.*?\n\};\n"
                  r"struct GapNsScope \{.*?\n\};\n\n", "", text, flags=re.S)
    text = re.sub(r"(?ms)^( *)\{\n *(?:Ct|Gap)NsScope _\w+\(\d\);\n(.*?)^\1\}\n",
                  lambda m: re.sub(r"(?m)^    ", "", m.group(2)), text)
    text = re.sub(r"(?m)^static inline int (\w+)\([^{]*\) \{\n"
                  r"    GapNsScope _t\(\d\);\n"
                  r"    return \1_timed\([^;]*\);\n\}\n\n", "", text)
    text = re.sub(r"\b(map_\w+)_timed\b", r"\1", text)
    text = re.sub(r"(?m)^ *GapNsScope _t\(\d\);\n", "", text)
    text = text.replace(" i64 g_gap_ns[4] = {0, 0, 0, 0};"
                        " i64 g_ct_ns[4] = {0, 0, 0, 0};", "")
    return re.sub(r"(?m)^void le_(?:ct|gap)_stage_ns\(i64\* out4\) \{\n"
                  r".*\n\}\n\n", "", text)


def test_native_sources_are_byte_identical_copies():
    """The port's C++ sources (linear_tpu_torch/native/src) are the JAX
    package's, byte for byte, but for the unread gap-module timers
    (_without_timers): every .cpp and .hpp of linear_tpu/native, and
    nothing else."""
    from linear_tpu_torch import native

    jax_dir = os.path.join(_REPO, "linear_tpu", "native")
    want = sorted(f for f in os.listdir(jax_dir)
                  if f.endswith((".cpp", ".hpp")))
    assert sorted(os.listdir(native.SRC_DIR)) == want
    assert {"lt_engine.cpp", "lt_seqio.cpp", "lt_sort.cpp"} <= set(want)
    changed = []
    for f in want:
        with open(os.path.join(jax_dir, f)) as a, \
                open(os.path.join(native.SRC_DIR, f)) as b:
            jax_src, port_src = a.read(), b.read()
        assert _without_timers(jax_src) == port_src, f
        changed += [f] * (jax_src != port_src)
    assert changed == ["le_gap.hpp", "le_gap2.hpp", "le_gap3.hpp",
                       "le_hash.hpp", "lt_engine.cpp"]
    for f in want:
        with open(os.path.join(native.SRC_DIR, f)) as b:
            assert not any(k in b.read() for k in (
                "NsScope", "g_ct_ns", "g_gap_ns", "_timed")), f


def _path_into_jax_package(node) -> bool:
    """A string constant that names a path under linear_tpu/ (not a
    "linear_tpu/...py:line" label), or "linear_tpu" as one part of a path
    join."""
    import re

    v = node.value
    if not isinstance(v, str) or any(c.isspace() for c in v):
        return False
    parts = re.split(r"[/\\]", v)
    return ("linear_tpu" in parts
            and not re.fullmatch(r"linear_tpu/[\w/]+\.\w+:\d+[-,:\w]*", v))


def test_port_joins_no_path_into_the_jax_package():
    """No .py file of linear_tpu_torch/ and no line of chip_smoke.py joins
    a path into linear_tpu/: no string that is such a path, and no
    os.path.join / Path argument that is the directory's name. (Docstrings
    and comments may name the JAX functions a kernel replaces.)"""
    import ast
    import glob

    files = glob.glob(os.path.join(_REPO, "linear_tpu_torch", "**", "*.py"),
                      recursive=True)
    files.append(os.path.join(_REPO, "chip_smoke.py"))
    bad = []
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for n in ast.walk(tree):
            if (isinstance(n, ast.Constant) and id(n) not in docs
                    and _path_into_jax_package(n)):
                bad.append(f"{os.path.relpath(f, _REPO)}:{n.lineno} "
                           f"{n.value!r}")
    assert not bad, bad
    assert _path_into_jax_package(ast.Constant("linear_tpu"))
    assert _path_into_jax_package(ast.Constant("linear_tpu/native"))
    assert not _path_into_jax_package(
        ast.Constant("linear_tpu/ops/seeding.py:420"))


def test_native_build_from_the_port_alone(tmp_path):
    """A tree that holds linear_tpu_torch/ and no linear_tpu/ builds and
    loads the port's native libraries from its own sources."""
    import json
    import shutil
    import subprocess
    import sys

    shutil.copytree(os.path.join(_REPO, "linear_tpu_torch"),
                    tmp_path / "linear_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = ("from linear_tpu_torch import native\n"
            "from linear_tpu_torch.utils import cxxsort\n"
            "import numpy as np\n"
            "so = native.build('lt_sort')\n"
            "native.load('lt_seqio')\n"
            "k = np.array([3, 1, 2, 1])\n"
            "print(so, cxxsort.std_sort_perm(k).tolist())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    so, order = res.stdout.split(" ", 1)
    assert so.startswith(str(tmp_path / "linear_tpu_torch" / "_build"))
    assert sorted(json.loads(order)[:2]) == [1, 3]
    assert not (tmp_path / "linear_tpu").exists()
