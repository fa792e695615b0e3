"""The JAX package's native libraries, built once for all test processes.

linear_tpu.native builds each library on first use into one fixed
temporary name (`<name>.so.tmp`) under a lock that holds within a process
only, returns None when the build or its rename fails, and caches that
None (as do linear_tpu.map.nengine and linear_tpu.utils.cxxsort). Test
processes that start together on a tree without the libraries (pytest-xdist
workers, the CLI subprocesses of the parity tests) then build over one
another, and the losers go on without a native engine. The port's test
files that reach those libraries import this module first: ensure_native()
takes a file lock that holds across processes, loads the three libraries,
and where a load gave None clears the cached misses and loads again. So one
process builds, the others wait and find each library up to date, and a
later `python -m linear_tpu` subprocess finds them built.

Also here, for the parity tests of the CLI: small_corpus (a genome and
reads from a numpy seed) and run_cli / same_files (both packages' `filter`
as subprocesses in directories of their own, their output files compared
byte for byte).
"""
import fcntl
import os
import subprocess
import sys

import numpy as np
import pytest

import linear_tpu.native as JN
from linear_tpu.map import nengine as JNE
from linear_tpu.utils import cxxsort as JCX

NAMES = ("lt_engine", "lt_seqio", "lt_sort")
_LOCK_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "linear_tpu_torch", "_build")
TRIES = 3


def _forget_misses() -> None:
    """Drop every cached None, so that the next load builds or opens the
    library again."""
    for name in [n for n, lib in JN._LIBS.items() if lib is None]:
        del JN._LIBS[name]
    for mod in (JNE, JCX):
        if mod._LIB is None:
            mod._LIB_TRIED = False


def ensure_native() -> dict:
    """{name: CDLL} of the three libraries; raises if one cannot be built."""
    os.makedirs(_LOCK_DIR, exist_ok=True)
    libs = {}
    with open(os.path.join(_LOCK_DIR, "linear_tpu_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for name in NAMES:
            for _ in range(TRIES):
                _forget_misses()
                libs[name] = JN.load(name)
                if libs[name] is not None:
                    break
            else:
                raise RuntimeError(f"linear_tpu.native.load({name!r}) gave "
                                   f"None {TRIES} times: the library does "
                                   "not build here")
    return libs


LIBS = ensure_native()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_corpus(d, seed: int = 7, n_reads: int = 16, genome_len: int = 60000,
                 name: str = "r.fa", genome=None):
    """Write d/<name>: reads of 1-4 kb at 5 % substitutions (one at the
    200-base cut, one 6 kb, one with N, a chimera, a deletion, every third
    reverse-complemented) from `genome`, or without one from a new genome
    with an N-gap, written to d/g.fa. Returns (genome, reads, ids)."""
    from linear_tpu_torch.utils import seqio

    rng = np.random.default_rng(seed)
    if genome is None:
        genome = rng.integers(0, 4, genome_len).astype(np.uint8)
        genome[genome_len // 2: genome_len // 2 + 300] = 4
        seqio.write_fasta(os.path.join(d, "g.fa"), ["chr1 test"], [genome])
    genome_len = len(genome)
    reads = []
    for i in range(n_reads):
        ln = [201, 6000][i] if i < 2 else int(rng.integers(1000, 4000))
        pos = int(rng.integers(0, genome_len - ln))
        r = genome[pos: pos + ln].copy()
        sub = rng.random(ln) < 0.05
        r[sub] = (r[sub] + 1) % 4
        if i == 7:  # a chimera of two distant segments
            p2 = int(rng.integers(0, genome_len - 2000))
            r = np.concatenate([r, genome[p2: p2 + 1500]])
        if i == 9:  # a deletion (drives the gap module)
            r = np.concatenate([r[: ln // 2], r[ln // 2 + 300:]])
        if i % 3 == 2:
            r = seqio.revcomp(r)
        if i == 5:
            r[100:103] = 4
        reads.append(r)
    ids = [f"read{i} s{seed}" for i in range(n_reads)]
    seqio.write_fasta(os.path.join(d, name), ids, reads)
    return genome, reads, ids


def cli_env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu", LINEAR_TPU_DASH="0",
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                **extra)


def run_cli(pkg: str, cwd, args, env=None, rc: int = 0):
    """`python -m <pkg> filter <args>` in cwd (made if missing); the port
    gets --device host unless args name a device. Asserts the exit code;
    returns the CompletedProcess."""
    os.makedirs(cwd, exist_ok=True)
    args = [str(a) for a in args]
    if pkg == "linear_tpu_torch" and "--device" not in args:
        args += ["--device", "host"]
    p = subprocess.run([sys.executable, "-m", pkg, "filter", *args], cwd=cwd,
                       env=env or cli_env(), capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == rc, (pkg, args, p.stderr[-3000:])
    return p


def same_files(dir_a, dir_b, names) -> None:
    """Each named file exists in both directories, is not empty, and holds
    the same bytes."""
    for name in names:
        with open(os.path.join(dir_a, name), "rb") as fa, \
                open(os.path.join(dir_b, name), "rb") as fb:
            a, b = fa.read(), fb.read()
        assert a, f"{name} is empty"
        assert a == b, f"{name} differs"


def both_clis(d, tag: str, args, names, port_args=()):
    """Run linear_tpu and the port with the same args in d/j_<tag> and
    d/p_<tag> (the inputs are named relative to those) and compare the
    named output files; returns the two CompletedProcesses."""
    pj = run_cli("linear_tpu", os.path.join(d, f"j_{tag}"), args)
    pp = run_cli("linear_tpu_torch", os.path.join(d, f"p_{tag}"),
                 [*args, *port_args])
    same_files(os.path.join(d, f"j_{tag}"), os.path.join(d, f"p_{tag}"), names)
    return pj, pp


@pytest.mark.parametrize("name", NAMES)
def test_native_library_is_loaded(name):
    """After ensure_native the JAX package's own loaders hand out the
    library, not a cached miss."""
    assert JN.load(name) is LIBS[name] is not None
    if name == "lt_engine":
        assert JNE.engine_lib() is not None and JNE.enabled()
    if name == "lt_sort":
        assert JCX._lib() is not None
