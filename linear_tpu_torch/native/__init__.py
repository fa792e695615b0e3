"""Native (C++) runtime of the port.

The C++ sources live in src/ beside this file, a byte-for-byte copy of the
JAX package's native sources, so the port builds its engine from its own
tree. They are compiled with g++ into linear_tpu_torch/_build/, which git
ignores:
  lt_engine   per-read mapping engine, genome feature + DIndex builders and
              the superchunk wire packer
  lt_seqio    fasta/fastq(.gz) record reader + Dna5 encoding
  lt_sort     libstdc++ std::sort permutations (utils.cxxsort)

A failed build raises: the port has no Python fallback for these.
Concurrent builders (pytest-xdist workers, parallel CLI runs) serialise on an
fcntl lock per library, and each build writes a unique temporary file that
is renamed into place, so no process ever loads a half-written library.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
BUILD_DIR = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()
_LIBS: dict = {}
# seconds each g++ build took in this process (0.0: an up-to-date library
# was already in BUILD_DIR)
BUILD_SECONDS: dict = {}


def _stale(so: str, deps: list) -> bool:
    return (not os.path.exists(so)
            or os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps))


def build(name: str) -> str:
    """Path of the up-to-date shared library for src/<name>.cpp,
    compiled first if missing or older than its sources."""
    src = os.path.join(SRC_DIR, f"{name}.cpp")
    if not os.path.exists(src):
        raise FileNotFoundError(f"native source {src} is missing")
    so = os.path.join(BUILD_DIR, f"{name}.so")
    deps = [src] + glob.glob(os.path.join(SRC_DIR, "*.hpp"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(so, deps):
            BUILD_SECONDS.setdefault(name, 0.0)
            return so
        fd, tmp = tempfile.mkstemp(prefix=f"{name}.", suffix=".so.tmp",
                                   dir=BUILD_DIR)
        os.close(fd)
        t0 = time.time()
        try:
            # -march=native: the library is built per machine at first use
            # and never shipped
            cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-fopenmp",
                   "-shared", "-fPIC", src, "-lz", "-o", tmp]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed to build {src}:\n"
                                   f"{res.stderr[-4000:]}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        BUILD_SECONDS[name] = time.time() - t0
    return so


def load(name: str) -> ctypes.CDLL:
    """ctypes CDLL of a native library, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(build(name))
        return _LIBS[name]


def seqio_lib() -> ctypes.CDLL:
    lib = load("lt_seqio")
    if not getattr(lib, "_lt_configured", False):
        lib.lt_open.restype = ctypes.c_void_p
        lib.lt_open.argtypes = [ctypes.c_char_p]
        lib.lt_open_range.restype = ctypes.c_void_p
        lib.lt_open_range.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                      ctypes.c_long]
        lib.lt_next.restype = ctypes.c_int
        lib.lt_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.lt_err.restype = ctypes.c_int
        lib.lt_err.argtypes = [ctypes.c_void_p]
        lib.lt_close.restype = None
        lib.lt_close.argtypes = [ctypes.c_void_p]
        lib._lt_configured = True
    return lib
