"""Sequence I/O: fasta/fastq(.gz) records and Dna5 <-> u8 encoding.

Counterpart of linear_tpu.utils.seqio. Records are read by the native C++
reader (native/src/lt_seqio.cpp, built by linear_tpu_torch.native);
the port carries no Python parser. Dna5 ordValue encoding: A=0 C=1 G=2 T=3
N=4 (reference: src/base.cpp:131 loadRecords).
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

import numpy as np

from ..native import seqio_lib

# everything not ACGTacgt maps to N(4), as SeqAn's Dna5 conversion does
_CODE = np.full(256, 4, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _CODE[ord(c)] = i
    _CODE[ord(c.lower())] = i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)
# complement: A<->T C<->G, N->N  (reference: src/base.cpp:325 _complt "tgcan")
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A0 C1 G2 T3 N4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return _DECODE[codes].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (reference: _compltRvseStr)."""
    return _COMP[codes[::-1]]


def _drain(lib, h, what: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (id, codes) from an open native reader handle, closing it."""
    try:
        pid = ctypes.c_char_p()
        idl = ctypes.c_long()
        pseq = ctypes.c_void_p()
        seql = ctypes.c_long()
        while True:
            rc = lib.lt_next(h, ctypes.byref(pid), ctypes.byref(idl),
                             ctypes.byref(pseq), ctypes.byref(seql))
            if rc == 0:
                return
            if rc < 0:
                if lib.lt_err(h) == 3:
                    raise ValueError(f"malformed fastq in {what}")
                raise ValueError(f"unrecognized sequence file format: {what}")
            # the full header line is the id (SeqAn keeps the whole meta)
            rid = ctypes.string_at(pid, idl.value).decode()
            n = seql.value
            codes = (np.frombuffer(ctypes.string_at(pseq, n),
                                   dtype=np.uint8).copy()
                     if n else np.zeros(0, dtype=np.uint8))
            yield rid, codes
    finally:
        lib.lt_close(h)


def read_seq_records(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (id, codes) records from a fasta/fastq file, optionally
    gzipped."""
    lib = seqio_lib()
    h = lib.lt_open(path.encode())
    if not h:
        raise FileNotFoundError(f"E[06]: can't open file {path}")
    yield from _drain(lib, h, path)


@dataclass
class SeqSet:
    """A loaded set of sequences (genomes or a read block)."""

    ids: List[str] = field(default_factory=list)
    seqs: List[np.ndarray] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.seqs)


def load_genomes(paths: List[str]) -> SeqSet:
    """Load all genome fasta files (reference: loadRecords src/base.cpp:131)."""
    out = SeqSet()
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"E[06]: can't open file {p}")
        for rid, codes in read_seq_records(p):
            out.ids.append(rid)
            out.seqs.append(codes)
    return out


def read_blocks(path: str, block_size: int = 50000) -> Iterator[SeqSet]:
    """Stream reads in blocks (reference: map() 50k-read blocks,
    src/mapper.cpp:892)."""
    block = SeqSet()
    for rid, codes in read_seq_records(path):
        block.ids.append(rid)
        block.seqs.append(codes)
        if len(block) >= block_size:
            yield block
            block = SeqSet()
    if len(block):
        yield block


def scan_record_offsets(path: str):
    """Byte offsets of every record start in an UNCOMPRESSED fasta/fastq
    file (plus the file size as a final sentinel), or None for gzipped /
    unrecognized input. Lets pipeline workers re-read their chunk of reads
    from the file instead of receiving pickled arrays over the pool pipe."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
        if magic[:2] == b"\x1f\x8b" or not magic:
            return None
        data = magic + fh.read()
    size = len(data)
    if magic[0:1] == b">":
        offs = [0]
        pos = 0
        while True:
            pos = data.find(b"\n>", pos)
            if pos < 0:
                break
            offs.append(pos + 1)
            pos += 2
        offs.append(size)
        return np.asarray(offs, dtype=np.int64)
    if magic[0:1] == b"@":
        # fastq: every 4th line starts a record
        nl = np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == 10)
        starts = nl[3::4] + 1
        offs = np.concatenate([[0], starts[starts < size]])
        if offs[-1] != size:
            offs = np.concatenate([offs, [size]])
        return offs.astype(np.int64)
    return None


def parse_records_range(path: str, b0: int, b1: int):
    """Parse the records in byte range [b0, b1) of an uncompressed
    fasta/fastq file (bounds from scan_record_offsets). Returns (ids, seqs),
    identical to read_seq_records over those records."""
    lib = seqio_lib()
    h = lib.lt_open_range(path.encode(), b0, b1)
    if not h:
        raise FileNotFoundError(f"E[06]: can't open file {path}")
    ids: List[str] = []
    seqs: List[np.ndarray] = []
    for rid, codes in _drain(lib, h, f"range [{b0}, {b1}) of {path}"):
        ids.append(rid)
        seqs.append(codes)
    return ids, seqs


def write_fasta(path: str, ids: List[str], seqs: List[np.ndarray],
                width: int = 80) -> None:
    with open(path, "w") as fh:
        for rid, s in zip(ids, seqs):
            fh.write(f">{rid}\n")
            txt = decode(s)
            for i in range(0, len(txt), width):
                fh.write(txt[i: i + width] + "\n")
