"""FASTA reading for the reference: A, C, G, T (either case) to 0-3,
anything else to 4 (N)."""
from __future__ import annotations

import numpy as np

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[_c + 32] = _i


def read_fasta(path: str):
    """(ids, list of uint8 code arrays) of every record, in file order."""
    data = np.fromfile(path, dtype=np.uint8)
    if not len(data):
        return [], []
    if data[-1] != ord("\n"):
        data = np.concatenate([data, np.array([ord("\n")], np.uint8)])
    nl = np.flatnonzero(data == ord("\n"))
    starts = np.concatenate([[0], nl[:-1] + 1])
    hdr = data[starts] == ord(">")
    lens = nl - starts
    seq_line = ~hdr
    keep = np.repeat(seq_line, lens + 1)
    keep[nl] = False
    codes = _CODE[data[keep]]
    rec = np.cumsum(hdr) - 1
    per_rec = np.bincount(rec[seq_line], weights=lens[seq_line],
                          minlength=int(hdr.sum())).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum(per_rec)])
    ids = [data[s + 1: e].tobytes().decode().split()[0]
           for s, e in zip(starts[hdr].tolist(), nl[hdr].tolist())]
    seqs = [codes[a:b] for a, b in zip(bounds[:-1].tolist(),
                                        bounds[1:].tolist())]
    return ids, seqs
