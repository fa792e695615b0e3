"""FASTA output of the generated genome and reads. Each file is synced to
disk as it is closed, so that its writeback does not fall in the window."""
from __future__ import annotations

import os

import numpy as np

LETTERS = np.frombuffer(b"ACGTN", dtype=np.uint8)


def write_genome(path: str, name: str, codes: np.ndarray, width: int = 80):
    n = len(codes)
    rows = -(-n // width)
    padded = np.full(rows * width, ord("\n"), dtype=np.uint8)
    padded[:n] = LETTERS[codes]
    body = np.full((rows, width + 1), ord("\n"), dtype=np.uint8)
    body[:, :width] = padded.reshape(rows, width)
    text = body.reshape(-1)
    # the last row is short: drop its padding, keep one newline
    cut = n + rows - 1
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(text[:cut].tobytes())
        f.write(b"\n")
        f.flush()
        os.fsync(f.fileno())


def write_reads(path: str, names: list, reads: list):
    with open(path, "wb") as f:
        for name, r in zip(names, reads):
            f.write(b">" + name.encode() + b"\n")
            f.write(LETTERS[r].tobytes())
            f.write(b"\n")
        f.flush()
        os.fsync(f.fileno())
