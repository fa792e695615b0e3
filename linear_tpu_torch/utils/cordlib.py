"""Packed-u64 coordinate formats: Cord / Hit / Anchor.

The cord is the central IR of the whole engine (reference: include/cords.h,
src/cords.cpp). Layout (bit positions):

    main[1]@63 | recd[1]@62 | strand[1]@61 | blockEnd[1]@60 |
    id[10]@50  | x[30]@20   | y[20]@0

Anchors share the layout with x-field = (genome_x - read_y + 2^20)
(reference: make_anchor src/cords.cpp:319, const_anchor_zero=1<<20).
Hits add blockStart@60 semantics and a longPattern flag @62.

All helpers below are numpy-vectorized and operate on uint64 arrays; they are
used by the host oracle, the output layer, and for building device inputs.
Counterpart of linear_tpu.utils.cordlib.
"""
from __future__ import annotations

import numpy as np

U64 = np.uint64

CELL_BIT = 4  # 2^4 = 16 bases per cell (reference: src/cords.cpp:30)
CELL_SIZE = 16
BIT_Y = 20
BIT_ID = 50
BIT_BLOCKEND = 60
BIT_STRAND = 61
BIT_RECD = 62
BIT_MAIN = 63

MASK_Y = U64((1 << 20) - 1)
MASK_X = U64((1 << 30) - 1)
MASK_ID = U64((1 << 10) - 1)
FLAG_END = U64(1) << U64(BIT_BLOCKEND)
FLAG_STRAND = U64(1) << U64(BIT_STRAND)
FLAG_RECD = U64(1) << U64(BIT_RECD)
FLAG_MAIN = U64(1) << U64(BIT_MAIN)
VALUE_MASK = (U64(1) << U64(60)) - U64(1)
VALUE_MASK_DSTR = VALUE_MASK | FLAG_STRAND

CONST_ANCHOR_ZERO = U64(1) << U64(20)
MAX_CORD_ID = (1 << 10) - 1
MAX_CORD_X = (1 << 30) - 1
MAX_CORD_Y = (1 << 20) - 1

# Hit flags (reference: HitBase src/cords.cpp:40: bit=60, bit2=61)
FLAG_HIT_BLOCK = U64(1) << U64(60)
FLAG_LONG_PATTERN = U64(1) << U64(62)


def _u(v) -> np.ndarray:
    return np.asarray(v, dtype=U64)


def cord_y(c) -> np.ndarray:
    return _u(c) & MASK_Y


def cord_x(c) -> np.ndarray:
    return (_u(c) >> U64(BIT_Y)) & MASK_X


def cord_id(c) -> np.ndarray:
    return (_u(c) >> U64(BIT_ID)) & MASK_ID


def cord_strand(c) -> np.ndarray:
    return (_u(c) >> U64(BIT_STRAND)) & U64(1)


def is_block_end(c) -> np.ndarray:
    return (_u(c) & FLAG_END) != 0


def set_block_end(c) -> np.ndarray:
    return _u(c) | FLAG_END


def unset_block_end(c) -> np.ndarray:
    return _u(c) & ~FLAG_END


def is_long_pattern(c) -> np.ndarray:
    return (_u(c) & FLAG_LONG_PATTERN) != 0


def set_long_pattern(c) -> np.ndarray:
    return _u(c) | FLAG_LONG_PATTERN


def unset_long_pattern(c) -> np.ndarray:
    return _u(c) & ~FLAG_LONG_PATTERN


def make_cord(gid, x, y, strand) -> np.ndarray:
    """create_cord (reference: src/cords.cpp:196)."""
    return (
        (_u(gid) << U64(BIT_ID))
        + (_u(x) << U64(BIT_Y))
        + _u(y)
        + (_u(strand) << U64(BIT_STRAND))
    )


def make_anchor(gid, x, y, strand) -> np.ndarray:
    """Anchor = cord with x-field = x - y + 2^20 (src/cords.cpp:319)."""
    return make_cord(gid, _u(x) - _u(y) + CONST_ANCHOR_ZERO, y, strand)


def anchor_x(a) -> np.ndarray:
    """Genome x of an anchor: getAnchorX (src/cords.cpp:463) =
    cord_x(hit2Cord_dstr(anchor)) = diag + y - 2^20."""
    return cord_x(hit2cord_dstr(a))


def hit2cord_dstr(h) -> np.ndarray:
    """Convert an anchor/hit to a cord, keeping strand (src/cords.cpp:81-90):
    new = (hit + (y << 20) - (2^20 << 20)) & (valueMask | strand); drops
    longPattern / blockEnd flags."""
    h = _u(h)
    new = (h + ((h & MASK_Y) << U64(BIT_Y)) - (CONST_ANCHOR_ZERO << U64(BIT_Y))) & VALUE_MASK_DSTR
    return unset_long_pattern(new)


def shift_cord(c, dx, dy) -> np.ndarray:
    """cord + (dx << 20) + dy with signed deltas (src/cords.cpp:137)."""
    c = _u(c)
    dx = np.asarray(dx, dtype=np.int64)
    dy = np.asarray(dy, dtype=np.int64)
    return (c.astype(np.int64) + (dx << np.int64(BIT_Y)) + dy).astype(U64)


def new_xy_cord(c, x, y) -> np.ndarray:
    c = _u(c)
    return (c & ~VALUE_MASK) + (_u(x) << U64(BIT_Y)) + _u(y)


def set_main(c) -> np.ndarray:
    return _u(c) | FLAG_MAIN


def set_recd(c, sgn) -> np.ndarray:
    """Set/clear bit 62 according to sgn (reference: set_cord_recd)."""
    c = _u(c)
    return np.where(np.asarray(sgn) != 0, c | FLAG_RECD, c & ~FLAG_RECD)


def is_cords_consecutive(c1, c2, thd_cord_gap) -> np.ndarray:
    """isCordsConsecutive_ (src/cords.cpp:300): same strand, x/y both
    non-decreasing and increments < thd."""
    c1, c2 = _u(c1), _u(c2)
    x1, x2 = cord_x(c1), cord_x(c2)
    y1, y2 = cord_y(c1), cord_y(c2)
    same = cord_strand(c1 ^ c2) == 0
    thd = U64(thd_cord_gap)
    return same & (x1 <= x2) & (y1 <= y2) & (x2 - x1 < thd) & (y2 - y1 < thd)


def up_forward_y(first, second, read_len) -> tuple:
    """getUPForwardy (src/cords.cpp:469): project a (str,end) cord pair's y
    interval onto the forward strand."""
    if cord_strand(first):
        return (
            int(read_len - 1 - int(cord_y(second))),
            int(read_len - 1 - int(cord_y(first))),
        )
    return (int(cord_y(first)), int(cord_y(second)))


def blocks_of(cords: np.ndarray, start: int = 1) -> list:
    """Split cords[start:] into blocks delimited by the blockEnd flag.
    Returns [(str_idx, end_idx_exclusive), ...]. cords[0] is the header."""
    out = []
    p = start
    for i in range(start, len(cords)):
        if is_block_end(cords[i]):
            out.append((p, i + 1))
            p = i + 1
    if p < len(cords):
        out.append((p, len(cords)))
    return out
