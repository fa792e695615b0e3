"""Scalar (plain Python int) cord/hit/anchor bit helpers.

Counterpart of linear_tpu.utils.cordscalar. Same formats as utils.cordlib
(which is numpy-vectorized); these
operate on plain ints with explicit uint64 wrap semantics and are used by the
host-exact mapping oracle where append-heavy scalar logic dominates.

Layout (reference include/cords.h, src/cords.cpp:21-37):
    main[1]@63 | recd[1]@62 | strand[1]@61 | blockEnd[1]@60 |
    id[10]@50  | x[30]@20   | y[20]@0
"""
from __future__ import annotations

M64 = (1 << 64) - 1
MASK_Y = (1 << 20) - 1
MASK_X30 = (1 << 30) - 1
MASK_XID = (1 << 40) - 1  # getCordX: 40-bit id|x field (src/cords.cpp:25)
MASK_ID = (1 << 10) - 1
FLAG_END = 1 << 60
FLAG_STRAND = 1 << 61
FLAG_RECD = 1 << 62
FLAG_MAIN = 1 << 63
FLAG_LONG_PATTERN = 1 << 62  # hits only (HitBase flag2^... src/cords.cpp:40)
VALUE_MASK = (1 << 60) - 1
VALUE_MASK_DSTR = VALUE_MASK | FLAG_STRAND
ANCHOR_ZERO = 1 << 20  # const_anchor_zero (src/cords.cpp:8)
CELL_BIT = 4
MAX_CORD_ID = (1 << 10) - 1
MAX_CORD_X = (1 << 30) - 1
MAX_CORD_Y = (1 << 20) - 1


def cy(c: int) -> int:
    return c & MASK_Y


def cx(c: int) -> int:
    return (c >> 20) & MASK_X30


def cxid(c: int) -> int:
    """_DefaultCord.getCordX: the 40-bit id|x field (src/cords.cpp:50)."""
    return (c >> 20) & MASK_XID


def cid(c: int) -> int:
    return (c >> 50) & MASK_ID


def strand(c: int) -> int:
    return (c >> 61) & 1


def is_end(c: int) -> int:
    return c & FLAG_END


def set_end(c: int) -> int:
    return c | FLAG_END


def unset_end(c: int) -> int:
    return c & ~FLAG_END


def make_cord(gid: int, x: int, y: int, std: int) -> int:
    """create_cord (src/cords.cpp:195); pure uint64 arithmetic, no masking."""
    return ((((gid << 30) + x) << 20) + y + (std << 61)) & M64


def make_anchor(gid: int, x: int, y: int, std: int) -> int:
    """make_anchor (src/cords.cpp:319): x-field = x - y + 2^20."""
    return make_cord(gid, x - y + ANCHOR_ZERO, y, std)


def shift(c: int, dx: int, dy: int) -> int:
    """Cord::shift (src/cords.cpp:135); uint64 wrap semantics."""
    if dx < 0:
        return (c - ((-dx) << 20) + dy) & M64
    return (c + (dx << 20) + dy) & M64


def hit2cord_dstr(h: int) -> int:
    """hit2Cord_dstr (src/cords.cpp:81): anchor/hit -> cord keeping strand,
    dropping longPattern/blockEnd flags."""
    new = (h + ((h & MASK_Y) << 20) - (ANCHOR_ZERO << 20)) & VALUE_MASK_DSTR
    return new & ~FLAG_LONG_PATTERN


def anchor_x(a: int) -> int:
    """getAnchorX (src/cords.cpp:463)."""
    return cx(hit2cord_dstr(a))


def is_consecutive(c1: int, c2: int, thd: int) -> bool:
    """isCordsConsecutive_ (src/cords.cpp:306)."""
    x1, x2, y1, y2 = cx(c1), cx(c2), cy(c1), cy(c2)
    return (
        strand(c1 ^ c2) == 0 and x1 <= x2 and y1 <= y2 and x2 - x1 < thd and y2 - y1 < thd
    )


def up_forward_y(first: int, second: int, read_len: int) -> tuple[int, int]:
    """getUPForwardy (src/cords.cpp:469)."""
    if strand(first):
        return (read_len - 1 - cy(second), read_len - 1 - cy(first))
    return (cy(first), cy(second))


def set_max_len(cords: list, length: int) -> None:
    """Cord::setMaxLen (src/cords.cpp:122): cords[0] low 20 bits hold max
    block length."""
    if length > (cords[0] & MASK_Y):
        cords[0] = length + (cords[0] & ~MASK_Y)


def get_max_len(cords: list) -> int:
    if not cords:
        return 0
    return cords[0] & MASK_Y
