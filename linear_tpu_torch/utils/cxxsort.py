"""std::sort-exact sorting (permutation-identical to libstdc++).

Counterpart of linear_tpu.utils.cxxsort. The reference's output on
repeat-rich inputs depends on the unstable permutation std::sort applies to
equal-key runs (anchors by anchor-x desc, src/pmpfinder.cpp:2465; block
pointers by cord-x desc, src/cluster_util.cpp:558; chain-tree ranks by
score desc, src/cluster_util.cpp:269; block starts by strand-adjusted y,
src/cluster_util.cpp:945; and the gap module's anchor-x sorts). A stable
sort silently picks a different repeat copy on ties, so every such call
site routes through here.

The native lt_sort library (native/src/lt_sort.cpp, compiled by
linear_tpu_torch.native) sorts an index array with the very same libstdc++
std::sort and a keys[a] OP keys[b] comparator: the swap sequence, hence the
tie permutation, is the reference's. A failed build raises; the statement-
level Python replica of the introsort is linear_tpu's oracle and the tests
hold this module against it.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

from ..native import load

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = load("lt_sort")
            lib.lt_sort_idx_i64.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_int,
            ]
            lib.lt_sort_idx_i64.restype = None
            _LIB = lib
        return _LIB


def std_sort_perm(keys, desc: bool = False) -> np.ndarray:
    """The permutation libstdc++ std::sort applies when sorting elements
    whose comparator reduces to keys[a] < keys[b] (or > for desc).
    Returns int64 indices; apply as [elements[i] for i in perm]."""
    karr = np.ascontiguousarray(keys, dtype=np.int64)
    n = len(karr)
    idx = np.arange(n, dtype=np.int64)
    _lib().lt_sort_idx_i64(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        karr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        1 if desc else 0,
    )
    return idx


def std_sort(items: Sequence, keys, desc: bool = False) -> list:
    """std::sort-permuted copy of items (keys = precomputed comparator
    keys, one per item)."""
    perm = std_sort_perm(keys, desc)
    return [items[int(i)] for i in perm]
