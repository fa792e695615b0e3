"""The least time of the seed kernel's work (a frozen copy of the port's
tools/common.bound and seed_bound): its bytes over the H100 SXM's HBM3
rate, or its integer operations over the card's rate outside the tensor
cores (67 T/s, the float32 non-tensor peak, taken for its integer rate
too), whichever is larger."""
from __future__ import annotations

import numpy as np

HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12


def bound(nbytes: float, ops: float) -> dict:
    t_b = nbytes / HBM_BYTES_S
    t_o = ops / SCALAR_OPS_S
    return {"bound_s": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def n_calls(lens, thd_alpha: int = 15) -> int:
    """Call positions of reads of these lengths (k = 35 + 15p < len - 21)."""
    lens = np.asarray(lens, dtype=np.int64)
    return int(np.maximum(0, -(-(lens - 56) // thd_alpha)).sum())


def seed_bound(lens, m_out: int, probed) -> dict:
    """One launch: the rows' 2-bit bases and length words in (what the
    reads need, not the padding of the wire), the rows out, two dir words a
    call position and an hs entry a probed slot below m_out; ~150
    operations a position (window, nine candidates, YValue), ~20 a slot."""
    lens = np.asarray(lens, dtype=np.int64)
    rows = len(lens)
    calls = n_calls(lens)
    slots = int(np.minimum(np.asarray(probed), m_out).sum())
    wire = int((-(-lens // 4)).sum()) + 8 * rows
    return bound(wire + rows * (m_out + 1) * 8 + 8 * calls + 8 * slots,
                 150 * calls + 20 * slots)
