"""Scores of the -a banded alignment (linear_tpu.ops.align_pallas).

Only the scoring constants that map.align's host traceback reads live here
for now; the banded-score kernel itself (linear_tpu/ops/align_pallas.py:142,
`pl.pallas_call(_ba_kernel)`) is still to be ported (ROADMAP.md, Queue 1
item 9).
"""
S_MATCH = 3      # src/align_interface.cpp:178
S_MISMATCH = -2  # :179
S_GAP = -1       # :180-181 (open == extend -> linear)
