"""Stage traces of the Python engine, and the diff of two (counterpart of
linear_tpu's tools/diffstage.py; the trace format is the same, so a trace
of the port diffs line by line against one of linear_tpu or of an
instrumented reference binary).

    LINEAR_TPU_DBG=mine.txt python -m linear_tpu_torch.tools.diffstage \\
        trace --reads r.fa --genome g.fa [--gap-len 50] [--threads 1] \\
        [--device cuda|cpu|host]
    python -m linear_tpu_torch.tools.diffstage diff ref.txt mine.txt

trace maps every read, in file order on one emulated thread, through
Mapper.map_read, which writes `TAG n v0 v1 ...` lines at the apx and gap
stage boundaries (ANCH/FANC/CHA1/PREF/HITS/CRDS/APXF, then GAPF/GAPE/REFC
and the gap module's own) to the LINEAR_TPU_DBG file. On cuda or cpu the
device seeds each read block first (Mapper._device_seed_block); reads it
leaves out are seeded on the host, and the chain DP stays on the host (the
device's pre-pass would write every read's FANC line ahead of the first
read's trace). The device seeds equal the host's, so the trace does not
depend on --device. diff reports the first line where the two traces part,
with its cords decoded, and exits 1; 0 when they are identical.
"""
from __future__ import annotations

import argparse
import os
import sys

from . import common


def cmd_trace(args) -> int:
    if not os.environ.get("LINEAR_TPU_DBG"):
        print("diffstage trace: set LINEAR_TPU_DBG=<out path>",
              file=sys.stderr)
        return 2
    from ..map.mapper import Mapper, MapperConfig
    from ..utils import seqio

    m = Mapper([args.genome], MapperConfig(gap_len=args.gap_len,
                                           threads=args.threads),
               device=args.device)
    m.prepare()
    seeded = n = 0
    for block in seqio.read_blocks(args.reads):
        seeds = [None] * len(block.seqs)
        if m.device_work():
            seeds = m._device_seed_block(block)
        for read, s in zip(block.seqs, seeds):
            m.map_read(read, seed_anchors=s)
        seeded += sum(s is not None for s in seeds)
        n += len(block.seqs)
    if m.device_work():
        print(f"{common.card(args.device)}; seeded on the device {seeded} "
              f"of {n} reads")
    print("trace written to", os.environ["LINEAR_TPU_DBG"])
    return 0


def parse_trace(path: str) -> list:
    out = []
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if not parts:
                continue
            tag, n = parts[0], int(parts[1])
            vals = [int(v) for v in parts[2:]]
            if len(vals) != n:
                raise ValueError(f"bad line in {path}: {ln[:80]}")
            out.append((tag, vals))
    return out


def fmt_cord(v: int) -> str:
    from ..utils.cordscalar import cid, cx, cy, is_end, strand

    return (f"{v}(id={cid(v)} x={cx(v)} y={cy(v)} s={strand(v)} "
            f"e={1 if is_end(v) else 0})")


def cmd_diff(args) -> int:
    t1 = parse_trace(args.ref)
    t2 = parse_trace(args.mine)
    n_reads = 0
    for i, ((tag1, v1), (tag2, v2)) in enumerate(zip(t1, t2)):
        if tag1 == "ANCH":
            n_reads += 1
        if tag1 != tag2:
            print(f"line {i}: TAG mismatch {tag1} vs {tag2} (read ~{n_reads})")
            return 1
        if v1 != v2:
            print(f"line {i}: stage {tag1} diverges (read ordinal "
                  f"~{n_reads}, 1-based)")
            print(f"  ref  n={len(v1)}  mine n={len(v2)}")
            shown = 0
            for k in range(max(len(v1), len(v2))):
                a = v1[k] if k < len(v1) else None
                b = v2[k] if k < len(v2) else None
                if a != b and shown < args.show:
                    fa = fmt_cord(a) if a is not None else "<none>"
                    fb = fmt_cord(b) if b is not None else "<none>"
                    print(f"  [{k}] ref {fa}\n       mine {fb}")
                    shown += 1
            return 1
    if len(t1) != len(t2):
        print(f"trace length mismatch: ref {len(t1)} mine {len(t2)} "
              "(common prefix identical)")
        return 1
    print(f"traces identical ({len(t1)} stage lines, ~{n_reads} reads)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m linear_tpu_torch.tools.diffstage",
        description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("trace")
    tr.add_argument("--reads", required=True)
    tr.add_argument("--genome", required=True)
    tr.add_argument("--gap-len", type=int, default=0)
    tr.add_argument("--threads", type=int, default=1)
    common.add_device_arg(tr)
    tr.set_defaults(fn=cmd_trace)
    df = sub.add_parser("diff")
    df.add_argument("ref")
    df.add_argument("mine")
    df.add_argument("--show", type=int, default=6)
    df.set_defaults(fn=cmd_diff)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
