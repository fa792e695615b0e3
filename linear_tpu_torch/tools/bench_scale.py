"""Genome-size scaling of preparation and mapping (counterpart of
linear_tpu's tools/bench_scale.py).

    python -m linear_tpu_torch.tools.bench_scale [--sizes 4600000,46000000]
        [--reads 2048] [--read-len 7000] [--device D]

For each genome size: a synthetic genome of make_genomic_genome chromosomes
of at most 250 Mb each (cord x is 30 bits) and `reads` reads of read-len
bases from it at 8 % substitutions, every third reverse-complemented,
written once under _build/scale/; then the genome load, the features, the
native DIndex and HIndex builds, the device index (Mapper._ensure_dev_index,
after the worker pool has forked), and the PipelineMapper's SAM-only
mapping rate on a second pass over the reads (the first warms the pool and
its pages): one table row a size. Each size runs in a process of its own,
so that the pool forks before CUDA starts. On cuda the card's nvidia-smi
line heads the table.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

from . import common

HEADER = (f"{'genome':>10} {'load_s':>7} {'feat_s':>7} {'dindex_s':>9} "
          f"{'hindex_s':>9} {'devidx_s':>9} {'map_reads_s':>12}")


def corpus(size: int, n_reads: int, read_len: int):
    """The genome and reads files of one size (written once)."""
    from ..utils import seqio
    from ..utils.simdata import make_genomic_genome

    d = common.build_dir("scale")
    g_fa = os.path.join(d, f"g{size}.fa")
    r_fa = os.path.join(d, f"r{size}_{n_reads}_{read_len}.fa")
    if os.path.exists(g_fa) and os.path.exists(r_fa):
        return g_fa, r_fa
    rng = np.random.default_rng(size % 100003)
    n_chr = max(1, -(-size // 250_000_000))
    csize = size // n_chr
    chrs = [make_genomic_genome(rng, csize) for _ in range(n_chr)]
    reads = []
    for i in range(n_reads):
        while True:
            c = int(rng.integers(0, n_chr))
            pos = int(rng.integers(0, csize - read_len))
            seg = chrs[c][pos: pos + read_len]
            if (seg == 4).sum() < read_len // 2:
                break
        r = seg.copy()
        sub = rng.random(len(r)) < 0.08
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        if i % 3 == 2:
            r = seqio.revcomp(r)
        reads.append(r)
    seqio.write_fasta(g_fa + ".tmp", [f"chr{i + 1}" for i in range(n_chr)],
                      chrs)
    seqio.write_fasta(r_fa + ".tmp", [f"rd{i}" for i in range(n_reads)],
                      reads)
    os.replace(g_fa + ".tmp", g_fa)
    os.replace(r_fa + ".tmp", r_fa)
    return g_fa, r_fa


def one_size(size: int, args) -> str:
    """The table row of one genome size, in this process."""
    from ..index import hindex as HI
    from ..map import nengine as NE
    from ..map.mapper import Mapper, MapperConfig
    from ..parallel.pipeline import PipelineMapper

    g_fa, r_fa = corpus(size, args.reads, args.read_len)
    t0 = time.time()
    mapper = Mapper([g_fa], MapperConfig(threads=args.threads),
                    device=args.device)
    t_load = time.time() - t0
    t0 = time.time()
    mapper.create_features()
    t_feat = time.time() - t0
    t0 = time.time()
    mapper.create_index()
    t_di = time.time() - t0
    t0 = time.time()
    NE.build_hindex_native(mapper.genomes, HI.DEFAULT_SPAN, HI.DEFAULT_STEP,
                           HI.DEFAULT_BLOCKLIMIT, HI.DEFAULT_ALPHA,
                           args.threads)
    t_hi = time.time() - t0
    with PipelineMapper(mapper, n_workers=args.workers,
                        csize_workers=args.threads) as pipe:
        t_dev = float("nan")
        if mapper.device_work():
            # the pool has forked: CUDA may start now
            common.card(args.device)
            t0 = time.time()
            mapper._ensure_dev_index()
            t_dev = time.time() - t0
        for _ in pipe.run(r_fa, collect_cords=False):
            pass
        n = 0
        t0 = time.time()
        for br in pipe.run(r_fa, collect_cords=False):
            n += br.n
        t_map = time.time() - t0
    return (f"{size / 1e6:>8.1f}M {t_load:>7.2f} {t_feat:>7.2f} "
            f"{t_di:>9.2f} {t_hi:>9.2f} {t_dev:>9.2f} {n / t_map:>12.0f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m linear_tpu_torch.tools.bench_scale",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="4600000,23000000,46000000")
    ap.add_argument("--reads", type=int, default=2048)
    ap.add_argument("--read-len", type=int, default=7000)
    ap.add_argument("--threads", type=int, default=16,
                    help="-t of the mapping (index sampling, task split)")
    ap.add_argument("--workers", type=int, default=None,
                    help="worker processes (default: cores + 1)")
    common.add_device_arg(ap)
    ap.add_argument("--row", action="store_true",
                    help="print only the row of the one size given")
    args = ap.parse_args(argv)
    sizes = [int(x) for x in args.sizes.split(",")]
    if args.row:
        print(one_size(sizes[0], args), flush=True)
        return 0
    if args.device == "cuda":
        # asks nvidia-smi only: CUDA starts in the per-size processes
        print(common.nvidia_smi())
    print(HEADER, flush=True)
    for size in sizes:
        cmd = [sys.executable, "-m", "linear_tpu_torch.tools.bench_scale",
               "--sizes", str(size), "--reads", str(args.reads),
               "--read-len", str(args.read_len), "--threads",
               str(args.threads), "--device", args.device, "--row"]
        if args.workers:
            cmd += ["--workers", str(args.workers)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
        if res.returncode:
            return res.returncode
        print(res.stdout.rstrip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
