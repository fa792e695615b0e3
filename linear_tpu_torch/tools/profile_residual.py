"""cProfile of the Python engine's residual: the lockstep apx phase, the gap
phase and the output of the first n corpus reads, after the device seeded
them (Mapper._device_seed_block) and ran their chain DP
(Mapper._device_chain_block). Counterpart of linear_tpu's
tools/profile_residual.py.

    python -m linear_tpu_torch.tools.profile_residual [n] [--device D]

Prints the device stage's and each residual phase's seconds on stderr (with
the card's nvidia-smi line on cuda) and the 45 costliest calls by
cumulative time on stdout. With --device host the engine seeds and chains
on the host.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys
import time

from . import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m linear_tpu_torch.tools.profile_residual",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=128)
    common.add_device_arg(ap)
    ap.add_argument("--genome-len", type=int, default=common.GENOME_LEN)
    ap.add_argument("--corpus-reads", type=int, default=common.N_READS)
    ap.add_argument("--read-len", type=int, default=common.READ_LEN)
    args = ap.parse_args(argv)

    from ..map import pmpfinder as PMP
    from ..map.mapper import Mapper, MapperConfig
    from ..utils import seqio

    _, g_fa, r_fa = common.make_corpus(
        common.build_dir("smoke"), args.genome_len, args.corpus_reads,
        args.read_len)
    t0 = time.time()
    mapper = Mapper([g_fa], MapperConfig(), device=args.device)
    mapper.prepare()
    print(f"prepare: {time.time() - t0:.2f} s", file=sys.stderr)
    block = next(seqio.read_blocks(r_fa))
    reads, rids = block.seqs[: args.n], block.ids[: args.n]
    n = len(reads)
    seeds, chain_pre = [None] * n, [None] * n
    if mapper.device_work():
        print(common.card(args.device), file=sys.stderr)
        mapper.warmup()
        t0 = time.time()
        seeds = mapper._device_seed_block(seqio.SeqSet(ids=rids, seqs=reads))
        chain_pre = mapper._device_chain_block(seeds)
        cc = mapper.chain_counters
        print(f"device seed + chain ({args.device}): {time.time() - t0:.3f} "
              f"s; seeded {cc.seeded} of {n}, chained {cc.chained}",
              file=sys.stderr)

    def residual():
        mapper.reset_gap_parms()
        gens = [mapper.map_read_gen(r, seed_anchors=s, chain_pre=c)
                for r, s, c in zip(reads, seeds, chain_pre)]
        t0 = time.time()
        mapped = PMP.run_lockstep(gens)
        t_apx = time.time() - t0
        t0 = time.time()
        for read, (cs, ce, _, rc, f1) in zip(reads, mapped):
            mapper.gap_phase(read, rc, cs, ce, f1)
        t_gap = time.time() - t0
        t0 = time.time()
        for read, rid, (cs, ce, *_) in zip(reads, rids, mapped):
            mapper.read_output(read, rid, cs, ce)
        t_out = time.time() - t0
        print(f"apx (lockstep): {t_apx:.2f} s  gap: {t_gap:.2f} s  out: "
              f"{t_out:.2f} s (host, {n} reads)", file=sys.stderr)

    pr = cProfile.Profile()
    pr.enable()
    residual()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(45)
    print(s.getvalue())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
