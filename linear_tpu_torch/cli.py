"""Command-line interface mirroring the reference's `linear filter`
(src/args_parser.cpp, src/linear.cpp); counterpart of linear_tpu.cli.

Usage: python -m linear_tpu_torch filter [OPTIONS] read.fa/fastq(.gz) genome.fa
Multi-file: python -m linear_tpu_torch filter r1.fa r2.fa x g1.fa g2.fa

--device host|cpu|cuda (default cuda): who runs the device kernels. host:
none, the native engine does all the work; cpu: the plain PyTorch versions;
cuda: the hand-written CUDA kernels. On a device the reads are seeded there, the
DIndex tables are built there when no genome has N (uploaded from the host
build otherwise), and with -b 0 the dense-window extension runs there too.
With the Python engine (LINEAR_TPU_ENGINE=py, or -a 1, which the native
engine does not implement) the device chains the seeded reads instead of
extending them. cuda never falls back: without a card the run exits 1. A
device run first joins the torch.distributed process group that the
environment describes (parallel.dist; a no-op without WORLD_SIZE > 1).
The device works on the DIndex and the 2_48 features only: with -i 2/3 or
-f 0/1 a device run maps on the host engines, as linear_tpu's does, and
says so on stderr. LINEAR_TPU_TRACE=<file> traces the run and writes its
spans and counters at the end as Chrome trace-event JSON
(parallel.pipeline.write_trace).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="linear_tpu_torch",
        description="linear_tpu_torch - alignment-free long-read mapper / "
                    "SV filter, PyTorch + CUDA port",
    )
    sub = p.add_subparsers(dest="submodule")
    f = sub.add_parser("filter", help="detect SV signals in long reads; outputs SAM/APF")
    f.add_argument("files", nargs="+", help="read files [x] genome files")
    f.add_argument("-o", "--output", default="", help="output prefix")
    f.add_argument("-ot", "--output_type", type=int, default=2,
                   help="1 apf, 2 sam (default), 4 bam, 8 pbsv bam; sum to "
                        "combine")
    f.add_argument("-t", "--thread", type=int, default=16)
    f.add_argument("-g", "--gap_len", type=int, default=1,
                   help="min gap len; 0 disables gap mapping; 1 -> default 50")
    f.add_argument("-rg", "--read_group", default="")
    f.add_argument("-sn", "--sample_name", default="")
    f.add_argument("-ss", "--sequence_sam", type=int, default=0)
    f.add_argument("-dup", "--duplication", type=int, default=0)
    f.add_argument("-b", "--bal_flag", type=int, default=1)
    f.add_argument("-p", "--preset", type=int, default=1,
                   help="effective reference default is 1")
    f.add_argument("-i", "--index_type", type=int, default=1)
    f.add_argument("-a", "--align", type=int, default=0)
    f.add_argument("-c", "--apx_c_flag", type=int, default=1)
    f.add_argument("-f", "--feature_type", type=int, default=2)
    f.add_argument("-r", "--reform_ccs_cigar_flag", type=int, default=0)
    f.add_argument("--save-index", default="",
                   help="serialize the built index to PATH(.npz) and continue")
    f.add_argument("--load-index", default="",
                   help="load a previously saved index instead of building "
                        "(must match -i/-t and the genome files)")
    f.add_argument("--device", choices=["host", "cpu", "cuda"], default="cuda",
                   help="who runs the device kernels (seeding, index build, "
                        "-b 0 extension, chain DP of the Python engine): "
                        "none (host), their plain PyTorch versions (cpu) or "
                        "the CUDA kernels (cuda)")
    return p


def split_files(files: List[str]) -> tuple:
    """reads... x genomes... Cartesian syntax (src/args_parser.cpp:297)."""
    if "x" in files:
        i = files.index("x")
        return files[:i], files[i + 1:]
    return files[:-1], files[-1:]


def run_filter(args) -> int:
    from .map.mapper import Mapper, MapperConfig
    from .out import bam as BAM
    from .out import bamlink as BL
    from .utils import seqio

    read_paths, genome_paths = split_files(args.files)
    if not read_paths or not genome_paths:
        print("E[01]: provide reads and genome files", file=sys.stderr)
        return 1
    if args.index_type not in (1, 2, 3):
        print(f"E[11]: unknown index type -i {args.index_type}; use 1 "
              "(DIndex, default), 2 (HIndex) or 3 (SIndex)", file=sys.stderr)
        return 1
    cfg = MapperConfig(
        gap_len=args.gap_len,
        apx_chain_flag=args.apx_c_flag,
        output_type=args.output_type,
        threads=args.thread,
        index_type=args.index_type,
        preset=args.preset,
        read_group=args.read_group,
        sample_name=args.sample_name,
        # reference quirk: the @PG CL: tag is ALWAYS empty
        # (src/base.cpp:64 guards it with a condition that is never true)
        cmd_line="",
        sequence_sam=args.sequence_sam,
        reform_ccs=args.reform_ccs_cigar_flag,
        f_dup=args.duplication,
        bal_flag=args.bal_flag,
        feature_t=args.feature_type,
        aln_flag=args.align,
    )
    if args.device in ("cpu", "cuda"):
        # before anything touches CUDA or forks (linear_tpu/cli.py:99-104)
        from .parallel.dist import init_distributed

        init_distributed("nccl" if args.device == "cuda" else "gloo")
    t0 = time.time()
    mapper = Mapper(genome_paths, cfg, device=args.device)
    if len(mapper.genomes) >= 1024:
        # reference guard (src/linear.cpp:106-113): cord genome-id is 10 bits
        print("E[m01G]: Too many reference genoemes <=1024", file=sys.stderr)
        return 1
    print(f"--Read genomes  {len(mapper.genomes)} sequences "
          f"{sum(mapper.genome_lens) >> 20} mbases", file=sys.stderr)
    if args.load_index:
        from .index.serial import load_index

        mapper.create_features()
        try:
            mapper.index = load_index(args.load_index,
                                      expect_index_type=args.index_type,
                                      genome_lens=mapper.genome_lens)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        print(f"--Index loaded  {args.load_index}", file=sys.stderr)
    else:
        mapper.prepare()
    if args.save_index:
        from .index.serial import save_index

        save_index(args.save_index, mapper.index,
                   genome_lens=mapper.genome_lens)
        print(f"--Index saved   {args.save_index}", file=sys.stderr)
    print(f"--Index created Elapsed time[s] {time.time() - t0:.2f}", file=sys.stderr)

    # -b 1 (default): pipelined fetch/compute/print with a worker pool —
    # the process3 analog (src/linear.cpp:67). -b 0: serial block loop.
    pipeline = None
    if args.bal_flag:
        from .parallel.pipeline import PipelineMapper

        pipeline = PipelineMapper(
            mapper, n_workers=max(1, min(args.thread, (os.cpu_count() or 1) + 1)),
            csize_workers=max(1, args.thread))
    seeding = mapper.device_work()
    if args.device != "host" and not seeding:
        # as linear_tpu --device tpu: these configurations map on the host
        # engines. The workers have forked, so CUDA may be asked now
        if args.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                print("E[dev]: --device cuda: no CUDA device is available",
                      file=sys.stderr)
                if pipeline is not None:
                    pipeline.close()
                return 1
        why = " ".join(f"{flag} {v}" for flag, v, d in (
            ("-i", cfg.index_type, 1), ("-f", cfg.feature_t, 2)) if v != d)
        print(f"--Device ({args.device}): {why} runs no device work; the "
              f"host engines map the reads", file=sys.stderr)
    if seeding:
        # the workers have forked: torch may be imported and the device
        # initialised now
        t_dev = time.time()
        from .ops import chain_dp as CDP
        from .ops import devbuild as DB
        from .ops import extend_dev as ED
        from .ops import seeding as SD
        from .parallel.pipeline import PipeCounters

        t_import = time.time() - t_dev
        DB.launches = 0
        try:
            mapper._ensure_dev_index()
        except RuntimeError as e:
            print(f"E[dev]: {e}", file=sys.stderr)
            if pipeline is not None:
                pipeline.close()
            return 1
        t_ready = time.time() - t_dev
        print(f"--Device ready Elapsed time[s] {t_ready:.2f} (import torch "
              f"{t_import:.2f}, device start, kernel load and device index "
              f"{t_ready - t_import:.2f})", file=sys.stderr)
        if mapper.dev_index_source == "built":
            print(f"--Device index ({args.device}): built on the card in "
                  f"{mapper.dev_index_seconds:.3f} s, build kernel launches "
                  f"{DB.launches}", file=sys.stderr)
        else:
            print(f"--Device index ({args.device}): uploaded (genome has N) "
                  f"in {mapper.dev_index_seconds:.3f} s", file=sys.stderr)
        SD.launches = 0
        ED.launches = 0
        CDP.launches = 0
    # (read file, PipeCounters) of each read file (pipeline or serial loop)
    runs = []
    from .parallel.pipeline import trace_path, write_trace

    trace_file = trace_path()

    f_apf = args.output_type & 1
    f_sam = args.output_type & 2
    f_bam = args.output_type & 4
    f_pbsv = args.output_type & 8
    n_done = 0

    def write_bams(prefix, bam_lines):
        """<prefix>.bam and <prefix>_pbsv.bam (the same records under the
        pbsv header) as -ot asks; returns the result file names."""
        if f_bam:
            BAM.write_bam(prefix + ".bam", mapper.sam_header(),
                          mapper.genome_ids, mapper.genome_lens, bam_lines)
        if f_pbsv:
            hdr = BL.sam_header_pbsv(mapper.genome_ids, mapper.genome_lens,
                                     cfg.read_group, cfg.sample_name,
                                     cfg.cmd_line)
            BAM.write_bam(prefix + "_pbsv.bam", hdr, mapper.genome_ids,
                          mapper.genome_lens, bam_lines)
        return [prefix + ext for ext, fl in
                ((".apf", f_apf), (".sam", f_sam), (".bam", f_bam),
                 ("_pbsv.bam", f_pbsv)) if fl]

    # with -o and multiple read files the reference routes EVERY input into
    # the one shared output set (append across files, single header,
    # src/mapper.cpp:601-613, :981-1003); without -o each input file gets
    # its own <name>.sam/.apf
    shared = bool(args.output)
    of_sam_shared = of_apf_shared = None
    bam_shared: list = []
    if shared:
        of_sam_shared = open(args.output + ".sam", "w") if f_sam else None
        of_apf_shared = open(args.output + ".apf", "w") if f_apf else None
        if of_sam_shared:
            of_sam_shared.write(mapper.sam_header())
    for rpath in read_paths:
        prefix = args.output or rpath.split("/")[-1].split(".")[0]
        if shared:
            of_sam, of_apf, bam_lines = of_sam_shared, of_apf_shared, bam_shared
        else:
            of_sam = open(prefix + ".sam", "w") if f_sam else None
            of_apf = open(prefix + ".apf", "w") if f_apf else None
            bam_lines = []
            if of_sam:
                of_sam.write(mapper.sam_header())
        t1 = time.time()

        def emit(block, cs, sam, bl, n):
            nonlocal n_done
            bam_lines.extend(bl)
            if of_sam:
                of_sam.write(sam)
            if of_apf:
                of_apf.write(mapper.apf_block(cs, block))
            n_done += n
            el = time.time() - t1
            print(f"  Processed:{n_done}  time:{el:.2f}[s]  "
                  f"speed:{n_done / max(el, 1e-9):.2f}[reads/s]", file=sys.stderr)

        if pipeline is not None:
            for br in pipeline.run(rpath, collect_bam=bool(f_bam or f_pbsv),
                                   collect_cords=bool(f_apf)):
                emit(br.block, br.cords_str, br.sam, br.bam_lines, br.n)
            runs.append((rpath, pipeline.counters))
        else:
            counters = (PipeCounters(trace=trace_file is not None)
                        if seeding else None)
            for block in seqio.read_blocks(rpath):
                cs, _, sam, *bl = mapper.map_block(
                    block, counters=counters,
                    collect_bam=bool(f_bam or f_pbsv))
                emit(block, cs, sam, bl[0] if bl else [], len(block))
            if seeding:
                runs.append((rpath, counters))
        if not shared:
            for of in (of_sam, of_apf):
                if of:
                    of.close()
            print("Result files: " + " ".join(write_bams(prefix, bam_lines)),
                  file=sys.stderr)
    if shared:
        for of in (of_sam_shared, of_apf_shared):
            if of:
                of.close()
        print("Result files: " + " ".join(write_bams(args.output, bam_shared)),
              file=sys.stderr)
    if pipeline is not None:
        pipeline.close()
    if seeding:
        def total(key):
            return sum(getattr(c, key) for _, c in runs)

        def per_tier(key):
            return ", ".join(
                f"m_out {t}: {sum(getattr(c, key).get(t, 0) for _, c in runs)}"
                for t in (mapper.SEED_M_OUT, mapper.SEED_M_OUT2))

        print(f"--Device seeding ({args.device}): seeded reads "
              f"{total('seeded')} of {total('fetched')}, mapped with device "
              f"seeds {total('shipped_seeded')}, seed kernel launches "
              f"{SD.launches}", file=sys.stderr)
        print(f"--Device superchunks ({per_tier('superchunks')}), their "
              f"reads ({per_tier('tier_reads')}); seeded on the host: "
              f"{total('host_n')} with N, {total('host_overflow')} "
              f"overflowing m_out {mapper.SEED_M_OUT2}", file=sys.stderr)
        for _, c in runs:
            if c.seed_first_s is not None:
                print(f"--Device seeds landed from {c.seed_first_s:.3f} s to "
                      f"{c.seed_last_s:.3f} s into the read file's run",
                      file=sys.stderr)
        if not mapper.use_native():
            cc = mapper.chain_counters
            print(f"--Device chaining ({args.device}): chained on the device "
                  f"{cc.chained} of {cc.seeded} seeded reads, kernel launches "
                  f"{CDP.launches}; host DP: {cc.host_few} with fewer than 2 "
                  f"anchors, {cc.host_many} over {mapper.CHAIN_MAX_N} anchors, "
                  f"{cc.host_overflow} overflowing W", file=sys.stderr)
        elif not args.bal_flag:
            ec = mapper.ext_counters
            print(f"--Device extension ({args.device}): extended on the "
                  f"device {ec.extended} of {ec.eligible} eligible, kernel "
                  f"launches {ED.launches}; host re-map: {ec.host_n} with N, "
                  f"{ec.host_hits} over {mapper.EXT_H} hits, "
                  f"{ec.host_overflow} overflowing C, {ec.host_reapx} re-apx",
                  file=sys.stderr)
    if trace_file:
        write_trace(trace_file, runs)
        print(f"--Trace written to {trace_file}: "
              f"{sum(len(c.spans) for _, c in runs)} spans of {len(runs)} "
              f"read file runs", file=sys.stderr)
    print(f"Time in sum[s] {time.time() - t0:.2f}", file=sys.stderr)
    return 0


def main(argv: List[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.submodule == "filter":
        return run_filter(args)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
