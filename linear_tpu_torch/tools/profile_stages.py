"""Warm per-stage rates of the mapping path on the benchmark corpus
(counterpart of linear_tpu's tools/profile_stages.py).

    python -m linear_tpu_torch.tools.profile_stages [n_reads] [--json]
        [--device cuda|cpu|host]

On the first n_reads (default 1024) reads of the corpus (common.make_corpus,
written once under _build/smoke/, as chip_smoke.py writes it), after
Mapper.warmup():
  dev_seed          block seeding, Mapper._device_seed_block (reads/s,
                    packing and copies included)
  host_hits         the native first pass to the hits from the device seeds
                    (one core)
  dev_extend        _filterHits + path_dst_2, Mapper._device_extend_block
  host_finish       the native finish from the device's cords
  host_full         the native engine seeding and mapping each read itself,
                    with its phase split (features, apx, gap, output: us a
                    read, le_stage_ns)
  host_full_seeded  the same from the device seeds
and the host builds (features, native DIndex, native HIndex: s). On cuda
also the seed wire's transfers: one superchunk's h2d and d2h bytes over the
pinned-copy rates measured here by a torch copy of the same bytes, and the
seed kernel on the block's first superchunk (CUDA events) beside its bound
(common.seed_bound: bytes at 3.35 TB/s, operations at 67 T/s). With
--device host the device stages are not run (their keys are left out).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import common


def rate(f, n: int, warm: int = 1, reps: int = 2) -> float:
    """Reads a second of f over n reads: reps timed calls after warm
    untimed ones."""
    for _ in range(warm):
        f()
    t0 = time.time()
    for _ in range(reps):
        f()
    return n * reps / (time.time() - t0)


def copy_rates(rows: int, pad: int, m_out: int, iters: int = 20) -> dict:
    """Pinned h2d of one superchunk's wire and d2h of its result rows, by
    CUDA events over iters copies: bytes and GB/s each way."""
    import torch

    h2d = rows * (pad // 4 + 8)
    d2h = rows * (m_out + 1) * 8
    src = torch.zeros(h2d, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(h2d, dtype=torch.uint8, device="cuda")
    res = torch.zeros(d2h, dtype=torch.uint8, device="cuda")
    dst = torch.empty(d2h, dtype=torch.uint8, pin_memory=True)
    out = {"h2d_bytes": h2d, "d2h_bytes": d2h}
    for name, copy, nbytes in (("h2d", lambda: dev.copy_(src, True), h2d),
                               ("d2h", lambda: dst.copy_(res, True), d2h)):
        copy()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            copy()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        out[f"{name}_ms"] = ms
        out[f"{name}_GBps"] = nbytes / ms / 1e6
    out["wire_ms"] = out["h2d_ms"] + out["d2h_ms"]
    return out


def seed_kernel(mapper, reads: list) -> dict:
    """The seed kernel on the first SEED_SUPERCHUNK reads of the block at
    their pad: ms a launch (CUDA events on cuda, the host clock on cpu)
    and its bound for this data."""
    import torch

    from ..map.mapper import MAX_SEED_READ_LEN, THD_MIN_READ_LEN
    from ..ops import seeding as SD

    index = mapper._ensure_dev_index()
    part = [r for r in reads
            if THD_MIN_READ_LEN < len(r) <= MAX_SEED_READ_LEN][
                : mapper.SEED_SUPERCHUNK]
    pad = 1 << max(int(np.ceil(np.log2(max(map(len, part))))), 10)
    rows, m_out = mapper.SEED_SUPERCHUNK, mapper.SEED_M_OUT
    wire, _ = SD.pack_superchunk(part, pad, rows)
    w = torch.from_numpy(wire).to(mapper.device)

    def launch():
        return SD.seed_superchunk(w, index, m_out)

    out = launch()
    common.sync(mapper.device)
    probed = (out[:, -1].cpu().numpy() >> 32)[: len(part)]
    iters = 20 if mapper.device == "cuda" else 2
    if mapper.device == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.time()
        for _ in range(iters):
            launch()
        ms = (time.time() - t0) * 1e3 / iters
    b = common.seed_bound(wire.nbytes, rows, m_out,
                          [min(len(r), pad) for r in part], probed)
    return {"shape": [rows, pad, m_out], "ms": ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}


def profile(args) -> dict:
    from ..index import hindex as HI
    from ..map import nengine as NE
    from ..map.mapper import (MAX_SEED_READ_LEN, THD_MIN_READ_LEN, Mapper,
                              MapperConfig)
    from ..utils import seqio

    _, g_fa, r_fa = common.make_corpus(
        common.build_dir("smoke"), args.genome_len, args.corpus_reads,
        args.read_len)
    out = {"n_reads": args.n_reads, "device": args.device}
    mapper = Mapper([g_fa], MapperConfig(), device=args.device)
    t0 = time.time()
    mapper.create_features()
    out["features_s"] = time.time() - t0
    t0 = time.time()
    mapper.create_index()
    out["dindex_native_build_s"] = time.time() - t0
    t0 = time.time()
    NE.build_hindex_native(mapper.genomes, HI.DEFAULT_SPAN, HI.DEFAULT_STEP,
                           HI.DEFAULT_BLOCKLIMIT, HI.DEFAULT_ALPHA,
                           mapper.cfg.threads)
    out["hindex_native_build_s"] = time.time() - t0
    out["card"] = common.card(args.device)
    ne = mapper.native_engine()
    block = next(seqio.read_blocks(r_fa))
    n = min(args.n_reads, len(block.seqs))
    sub = seqio.SeqSet(ids=block.ids[:n], seqs=block.seqs[:n])
    on_device = mapper.device_work()
    if on_device:
        t0 = time.time()
        mapper.warmup()
        out["warmup_s"] = time.time() - t0
        out["dev_seed_reads_per_s"] = rate(
            lambda: mapper._device_seed_block(sub), n)
        seeds = mapper._device_seed_block(sub)
        out["dev_seed_host_frac"] = sum(s is None for s in seeds) / n
    else:
        seeds = [None] * n

    def hits_pass():
        return [ne.apx_hits(r, s)
                if THD_MIN_READ_LEN < len(r) <= MAX_SEED_READ_LEN else None
                for r, s in zip(sub.seqs, seeds)]

    out["host_hits_reads_per_s"] = rate(hits_pass, n)
    hits = hits_pass()
    if on_device:
        out["dev_extend_reads_per_s"] = rate(
            lambda: mapper._device_extend_block(sub, hits), n)
        dev_cords = mapper._device_extend_block(sub, hits)
        out["dev_extend_coverage"] = sum(c is not None
                                         for c in dev_cords) / n

        def finish_pass():
            ne.reset()
            k = 0
            for r, rid, dc, s in zip(sub.seqs, sub.ids, dev_cords, seeds):
                if dc is None or ne.apx_finish(r, rid, dc, tid=0) is None:
                    ne.map_read(r, rid, seeds=s, tid=0)
                    k += 1
            return k

        out["finish_host_reads"] = finish_pass()
        out["host_finish_reads_per_s"] = rate(finish_pass, n)

    def full_pass(seeded):
        ne.reset()
        for r, rid, s in zip(sub.seqs, sub.ids, seeds):
            ne.map_read(r, rid, seeds=s if seeded else None, tid=0)

    full_pass(False)
    ne.stage_ns()  # restart the phase counters
    out["host_full_reads_per_s"] = rate(lambda: full_pass(False), n)
    # rate() ran three passes (one warm, two timed) since the restart
    for ns, name in zip(ne.stage_ns(), ("features", "apx", "gap", "output")):
        out[f"host_{name}_us_per_read"] = ns / 1e3 / (3 * n)
    out["host_full_seeded_reads_per_s"] = rate(lambda: full_pass(True), n)
    if on_device:
        sk = seed_kernel(mapper, sub.seqs)
        out["seed_kernel"] = sk
        if args.device == "cuda":
            cp = copy_rates(*sk["shape"])
            cp["dev_seed_ms_per_superchunk"] = (
                mapper.SEED_SUPERCHUNK / out["dev_seed_reads_per_s"] * 1e3)
            out["seed_wire"] = cp
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m linear_tpu_torch.tools.profile_stages",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("n_reads", type=int, nargs="?", default=1024)
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line")
    common.add_device_arg(ap)
    ap.add_argument("--genome-len", type=int, default=common.GENOME_LEN)
    ap.add_argument("--corpus-reads", type=int, default=common.N_READS)
    ap.add_argument("--read-len", type=int, default=common.READ_LEN)
    args = ap.parse_args(argv)
    out = profile(args)
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k:>30}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
