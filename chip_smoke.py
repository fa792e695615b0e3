#!/usr/bin/env python3
"""Smoke test of linear_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:
  1. the card's name and power limit (nvidia-smi);
  2. builds, from this checkout's sources into linear_tpu_torch/_build/:
     the native engine (g++) and the CUDA kernels (one nvcc a source,
     sm_90a);
  3. the corpus: a 4.6 Mb E. coli-scale genome with assembly N-gaps
     (make_genomic_genome, seed 42) and 10,240 CLR-like reads of about
     7 kb at about 10 % error, every third reverse-complemented (bench.py's
     BASELINE config-1 corpus, with vectorised read simulation); cached
     under _build/smoke/;
  4. the seeding kernel against its plain PyTorch version, both on the card
     at the main path's shapes (rows, pad, m_out) = (1024, 8192, 128),
     (256, 8192, 512) and (64, 131072, 512), and at JAX's default m_out
     8,192 (32, 262144, 8192), whose rows pass the 4,096 slots the kernel
     keeps in shared memory: exact equality on the defined
     part of every row (anchors[:count] and the count | probed << 32
     tail); times from CUDA events, and the card's busy time (below)
     beside them;
  5. the extension kernel (_filterHits + path_dst_2) against its plain
     version, both on the card, at the -b 0 path's shape (B, pad, H, C, R)
     = (1024, 8192, 256, 512, 510), with the hits of the native first pass
     on corpus reads seeded on the card, once more with C cut to 100 so
     that rows overflow, and at (64, 131072, 256, 4352, 8190) on 20-131 kb
     reads cut from the genome, whose feature rows exceed a warp's shared
     memory and go to the device scratch: cords, counts and overflow flags
     exactly equal; each launch's bound counts the work the plain version
     reports for its inputs (distinct genome feature rows read, read
     feature rows, window evaluations, and the longest read's serial
     window steps, printed);
  6. the DIndex build on the card against the host build and against its
     plain version on the card, on the N-free genome (the corpus genome
     with every N replaced by a base from numpy.random.default_rng(43)):
     dir and hs exactly equal; the build time beside the upload time;
  7. the chain DP kernel against its plain version, both on the card, at
     (B, N) = (256, 64), (256, 512) and (256, 8192): rows of corpus reads
     seeded on the card after the Mapper's pre-pass (chain_prepass; cut to
     their first 64 anchors for N = 64), and for N = 8192 rows of 60-120 kb
     reads seeded by the host query (the card's seed tiers stop at 512
     anchors) beside corpus rows; and one hand-built (256, 512) launch of
     dense rows that overflow W: p2, score, length and overflow exactly
     equal; then the full DP (chain_dp, linear_tpu's batch_chain_dp)
     through its entry point on the (256, 512) corpus rows, the (256, 8192)
     long + corpus rows, the dense rows and the corpus rows shuffled out of
     order: every column exactly equal to its plain version on the card,
     and on every row the windowed kernel does not flag equal to the
     windowed tables on [:n]; the windowed DP at W 1, 33 and 128 on the
     (256, 512) corpus rows, and the full DP at N 12,288 and 20,480 (its
     tables in the device scratch) on two long-read rows, one chain of N
     anchors and a shuffled row, each exactly equal to its plain version;
     the (256, 8192), (4, 12,288) and (4, 20,480) full DP launches with the
     card's busy time beside their CUDA-event times;
  8. the main paths, `python -m linear_tpu_torch filter reads genome -t
     <ncpu> -ot 2` as subprocesses:
       -b 1 in turns with --device cuda, host, host, cuda: all SAM files
       byte-identical; each cuda run reports seed kernel launches > 0, as
       many superchunks as launches, seeded reads > 0, every seeded read
       mapped with its device seeds, and every eligible read either seeded
       or left to the host for a stated reason (N bases, or an overflow of
       m_out 512);
       -b 0 with --device cuda and host: byte-identical SAM; extension
       kernel launches > 0, extended reads > 0, and every eligible read
       either extended or counted under one host re-map reason;
       -b 1 on the N-free genome with --device cuda and host:
       byte-identical SAM, and the index built on the card;
       the Python engine (LINEAR_TPU_ENGINE=py), -b 1 on the first
       PY_B1_READS reads and -b 0 on the first PY_B0_READS, with --device
       cuda and host, and -a 1 -b 0 on the first ALN_READS: byte-identical
       SAM, the Python-engine runs also equal to the native engine's SAM on
       the same reads; each cuda run reports chain kernel launches > 0,
       reads chained on the card > 0, and every seeded read either chained
       or counted under one host-DP reason;
  9. the padded seeding kernels and the multi-process mesh path:
       (a) the scan seeding kernel against its plain version on the card at
       (MESH_B, MESH_PAD, the index's cap), on corpus reads with every read
       with N, on 60-120 kb reads from the genome cut to the pad (no
       corpus read is longer than the pad), and on hand-built reads dense
       with N (n_dense_rows); the compaction
       kernel on that grid at m_out 1024 and 8192, and on hand-built rows
       (every slot kept, counts m_out - 1, m_out and m_out + 1 whose
       m_out-th kept slot sits on a chunk edge, a keep view whose rows
       start off a 16-byte boundary), against its plain version and a
       torch.sort(stable=True) compaction; the closed-form
       kernel on N-free corpus reads, whole and in MESH_SHARDS xval shards
       whose sum must be the whole grid; all exact;
       (a') seed_anchors_batch (scan, then compaction, m_out 8192) on every
       read with N and MESH_B N-free reads: each read gives exactly the
       host seeds of query_anchors or is declared an overflow; the launches
       of both kernels are counted on this run;
       (a'') the anchor sort kernel (sort_anchors: the mapping steps' stable
       sort by descending anchor-x) against its plain version on the card,
       at n_max 256 and 8192, on the scan grid of the corpus reads with N,
       on the closed-form grid of N-free reads, and on hand-built rows of
       the same width (more kept than n_max, every slot kept with few
       distinct anchor-x, nothing kept, exactly n_max kept, one under, at
       and one over the 1,024 items a row sorts in registers and the 8,192
       of a shared-memory tile): every column and count exactly equal;
       torch.sort(stable=True) + gather timed beside it as the library
       call, the card's busy time beside the CUDA-event
       time;
       (b) mapping_step with either seeder at (MESH_B, MESH_PAD), n_max
       256 (the sort kernel inside), against the same step built from the
       plain versions on the card: all six outputs equal;
       (c) two spawned ranks on the card with gloo (`python -m
       linear_tpu_torch.parallel.e2e`): the grid mapping step at (dp, ix)
       = (2, 1) and (1, 2) equal to one process's mapping_step(fast=True),
       and map->SAM of the whole corpus at pad 8192 byte-identical to one
       process's host-seeded run; the ranks' closed-form launches there are
       that kernel's main-path count, and the ranks' anchor sort launches
       in the grid steps the sort kernel's;
 10. the banded alignment and the gap anchors, through their entry points
     (no CLI path runs either kernel, as in linear_tpu):
       (a) banded_align_scores on the band regions that -a 1's align_cords
       would align for the first BANDED_READS corpus reads (the Python
       engine's cords, mapped on the host; align_regions cuts them), at W
       = 100 (the -a path's band), 128 (JAX's default) and 600 (five
       warps a pair, one barrier a row): each launch
       exactly equal to its plain version on the card, and the scores of
       the first ALN_ORACLE_READS reads' regions equal to the host traceback's
       (banded_align_cigar_fast); then the kernel's wide branch: the first
       BANDED_WIDE_PAIRS regions cut to 1,000 bases at W = 16,385 (past the
       register design), and four of them in rows of L = 2^25, each exactly
       equal to its plain version on the card;
       (b) batch_gap_anchors on GAP_ITEMS items cut from the corpus genome
       (gap_items), some over the cap or over the window limits: count,
       overflow, anchors and keys up to min(count, m_out) exactly equal to
       the plain version on the card, each item's result equal to the
       kernel's, and the first GAP_ORACLE_ITEMS items without overflow
       equal to the host oracle (map.gap's 9-mer streams and
       g_create_anchors); the card's busy time beside the CUDA-event time;
       (b') gap_anchors past its kernel's shared tables (g_max 1,025, r_max
       4,097) and on windows near 2^30, GAP_EDGE_ITEMS items each, against
       the plain version on the card (check_gap_edges);
 11. the other configurations of the CLI, each `filter ... --device cuda`
     against `--device host` as subprocesses, every output file
     byte-identical: -b 1 -ot 15 on the whole corpus (.sam, .apf, .bam,
     _pbsv.bam; the cuda run seeds on the card, counted as in phase 8);
     -i 2 (HIndex, native engine) on the whole corpus; -i 3 (SIndex), -f 0
     and -f 1 (1_16 and 1_32 features) on the first OTHER_READS reads (the
     Python engine); --save-index, then --load-index of that file with
     -i 1, whose SAM must be phase 8's. With -i 2/3 and -f 0/1 the device
     does no work (as in linear_tpu), the cuda run must say so, and the
     cuda and host runs of each go side by side;
 12. the rest of linear_tpu's surface: Mapper.warmup() on the card (its
     time, and the seed and chain DP launches it makes), then
     Mapper._device_seed_block on the first BLOCK_READS corpus reads,
     every entry equal to a --device cpu Mapper's (the plain version) and
     None at the same reads, its seed kernel launches counted; then
     `python -m linear_tpu_torch.tools.profile_stages 1024 --json` (its
     JSON line printed) and `... tools.bench_devbuild 46.7`, whose device
     DIndex build must equal the host build, each in a process of its own.
The card's busy time of each kernel call that a phase times (the
"device_ms" of each shape: at least one a kernel) is measured after phase
12 in one fresh process (Busy, `kernel_times --busy`), with each traced
event's count logged beside the launches its window made. Every kernel's
entry carries its bound (common.bound(): bytes over the HBM rate or
operations over the scalar rate, counted from this run's inputs) and, for
the compaction and the anchor sort, the stable sort's time as library_ms.
It prints the kernels as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA device, or without the rest
of the repository beside it, it exits 1 before printing any result.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

try:
    from linear_tpu_torch.tools import common
    from linear_tpu_torch.tools.common import bound, n_calls, seed_bound
except ImportError as e:  # not beside the rest of the repository
    print(f"chip_smoke: linear_tpu_torch is not importable: {e}",
          file=sys.stderr)
    sys.exit(1)

ROOT = os.path.dirname(os.path.abspath(__file__))
N_READS = common.N_READS
SEED = common.SEED
# (rows, pad, m_out): the two tiers of Mapper._device_seed_stream2 at the
# corpus' pad, and the longest reads the device seeds
# and JAX's default m_out, 8,192, past the 4,096 slots the kernel keeps in
# shared memory (the rest in its device scratch), on reads of 200-262 kb:
# a 131 kb read probes ~3,300 slots on this genome
SHAPES = [(1024, 8192, 128), (256, 8192, 512), (64, 131072, 512),
          (32, 262144, 8192)]
# the extension check: a full batch of Mapper._device_extend_block at the
# corpus' pad (C = H + pad / 32), and a cut C that makes rows overflow
EXT_B, EXT_PAD, EXT_H = 1024, 8192, 256
EXT_CS = [EXT_H + EXT_PAD // 32, 100]
# and one launch at the pad of the longest reads the path batches (one read
# a batch from 2^17 bases), whose reads keep their feature rows in the
# device scratch rather than in shared memory: EXT_LONG_B reads of 20-131 kb
EXT_LONG_PAD, EXT_LONG_B = 131072, 64
# operations of the extension's work: a 16-base chunk of a read strand sums
# 16 2-mer addends (~4 operations each) once, a feature row adds its three
# chunks' three words (6), a six-bit lane distance takes ~6
EXT_OPS_CHUNK, EXT_OPS_ROW, EXT_OPS_LANE = 4 * 16, 6, 6
# the chain DP check: rows a launch (Mapper.DEV_BATCH); its widths are 64
# and 512, which the path runs on this corpus, and 8192, the widest
CHAIN_B = 256
# the windowed DP at other lookbacks on the (256, 512) corpus rows, and the
# full DP past the 11,622 anchors a row that its first design kept in a
# block's shared memory, and past the 18,944 of its redesign (the tables in
# the device scratch)
CHAIN_WS = (1, 33, 128)
FULL_WIDE_NS = (12288, 20480)
# the Python-engine runs take the first reads of the corpus (on 8 cores the
# engine maps some 470 reads/s at -b 1 and 65 at -b 0, and -a 1 about 5):
# the genome stays whole
PY_B1_READS, PY_B0_READS, ALN_READS = 2048, 256, 24
# phase 12: the reads Mapper._device_seed_block seeds on the card and on the
# CPU (the plain version)
BLOCK_READS = 2048
# phase 11's Python-engine configurations (-i 3, -f 0, -f 1)
OTHER_READS = 512
# phase 9: the padded seeding kernels at (rows, pad) with the index's cap,
# the compaction's m_out tiers, and seed_anchors_batch's m_out
MESH_B, MESH_PAD = 256, 8192
COMPACT_M_OUTS = (1024, 8192)
# the anchor sort's n_max: chip_smoke's mapping steps take 256; 8192 is the
# chain DP's widest launch
SORT_N_MAXES = (256, 8192)
BATCH_M_OUT = 8192
MESH_SHARDS = 4
# phase 10: the band regions that -a 1 would align for the first
# BANDED_READS corpus reads, at the -a path's band and at JAX's default, the
# first ALN_ORACLE_READS reads' regions held against the host traceback;
# GAP_ITEMS gap-interval items cut from the corpus genome, the first
# GAP_ORACLE_ITEMS without overflow held against the host oracle
# (W 600: 1,200 diagonals, past the 256 of one warp a pair, so five warps
# take a pair); GAP_EDGE_ITEMS items at each shape past the gap kernel's shared
# tables, and near 2^30
BANDED_READS, ALN_BAND, BANDED_WS = 512, 100, (100, 128, 600)
# the banded kernel's wide branch: W past the register design's 16,384 on
# the first regions cut to 1,000 bases, and rows of 2^25 bases
BANDED_WIDE_W, BANDED_WIDE_PAIRS = 16385, 16
GAP_EDGE_ITEMS = 16
GAP_EDGE_LIMITS = ((1025, 4096, False), (1024, 4097, False),
                   (1024, 4096, True))
ALN_ORACLE_READS = 48
GAP_ITEMS, GAP_ORACLE_ITEMS = 512, 32
# the launches of the last three kernels are those of their own entry
# points: no CLI path runs them, as no path of linear_tpu runs its
ENTRY_ONLY = "entry point only: no CLI path runs it, as in linear_tpu"


def log(msg: str) -> None:
    print(msg, flush=True)


def mutate(rng, seg):
    """~10 % substitutions (no indels: the wire shapes stay exact)."""
    out = seg.copy()
    sub = rng.random(len(out)) < 0.10
    out[sub] = (out[sub] + 1) % 4
    return out


def check_reads(rng, genome, n, pad, lo, hi, specials):
    """n reads from the genome for one kernel check: lengths in [lo, hi]
    plus `specials`, some reverse-complemented, some with an N."""
    from linear_tpu_torch.utils import seqio

    lens = list(specials) + [int(x) for x in rng.integers(lo, hi + 1,
                                                          n - len(specials))]
    reads = []
    for i, ln in enumerate(lens):
        ln = min(ln, pad)
        while True:
            pos = int(rng.integers(0, len(genome) - ln))
            seg = genome[pos: pos + ln]
            if not (seg == 4).any():
                break
        r = mutate(rng, seg)
        if i % 3 == 2:
            r = seqio.revcomp(r)
        if i % 17 == 5:
            r[len(r) // 2] = 4
        reads.append(r)
    return reads


def edge_reads(genome):
    """Exact reads for the first call position: 21 T then 40 A give a
    forward p = 0 window with an all-A minimizer (xval 0, the dedup's
    initial value); homopolymer starts tie all nine candidates."""
    from linear_tpu_torch.utils import seqio

    tail = genome[1_000_000:1_003_000]
    runs = [np.concatenate([np.full(21, 3, np.uint8), np.zeros(40, np.uint8)]),
            np.zeros(90, np.uint8), np.full(90, 2, np.uint8)]
    reads = [np.concatenate([r, tail]) for r in runs]
    return reads + [seqio.revcomp(reads[1])]


def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Busy:
    """The card's busy time of kernel calls, measured after the checks in a
    fresh process (`python -m linear_tpu_torch.kernel_times --busy`, which
    times each call with kernel_times.device_ms): torch.profiler in this
    long process at times delivers no device event for a window (on the
    H100, in more than half of a whole run's windows), while a fresh
    process traces every launch. add() keeps a call's inputs in host
    memory (each tensor once) with the record whose "device_ms" the
    measurement fills: the sum of the busy times of every call added for
    it, None when one of them traced nothing."""

    def __init__(self):
        self.jobs, self.records, self._host = [], [], {}

    def add(self, record: dict, fn: str, args, iters: int, counter: str,
            **kw) -> dict:
        """fn and counter: "module:name" under linear_tpu_torch of the
        entry point and of its launch count."""
        self.jobs.append(("linear_tpu_torch." + fn, self._to_host(args),
                          self._to_host(kw), iters,
                          "linear_tpu_torch." + counter))
        self.records.append(record)
        record["device_ms"] = None
        return record

    def _to_host(self, obj):
        import dataclasses

        import torch

        if isinstance(obj, torch.Tensor):
            if id(obj) not in self._host:
                self._host[id(obj)] = (obj, obj.cpu())
            return self._host[id(obj)][1]
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._to_host(o) for o in obj)
        if isinstance(obj, dict):
            return {k: self._to_host(v) for k, v in obj.items()}
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{
                f.name: self._to_host(getattr(obj, f.name))
                for f in dataclasses.fields(obj)})
        return obj

    def measure(self, d: str) -> None:
        """Time every queued call in one fresh process; fill the records and
        log each call's traced device events beside the launches the window
        made."""
        import torch

        path = os.path.join(d, "busy_jobs.pt")
        torch.save(self.jobs, path)
        self._host.clear()
        res = subprocess.run(
            [sys.executable, "-m", "linear_tpu_torch.kernel_times", "--busy",
             path], cwd=ROOT, capture_output=True, text=True, timeout=900)
        os.remove(path)
        if res.returncode:
            raise AssertionError("the busy-time process failed: "
                                 + res.stderr[-3000:])
        self.fill(json.loads(res.stdout.strip().splitlines()[-1]))

    def fill(self, out: list) -> None:
        """The busy process's result (one entry a job, in order) into the
        records, logged; the queue starts empty again."""
        for rec in self.records:
            rec["device_ms"] = 0.0
        for (fn, _, _, iters, _), rec, r in zip(self.jobs, self.records, out):
            log(f"busy {fn.split('.')[-1]} {rec.get('shape', '')}: "
                f"{_ms(r['device_ms'])} ms a call")
            for k, w in enumerate(r["windows"]):
                log(f"  device events traced over {iters} calls (kernel "
                    f"launches {w['launches']}), window {k + 1}: " + (", ".join(
                        f"{e} {n}" for e, n in w["events"].items())
                        or "none"))
            if rec["device_ms"] is not None:
                rec["device_ms"] = (None if r["device_ms"] is None
                                    else rec["device_ms"] + r["device_ms"])
        self.jobs, self.records = [], []


BUSY = Busy()


def _ms(x) -> str:
    return "not traced" if x is None else f"{x:.4f}"


def time_once(fn):
    """(fn(), its ms by CUDA events): one call, for a plain version too slow
    to repeat."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_kernel(index, genome, rng):
    """Phase 4: kernel vs plain version at SHAPES; returns the numbers of
    the main shape and prints every shape's."""
    import torch

    from linear_tpu_torch.ops import seeding as SD

    results = []
    for rows, pad, m_out in SHAPES:
        if pad == 131072:
            reads = check_reads(rng, genome, rows, pad, 100_000, 131_000,
                                [pad, 131_000])
        elif pad > 131072:
            reads = check_reads(rng, genome, rows, pad, 200_000, 262_000,
                                [pad, 262_000])
        else:
            # a few padding rows at the end of the superchunk
            reads = check_reads(rng, genome, rows - 3, pad, 202, pad,
                                [201, 1024, pad])
        if m_out == 128:
            reads[-4:] = edge_reads(genome)
        wire, n_mask = SD.pack_superchunk(reads, pad, rows)
        w = torch.from_numpy(wire).cuda()
        got = SD.seed_superchunk(w, index, m_out)
        want = SD.seed_superchunk_reference(w, index.dir_start, index.hs,
                                            index.cap, m_out)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        count = want[:, -1] & 0xFFFFFFFF
        probed = want[:, -1] >> 32
        defined = np.arange(m_out)[None, :] < count[:, None]
        bad_tail = int((got[:, -1] != want[:, -1]).sum())
        bad = np.flatnonzero(((got[:, :-1] != want[:, :-1]) & defined).ravel())
        max_abs_err = max([abs(int(got[:, :-1].ravel()[i])
                               - int(want[:, :-1].ravel()[i])) for i in bad]
                          + [abs(int(a) - int(b)) for a, b in
                             zip(got[:, -1], want[:, -1]) if a != b] + [0])
        n_over = int((probed > m_out).sum())
        ms = time_ms(lambda: SD.seed_superchunk(w, index, m_out), 20)
        plain_ms = time_ms(lambda: SD.seed_superchunk_reference(
            w, index.dir_start, index.hs, index.cap, m_out), 5)
        log(f"kernel check rows={rows} pad={pad} m_out={m_out}: "
            f"defined entries {int(defined.sum())}, mismatches {len(bad)}, "
            f"tail mismatches {bad_tail}, N rows {int(n_mask[:len(reads)].sum())}, "
            f"overflow rows {n_over}, max probed {int(probed.max())}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if bad_tail or len(bad):
            raise AssertionError(f"kernel disagrees with the plain version "
                                 f"at {(rows, pad, m_out)}")
        if pad == 8192 and m_out == 128 and n_over == 0:
            raise AssertionError("no overflowing row at the main shape")
        if m_out > 4096 and int(probed.max()) <= 4096:
            raise AssertionError("no row of the m_out 8192 launch passes "
                                 "the kernel's 4,096 shared-memory slots")
        # the wire in, the rows out, two dir words a call position and an
        # hs entry a probed slot below m_out; ~150 operations a position
        # (window, nine candidates, YValue), ~20 a slot
        results.append(BUSY.add(
            {"shape": [rows, pad, m_out], "ms": ms, "plain_ms": plain_ms,
             "max_abs_err": max_abs_err,
             **seed_bound(wire.nbytes, rows, m_out,
                          [min(len(r), pad) for r in reads], probed)},
            "ops.seeding:seed_superchunk", (w, index, m_out), 20,
            "ops.seeding:launches"))
    return results


def make_nfree(d, genome):
    """The corpus genome with every N replaced by a base drawn from
    numpy.random.default_rng(43): the card builds its index."""
    from linear_tpu_torch.utils import seqio

    g = genome.copy()
    n = g == 4
    g[n] = np.random.default_rng(43).integers(0, 4, int(n.sum()))
    fa = os.path.join(d, "genome_nfree.fa")
    if not os.path.exists(fa):
        seqio.write_fasta(fa + ".tmp", ["U00096.3 synthetic, N-free"], [g])
        os.replace(fa + ".tmp", fa)
    return g, fa


def _max_abs_err(got, want) -> int:
    """Largest |got - want| over arrays of integers (0 when equal)."""
    err = 0
    for a, b in zip(got, want):
        a = np.asarray(a).astype(np.int64).ravel()
        b = np.asarray(b).astype(np.int64).ravel()
        if a.shape != b.shape:
            raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
        bad = np.flatnonzero(a != b)
        err = max([err] + [abs(int(a[i]) - int(b[i])) for i in bad[:1000]])
    return err


def _extend_launch(ED, m, reads, hits, pad, C, tag):
    """One extension launch of these reads and hits against the plain
    version on the card: its numbers, the bound counted from the work the
    plain version reports (count_work) for these inputs."""
    import torch

    B = len(reads)
    packed, lens = ED.pack_rows(reads, pad)
    hm = np.zeros((B, EXT_H), dtype=np.uint64)
    hn = np.zeros((B,), dtype=np.int32)
    for k, h in enumerate(hits):
        hm[k, : len(h)] = h
        hn[k] = len(h)
    args = [torch.from_numpy(a).cuda()
            for a in (packed, lens, hm.view(np.int64), hn)]
    gf = ED.upload_genome_feats([f.arr for f in m.f2], "cuda")
    R = ED.feature_rows(pad)
    got = ED.filter_extend(*args, gf, C)
    *want, work = ED.filter_extend_reference(*args, gf, C, R, count_work=True)
    torch.cuda.synchronize()
    got = [t.cpu().numpy() for t in got]
    want = [t.cpu().numpy() for t in want]
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    err = _max_abs_err(got, want)
    n_ovf = int(want[2].sum())
    n_ext = int((want[1] > 1).sum())
    ms = time_ms(lambda: ED.filter_extend(*args, gf, C), 10)
    plain_ms = time_ms(lambda: ED.filter_extend_reference(
        *args, gf, C, R), 1)
    log(f"extension check{tag} (B, pad, H, C, R) = {(B, pad, EXT_H, C, R)}: "
        f"rows with cords {n_ext}, overflow rows {n_ovf}, cords "
        f"{int(want[1].sum())}, equal {same}, max_abs_err {err}; work "
        f"{json.dumps(work)}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not same:
        raise AssertionError(f"extension kernel disagrees with the plain "
                             f"version at {(B, pad, C)}")
    # reads and hits in, the distinct genome feature rows read (12 bytes
    # each), cords out; the read strands' chunks and feature rows and the
    # window evaluations' lane distances as operations
    return BUSY.add(
        {"shape": [B, pad, EXT_H, C, R], "ms": ms, "plain_ms": plain_ms,
         "max_abs_err": err, "overflow_rows": n_ovf,
         "extended_rows": n_ext, "work": work,
         **bound(sum(a.nbytes for a in (packed, lens, hm, hn))
                 + 12 * work["genome_rows"] + B * (C * 8 + 4 + 1),
                 EXT_OPS_CHUNK * work["read_chunks"]
                 + EXT_OPS_ROW * work["read_rows"]
                 + EXT_OPS_LANE * work["lane_distances"])},
        "ops.extend_dev:filter_extend", (*args, gf, C), 10,
        "ops.extend_dev:launches")


def check_extend(g_fa, r_fa, genome, threads, rng):
    """Phase 5: the extension kernel vs its plain version at (EXT_B,
    EXT_PAD, EXT_H, C, R) for each C of EXT_CS, on corpus reads seeded on
    the card as in the run, and at EXT_LONG_PAD on long reads cut from the
    genome (their feature rows in the device scratch)."""
    from linear_tpu_torch.map.mapper import Mapper, MapperConfig
    from linear_tpu_torch.ops import _cuda
    from linear_tpu_torch.ops import extend_dev as ED
    from linear_tpu_torch.utils import seqio

    m = Mapper([g_fa], MapperConfig(threads=threads, bal_flag=0),
               device="cuda")
    m.prepare()
    m._ensure_dev_index()
    block = next(seqio.read_blocks(r_fa))
    cand = [r for r in block.seqs
            if 200 < len(r) <= EXT_PAD and not (r == 4).any()][: 2 * EXT_B]
    seeds = [None] * len(cand)
    for _, idxs, anchors in m._device_seed_stream2([(0, cand)]):
        for i, a in zip(idxs, anchors):
            seeds[i] = a
    ne = m.native_engine()
    reads, hits = [], []
    for r, s in zip(cand, seeds):
        h = ne.apx_hits(r, s)
        if len(h) <= EXT_H:
            reads.append(r)
            hits.append(h)
        if len(reads) == EXT_B:
            break
    results = []
    for C in EXT_CS:
        res = _extend_launch(ED, m, reads, hits, EXT_PAD, C, "")
        if C == EXT_CS[0] and (res["overflow_rows"]
                               or res["extended_rows"] < EXT_B // 2):
            raise AssertionError("the main shape should extend most rows "
                                 "without overflow")
        if C == EXT_CS[-1] and not 0 < res["overflow_rows"] < EXT_B:
            raise AssertionError("the cut C should make some rows overflow")
        results.append(res)
    # long reads: exact segments of the genome without N, 20-131 kb, with
    # the hits of the native first pass (host seeds)
    reads, hits = [], []
    while len(reads) < EXT_LONG_B:
        ln = int(rng.integers(20_000, EXT_LONG_PAD - 1000))
        p = int(rng.integers(0, len(genome) - ln))
        r = genome[p: p + ln]
        if (r == 4).any():
            continue
        r = mutate(rng, r)
        h = ne.apx_hits(r)
        if 2 < len(h) <= EXT_H:
            reads.append(r)
            hits.append(h)
    n1 = min(1 + ((len(r) - 50) >> 4) for r in reads)  # n_scripts_serial
    if n1 <= _cuda.EXT_SMEM_ROWS:
        raise AssertionError("the long reads should take the device scratch")
    res = _extend_launch(ED, m, reads, hits, EXT_LONG_PAD,
                         EXT_H + EXT_LONG_PAD // 32, " (device-scratch rows)")
    if res["overflow_rows"]:
        raise AssertionError("the long reads should not overflow")
    results.append(res)
    return results


def check_devbuild(g, threads):
    """Phase 6: the DIndex built on the card vs the host build, and its
    kernels vs their plain versions on the card."""
    import torch

    from linear_tpu_torch.index import dindex as DI
    from linear_tpu_torch.ops import devbuild as DB
    from linear_tpu_torch.ops import seeding as SD

    t0 = time.time()
    host = DI.build_dindex([g], threads)
    t_host = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    up = SD.upload_index(host.dir, host.hs, "cuda")
    torch.cuda.synchronize()
    t_up = time.time() - t0
    del up
    t0 = time.time()
    dirp, hs, largest = DB.build_dindex_device([g], "cuda", threads)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    idx = DB.device_build_to_index(dirp, hs, largest)
    if not (np.array_equal(dirp.cpu().numpy(), host.dir)
            and np.array_equal(hs.cpu().numpy().view(np.uint64), host.hs)):
        raise AssertionError("the DIndex built on the card differs from the "
                             "host build")
    cap_host = SD.bucket_cap(int(np.diff(host.dir).max()))
    if idx.cap != cap_host:
        raise AssertionError(f"cap {idx.cap} != host cap {cap_host}")
    del idx, dirp, hs

    j, bs = DB._samples(len(g), threads)
    gt = torch.from_numpy(g).cuda()
    jt = torch.from_numpy(j).cuda()
    bst = torch.from_numpy(bs).cuda()
    gid = torch.zeros_like(jt)

    def kernel():
        xv, yv, st = DB.sample_states(gt, jt)
        return (xv, yv, st), DB.emit_count_sort(xv, yv, st, jt, gid, bst)

    def plain():
        xv, yv, st = SD.minimizer_xy_at(gt, jt)
        return (xv, yv, st), DB.emit_count_sort_reference(xv, yv, st, jt,
                                                          gid, bst)

    (ks, (kd, kh, kl)), (ps, (pd, ph, pl)) = kernel(), plain()
    got = [t.cpu().numpy() for t in (*ks, kd, kh)] + [kl]
    want = [t.cpu().numpy() for t in (*ps, pd, ph)] + [pl]
    err = _max_abs_err(got, want)
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    ms = time_ms(kernel, 5)
    plain_ms = time_ms(plain, 2)
    log(f"devbuild check: genome {len(g)} b, {len(j)} samples, hs "
        f"{len(host.hs)} entries, cap {cap_host}; equal to the host build; "
        f"kernels vs plain equal {same}, max_abs_err {err}; kernels {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms; whole build on "
        f"the card {t_build:.4f} "
        f"s vs host build {t_host:.4f} s + upload {t_up:.4f} s")
    if not same:
        raise AssertionError("devbuild kernels disagree with the plain version")
    torch.cuda.empty_cache()
    # the genome and the sample positions in, dir and hs out; ~150
    # operations a sample (window, nine candidates, YValue)
    n_dir = 4 ** 13 + 1
    rec = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           "build_s": t_build, "upload_s": t_up, "host_build_s": t_host,
           **bound(g.nbytes + j.nbytes + bs.nbytes + 4 * n_dir
                   + 8 * len(host.hs), 150 * len(j))}
    # the busy time of both build kernels: the states, then the sort
    BUSY.add(rec, "ops.devbuild:sample_states", (gt, jt), 5,
             "ops.devbuild:launches")
    return BUSY.add(rec, "ops.devbuild:emit_count_sort",
                    (*ks, jt, gid, bst), 5, "ops.devbuild:launches")


def check_chain_dp(g_fa, r_fa, genome, threads, rng):
    """Phase 7: the chain DP kernel vs its plain version at (CHAIN_B, N)
    for N = 64, 512 and 8192, and on a launch of dense rows that
    overflow."""
    import torch

    from linear_tpu_torch.map.mapper import Mapper, MapperConfig, chain_prepass
    from linear_tpu_torch.ops import chain_dp as CD
    from linear_tpu_torch.utils import seqio
    from linear_tpu_torch.utils.cordscalar import anchor_x

    m = Mapper([g_fa], MapperConfig(threads=threads), device="cuda")
    m.prepare()
    block = next(seqio.read_blocks(r_fa))
    seeds = []
    for _, _, anchors in m._device_seed_stream2([(0, block.seqs)]):
        seeds += [a for a in anchors if a is not None]
    rows = [r for r in map(chain_prepass, seeds) if len(r) >= 2]
    long_rows = []
    for r in check_reads(rng, genome, 48, 131072, 60_000, 120_000, []):
        if not (r == 4).any():
            a = chain_prepass(host_seeds(m.index, r))
            if 512 < len(a) <= 8192:
                long_rows.append(a)
    launches = {64: [r[:64] for r in rows[:CHAIN_B]],
                512: [r for r in rows if 64 < len(r) <= 512][:CHAIN_B],
                8192: (long_rows + rows)[:CHAIN_B]}
    dense = []
    for b in range(CHAIN_B):
        n = int(rng.integers(2, 513))
        ys = np.sort(rng.integers(0, max(4, n * (3 if b % 2 else 40)), n))
        anc = [(((123000 + int(rng.integers(-150, 150)) + (1 << 20)) << 20)
                + int(y) + (int(rng.integers(0, 2)) << 61)) for y in ys]
        dense.append(sorted(anc, key=anchor_x, reverse=True))
    def on_card(rs, N):
        arr = np.zeros((len(rs), N), dtype=np.uint64)
        cnt = np.zeros((len(rs),), dtype=np.int32)
        for k, r in enumerate(rs):
            arr[k, : len(r)] = r
            cnt[k] = len(r)
        return arr, cnt, torch.from_numpy(arr.view(np.int64)).cuda(), \
            torch.from_numpy(cnt).cuda()

    results, windowed = [], {}
    for (N, rs), kind in zip(list(launches.items()) + [(512, dense)],
                             ("corpus", "corpus", "long + corpus", "dense")):
        arr, cnt, a, c = on_card(rs, N)
        got = [t.cpu().numpy() for t in CD.chain_dp_windowed(a, c)]
        windowed[kind, N] = (a, c, got)
        want = [t.cpu().numpy() for t in CD.chain_dp_windowed_reference(a, c)]
        err = _max_abs_err(got, want)
        same = all(np.array_equal(x.astype(np.int64), y.astype(np.int64))
                   for x, y in zip(got, want))
        n_ovf = int(want[3].sum())
        ms = time_ms(lambda: CD.chain_dp_windowed(a, c), 10)
        plain_ms = time_ms(lambda: CD.chain_dp_windowed_reference(a, c), 1)
        log(f"chain DP check (B, N) = {(len(rs), N)}, {kind} rows: anchors "
            f"{int(cnt.sum())} (longest {int(cnt.max())}), chained anchors "
            f"{int((want[0] >= 0).sum())}, overflow rows {n_ovf}, equal "
            f"{same}, max_abs_err {err}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        if not same:
            raise AssertionError(f"chain DP kernel disagrees with the plain "
                                 f"version at N = {N} ({kind} rows)")
        if len(rs) != CHAIN_B or (N == 8192 and int(cnt.max()) <= 512):
            raise AssertionError(f"the {kind} launch at N = {N} is not full")
        if kind == "dense" and not 0 < n_ovf < CHAIN_B:
            raise AssertionError("the dense launch should overflow some rows")
        # anchors in, three int32 tables out; each anchor scores up to 64
        # earlier ones, ~40 integer operations an edge (getApxChainScore
        # with its truncating divisions)
        edges = sum(int(np.minimum(np.arange(c), 64).sum()) for c in cnt)
        results.append(BUSY.add(
            {"shape": [len(rs), N], "rows": kind, "ms": ms,
             "plain_ms": plain_ms, "max_abs_err": err, "overflow_rows": n_ovf,
             **bound(arr.nbytes + cnt.nbytes + len(rs) * (12 * N + 1),
                     40 * edges)},
            "ops.chain_dp:chain_dp_windowed", (a, c), 10,
            "ops.chain_dp:launches"))

    # any W: the (256, 512) corpus rows at W 1, 33 and 128 (a lane takes
    # one, two and four lookbacks; 64 is the Mapper's, above)
    a, c, _ = windowed["corpus", 512]
    cnt = c.cpu().numpy()
    for W in CHAIN_WS:
        got = [t.cpu().numpy() for t in CD.chain_dp_windowed(a, c, W=W)]
        want = [t.cpu().numpy() for t in CD.chain_dp_windowed_reference(
            a, c, W=W)]
        err = _max_abs_err(got, want)
        same = all(np.array_equal(x.astype(np.int64), y.astype(np.int64))
                   for x, y in zip(got, want))
        ms = time_ms(lambda: CD.chain_dp_windowed(a, c, W=W), 10)
        plain_ms = time_ms(lambda: CD.chain_dp_windowed_reference(a, c, W=W),
                           1)
        log(f"chain DP check (B, N, W) = {(CHAIN_B, 512, W)}, corpus rows: "
            f"chained anchors {int((want[0] >= 0).sum())}, overflow rows "
            f"{int(want[3].sum())}, equal {same}, max_abs_err {err}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not same:
            raise AssertionError(f"chain DP kernel disagrees with the plain "
                                 f"version at W = {W}")
        edges = sum(int(np.minimum(np.arange(n), W).sum()) for n in cnt)
        results.append({"shape": [CHAIN_B, 512], "W": W, "rows": "corpus",
                        "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                        **bound(a.numel() * 8 + c.numel() * 4
                                + CHAIN_B * (12 * 512 + 1), 40 * edges)})

    # the full DP (linear_tpu's batch_chain_dp) through its entry point on
    # the same rows, and on the corpus rows shuffled out of order (JAX's
    # mask, not the C++ loop's break, decides there)
    shuffled = [[r[k] for k in rng.permutation(len(r))] for r in launches[512]]
    full_in = [(kind, N, *windowed[kind, N]) for kind, N in (
        ("corpus", 512), ("long + corpus", 8192), ("dense", 512))]
    full_in.append(("corpus, shuffled", 512, *on_card(shuffled, 512)[2:], None))
    CD.full_launches = 0
    full_out = [CD.chain_dp(a, c) for _, _, a, c, _ in full_in]
    torch.cuda.synchronize()
    full_launches = CD.full_launches
    full = []
    for (kind, N, a, c, win), got in zip(full_in, full_out):
        want, plain_ms = time_once(lambda: CD.chain_dp_reference(a, c))
        got = [t.cpu().numpy() for t in got]
        want = [t.cpu().numpy() for t in want]
        err = _max_abs_err(got, want)
        same = all(np.array_equal(x, y) for x, y in zip(got, want))
        cnt = c.cpu().numpy()
        n_win = n_win_same = 0
        if win is not None:  # rows the windowed kernel does not flag
            for b in np.flatnonzero(win[3] == 0):
                n = cnt[b]
                n_win += 1
                n_win_same += all(np.array_equal(x[b, :n], y[b, :n])
                                  for x, y in zip(got, win[:3]))
        ms = time_ms(lambda: CD.chain_dp(a, c), 3 if N > 512 else 10)
        edges = full_dp_edges(a, c)
        log(f"full chain DP check (B, N) = {tuple(a.shape)}, {kind} rows: "
            f"chained columns {int((want[0] >= 0).sum())}, admitted edges "
            f"{edges}, equal to the plain version on every column {same}, "
            f"max_abs_err {err}; equal to the windowed kernel on [:n] of "
            f"{n_win_same} of {n_win} rows it does not flag; kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms")
        if not same:
            raise AssertionError(f"the full chain DP kernel disagrees with "
                                 f"the plain version ({kind} rows)")
        if n_win_same != n_win or (win is not None and not n_win):
            raise AssertionError(f"the full DP differs from the windowed "
                                 f"kernel on rows without overflow ({kind})")
        # anchors in, three int32 tables out; ~40 integer operations an
        # admitted edge (getApxChainScore and the compare), every column
        full.append({"shape": list(a.shape), "rows": kind, "ms": ms,
                     "device_ms": None, "plain_ms": plain_ms,
                     "max_abs_err": err,
                     **bound(a.numel() * 8 + c.numel() * 4 + 12 * a.numel(),
                             40 * edges)})
        if N > 512:
            BUSY.add(full[-1], "ops.chain_dp:chain_dp", (a, c), 3,
                     "ops.chain_dp:full_launches")
    # the rows at N 12,288 (past the 11,622 anchors a row that the first
    # design kept in shared memory) and 20,480 (past the 18,944 of the
    # redesign: its scratch branch): two long-read rows and two hand-built
    # ones, one of them a single chain over all its columns, one shuffled
    for N in FULL_WIDE_NS:
        chain = [((600000 - 20 * k - (900000 - 20 * k) + (1 << 20)) << 20)
                 + 900000 - 20 * k for k in range(N)]
        wide_rows = (long_rows + rows)[:2] + [
            chain, [chain[k] for k in rng.permutation(3000)]]
        a, c = on_card(wide_rows, N)[2:]
        got = CD.chain_dp(a, c)
        ms = time_ms(lambda: CD.chain_dp(a, c), 3)
        want, plain_ms = time_once(lambda: CD.chain_dp_reference(a, c))
        got = [t.cpu().numpy() for t in got]
        want = [t.cpu().numpy() for t in want]
        err = _max_abs_err(got, want)
        same = all(np.array_equal(x, y) for x, y in zip(got, want))
        edges = full_dp_edges(a, c)
        log(f"full chain DP check (B, N) = {tuple(a.shape)}, long, chain and "
            f"shuffled rows: chained columns {int((want[0] >= 0).sum())}, "
            f"admitted edges {edges}, equal {same}, max_abs_err {err}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not same or want[2][2].max() != N:
            raise AssertionError(f"the full chain DP kernel disagrees with "
                                 f"the plain version at {N:,} anchors a row")
        full.append(BUSY.add(
            {"shape": list(a.shape), "rows": "long, chain, shuffled",
             "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
             **bound(a.numel() * 8 + c.numel() * 4 + 12 * a.numel(),
                     40 * edges)},
            "ops.chain_dp:chain_dp", (a, c), 3, "ops.chain_dp:full_launches"))
    del windowed, full_in, full_out
    torch.cuda.empty_cache()
    return results, full, full_launches


def full_dp_edges(a, c, depth: int = 20, dx_depth: int = 300) -> int:
    """The (j, i) pairs that the full DP's mask admits on these rows (JAX's
    eligibility: j < i, j < n, and j >= i - depth or anchor_x[j] -
    anchor_x[i] < dx_depth), over every column i but the padded ones that
    the kernel copies (anchor-x and y equal to column i - 1's, i - 1 >=
    n + depth: their result is the column before's), counted on the card."""
    import torch

    from linear_tpu_torch.ops.chain_dp import MASK_Y, _anchor_x

    B, N = a.shape
    ax = _anchor_x(a)
    ay = a & MASK_Y
    jj = torch.arange(N, device=a.device)
    n = c[:, None].to(torch.int64)
    valid = jj[None, :] < n
    same = torch.zeros_like(valid)
    same[:, 1:] = (ax[:, 1:] == ax[:, :-1]) & (ay[:, 1:] == ay[:, :-1])
    copied = same & (jj[None, :] - 1 >= n + max(depth, 0))
    total = 0
    for i0 in range(0, N, 64):
        ii = torch.arange(i0, min(i0 + 64, N), device=a.device)
        ok = ((jj[None, :] < ii[:, None])[None] & valid[:, None, :]
              & ((jj[None, :] >= ii[:, None] - depth)[None]
                 | (ax[:, None, :] - ax[:, ii, None] < dx_depth))
              & ~copied[:, ii, None])
        total += int(ok.sum())
    return total


def compact_by_sort(anc, keep, m_out: int):
    """K3's function as one PyTorch stable sort (linear_tpu's own
    formulation): the library yardstick of the compaction, used nowhere in
    the port."""
    import torch

    B = anc.shape[0]
    af = anc.reshape(B, -1)
    kf = keep.reshape(B, -1)
    n = af.shape[1]
    keys = torch.where(kf, torch.arange(n, device=af.device), n)
    order = torch.sort(keys, dim=1, stable=True).indices[:, :m_out]
    count = kf.sum(1).to(torch.int32)
    out = torch.gather(af, 1, order)
    width = out.shape[1]
    out = torch.where(torch.arange(width, device=af.device)[None, :]
                      < count[:, None], out, 0)
    if width < m_out:
        out = torch.nn.functional.pad(out, (0, m_out - width))
    return out, count


def sort_by_library(anc, keep, n_max: int):
    """The anchor sort as one PyTorch stable sort and a gather
    (linear_tpu's own formulation): the library yardstick of the sort
    kernel, used nowhere in the port."""
    import torch

    from linear_tpu_torch.ops import chain_dp as CD

    B = anc.shape[0]
    flat = anc.reshape(B, -1)
    kflat = keep.reshape(B, -1)
    key = torch.where(kflat, -CD._anchor_x(flat), 1 << 62)
    order = torch.sort(key, dim=1, stable=True).indices[:, :n_max]
    return (torch.gather(flat, 1, order),
            kflat.sum(1).clamp(max=n_max).to(torch.int32))


def network_comparators(kept_rows) -> int:
    """Comparators of the sort kernel's bitonic network over rows of these
    kept counts: K / 2 a stage, log2(N) (log2(N) + 1) / 2 stages, N the
    power of two >= K."""
    total = 0
    for k in kept_rows.tolist():
        lg = max(k - 1, 0).bit_length()
        total += lg * (lg + 1) // 2 * (k // 2)
    return total


def hand_sort_rows(rng, n: int, n_max: int):
    """Rows of n slots for the sort kernel: more kept than n_max; every
    slot kept with 64 distinct anchor-x (ties); nothing kept; exactly n_max
    kept; one short of it; one kept slot, the row's last; one under, at and
    one over the 1,024 items a row sorts in registers and the 8,192 of a
    shared-memory tile."""
    import torch

    from linear_tpu_torch.ops import chain_dp as CD

    rows = 12
    anc = ((rng.integers(0, 2, (rows, n)) << 61)
           | (rng.integers(0, 1 << 30, (rows, n)) << 20)
           | rng.integers(0, 1 << 20, (rows, n))).astype(np.int64)
    anc[1] = ((rng.integers(1 << 21, (1 << 21) + 32, n) << 20)
              | rng.integers(0, 32, n)).astype(np.int64)
    keep = np.zeros((rows, n), dtype=bool)
    keep[0, rng.choice(n, 3 * n_max + 17, replace=False)] = True
    keep[1] = True
    keep[3, rng.choice(n, n_max, replace=False)] = True
    keep[4, rng.choice(n, n_max - 1, replace=False)] = True
    keep[5, n - 1] = True
    for r, k in enumerate((CD.SORT_REG_ITEMS - 1, CD.SORT_REG_ITEMS,
                           CD.SORT_REG_ITEMS + 1, CD.SORT_TILE - 1,
                           CD.SORT_TILE, CD.SORT_TILE + 1), start=6):
        keep[r, rng.choice(n, k, replace=False)] = True
    return torch.from_numpy(anc).cuda(), torch.from_numpy(keep).cuda()


def check_anchor_sort(name, anc, keep, rng, hand_rows: bool) -> list:
    """Phase 9 (a''): the anchor sort kernel against its plain version on
    the card, every column and count, on the seeding grid `name` (anchors
    and keep at (MESH_B, P, cap)) and, with hand_rows, on hand-built rows
    of the same width, at each n_max of SORT_N_MAXES. Returns the grid's
    checks, n_max 256 first."""
    import torch

    from linear_tpu_torch.ops import chain_dp as CD

    out = []
    B, n = anc.shape[0], anc[0].numel()
    kept_rows = keep.reshape(B, -1).sum(1)
    for n_max in SORT_N_MAXES:
        got = CD.sort_anchors(anc, keep, n_max)
        want = CD.sort_anchors_reference(anc, keep, n_max)
        lib = sort_by_library(anc, keep, n_max)
        torch.cuda.synchronize()
        same = _equal_all(got, want) and _equal_all(got, lib)
        ms = time_ms(lambda: CD.sort_anchors(anc, keep, n_max), 20)
        plain_ms = time_ms(lambda: CD.sort_anchors_reference(
            anc, keep, n_max), 3)
        lib_ms = time_ms(lambda: sort_by_library(anc, keep, n_max), 3)
        kept = int(kept_rows.sum())
        log(f"anchor sort check (B, n, n_max) = {(B, n, n_max)}, {name}: "
            f"kept {kept} (a row at most {int(kept_rows.max())}), rows "
            f"over n_max {int((kept_rows > n_max).sum())}, every column "
            f"and count equal to the plain version and to the library "
            f"sort {same}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.sort(stable=True) + gather {lib_ms:.4f} ms")
        if not same:
            raise AssertionError(f"the anchor sort kernel disagrees on "
                                 f"{name} at n_max {n_max}")
        # what this grid needs: every keep flag, the kept anchors (no
        # other slot is read), the rows and counts out; ~3 operations a
        # flag and ~4 a comparator of each row's sorting network
        out.append(BUSY.add(
            {"shape": [B, n, n_max], "rows": name, "ms": ms,
             "plain_ms": plain_ms, "library_ms": lib_ms,
             "max_abs_err": 0, "kept": kept,
             **bound(B * n + 8 * kept + B * (8 * n_max + 4),
                     3 * B * n + 4 * network_comparators(kept_rows))},
            "ops.chain_dp:sort_anchors", (anc, keep, n_max), 20,
            "ops.chain_dp:sort_launches"))
    for n_max in SORT_N_MAXES if hand_rows else ():
        anc, keep = hand_sort_rows(rng, n, n_max)
        got = CD.sort_anchors(anc, keep, n_max)
        want = CD.sort_anchors_reference(anc, keep, n_max)
        torch.cuda.synchronize()
        same = _equal_all(got, want)
        ms = time_ms(lambda: CD.sort_anchors(anc, keep, n_max), 5)
        log(f"anchor sort check, hand-built rows (B, n, n_max) = "
            f"{(anc.shape[0], n, n_max)}: kept a row "
            f"{keep.sum(1).tolist()}, counts {got[1].tolist()}, every column "
            f"and count equal {same}; kernel {ms:.4f} ms")
        if not same:
            raise AssertionError(f"the anchor sort kernel disagrees on the "
                                 f"hand-built rows at n_max {n_max}")
    return out


def n_dense_rows(genome, rng, n):
    """n reads from the genome dense with N, for K1's per-read state: N in
    the init window (the first N-free 21-window moves on), only in the last
    21 bases, a base N every 21, all N, N runs inside the first 56 bases
    (the calls k < 41 still hold init bases), 30 % N, and reads of 21-57
    bases, in turns."""
    def cut(ln):
        p = int(rng.integers(0, len(genome) - ln))
        r = genome[p: p + ln].copy()
        r[r == 4] = 0
        return r

    out = []
    while len(out) < n:
        ln = int(rng.integers(1000, 8000))
        r = cut(ln)
        k = len(out) % 9
        if k == 0:
            r[int(rng.integers(0, 21)): 25] = 4
        elif k == 1:
            r[-21:] = 4
        elif k == 2:
            r[int(rng.integers(0, 21))::21] = 4
        elif k == 3:
            r[:] = 4
        elif k == 4:
            r[20:41] = 4
        elif k == 5:
            r[35:56] = 4
        elif k == 6:
            r[rng.random(ln) < 0.3] = 4
        elif k == 7:
            r = cut(int(rng.integers(21, 58)))
            r[len(r) // 2] = 4
        out.append(r)  # k == 8: N-free
    return out


def _grid_bound(seqs, lens, P, cap, kept) -> dict:
    """Bytes and operations of a padded seeding launch: the reads in, two
    dir words a call position and one hs entry a kept slot (a lower count
    than the probed slots), the (rows, P, cap) grid out (9 bytes a slot);
    ~150 operations a position (its states in closed form, the window,
    nine candidates, four YValue bases), ~20 a kept slot."""
    calls = n_calls(lens)
    nbytes = (seqs.nbytes + lens.nbytes + 8 * calls + 8 * kept
              + 9 * seqs.shape[0] * P * cap)
    return bound(nbytes, 150 * calls + 20 * kept)


def _equal_all(got, want) -> bool:
    import torch

    return all(torch.equal(a, b) for a, b in zip(got, want))


def hand_compact_rows(rng, n: int, m_out: int, chunk: int):
    """Rows of n slots for the compaction: every slot kept, then kept counts
    m_out - 1, m_out and m_out + 1 whose m_out-th kept slot is the last flag
    of the first chunk, then the first of the second (random non-zero
    anchors)."""
    rows = [np.ones(n, bool)]
    for at in (chunk - 1, chunk):
        for extra in (-1, 0, 1):
            k = np.zeros(n, bool)
            k[rng.choice(at, m_out - 1, replace=False)] = True
            k[at] = extra >= 0
            if extra > 0:
                k[int(rng.integers(at + 1, n))] = True
            rows.append(k)
    keep = np.stack(rows)
    return rng.integers(1, 1 << 62, keep.shape).astype(np.int64), keep


def check_compact_hand_rows(rng, n: int) -> None:
    """Phase 9 (a): K3 on hand-built rows of the scan grid's width n and on
    a keep view whose rows start off a 16-byte boundary, at each m_out of
    COMPACT_M_OUTS: equal to the plain version and to the stable-sort
    compaction."""
    import torch

    from linear_tpu_torch.ops import seeding as SD

    for m_out in COMPACT_M_OUTS:
        anc, keep = hand_compact_rows(rng, n, m_out, SD.COMPACT_CHUNK)
        a, k = torch.from_numpy(anc).cuda(), torch.from_numpy(keep).cuda()
        # the same rows at a width of two chunks and 13 flags, the flags a
        # view 5 bytes into their buffer
        w = 2 * SD.COMPACT_CHUNK + 13
        buf = torch.zeros(keep.shape[0] * w + 5, dtype=torch.bool,
                          device="cuda")
        kv = buf[5:].view(keep.shape[0], w)
        kv.copy_(k[:, :w])
        for name, args in (("rows", (a, k)),
                           ("keep view off 16 bytes", (a[:, :w].contiguous(),
                                                       kv))):
            got = SD.compact_anchors(*args, m_out)
            want = SD.compact_anchors_reference(*args, m_out)
            same = (_equal_all(got, want)
                    and _equal_all(got, compact_by_sort(*args, m_out)))
            torch.cuda.synchronize()
            log(f"compaction check, hand-built {name} (B, n, m_out) = "
                f"{(args[0].shape[0], args[0].shape[1], m_out)}: counts "
                f"{got[1].tolist()}, equal to the plain version and to the "
                f"stable-sort compaction {same}")
            if not same:
                raise AssertionError(f"the compaction kernel disagrees on the "
                                     f"hand-built {name} at m_out {m_out}")


def check_padded_seeding(r_fa, idx, genome, rng):
    """Phase 9 (a), (a'), (a'') and (b): the scan (K1), closed-form (K2),
    compaction (K3) and anchor sort kernels against their plain versions
    on the card; seed_anchors_batch against the host seeds; mapping_step
    with both seeders against the same step built from the plain
    versions."""
    import torch

    from linear_tpu_torch.index import dindex as DI
    from linear_tpu_torch.ops import chain_dp as CD
    from linear_tpu_torch.ops import seeding as SD
    from linear_tpu_torch.parallel import mesh as MS
    from linear_tpu_torch.utils import seqio

    index = SD.upload_index(idx.dir, idx.hs, "cuda")
    cap = index.cap
    reads = []
    for block in seqio.read_blocks(r_fa):
        reads += block.seqs
    with_n = [r for r in reads if (r == 4).any()]
    n_free = [r for r in reads if 200 < len(r) <= MESH_PAD
              and not (r == 4).any()]
    # long reads (60-120 kb, some with N) cut to the pad: every row ends at
    # the pad, where a YValue base past the row reads 0
    long_cut = check_reads(rng, genome, MESH_B, MESH_PAD, 60_000, 120_000, [])
    P = SD.n_positions(MESH_PAD)
    out = {"scan": [], "fast": [], "compact": []}

    def on_card(rs):
        seqs, lens = SD.pad_reads(rs, MESH_PAD)
        return seqs, lens, torch.from_numpy(seqs).cuda(), \
            torch.from_numpy(lens).cuda()

    # K1: every read with N among corpus reads; then the long reads, and
    # hand-built reads dense with N
    scan_grid = None
    for kind, rs in (("corpus, every read with N", (with_n + n_free)[:MESH_B]),
                     ("60-120 kb reads cut to the pad", long_cut),
                     ("hand-built N-dense reads",
                      n_dense_rows(genome, rng, MESH_B))):
        seqs, lens, s, ln = on_card(rs)
        args = (s, ln, index.dir_start, index.hs, cap)
        got = SD.batch_seed_anchors(*args)
        want = SD.batch_seed_anchors_reference(*args)
        torch.cuda.synchronize()
        same = _equal_all(got, want)
        kept = int(want[1].sum())
        ms = time_ms(lambda: SD.batch_seed_anchors(*args), 10)
        plain_ms = time_ms(lambda: SD.batch_seed_anchors_reference(*args), 1)
        n_n = sum(1 for r in rs if (r == 4).any())
        log(f"scan seeding check (B, L, cap) = {(len(rs), MESH_PAD, cap)}, "
            f"{kind}: {n_n} rows with N, kept anchors {kept}, equal {same}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not same:
            raise AssertionError(f"the scan seeding kernel disagrees with the "
                                 f"plain version ({kind})")
        if len(rs) != MESH_B or (scan_grid is None and n_n != len(with_n)):
            raise AssertionError(f"the scan launch ({kind}) is not as planned")
        out["scan"].append(BUSY.add(
            {"shape": [len(rs), MESH_PAD, cap], "rows": kind, "ms": ms,
             "plain_ms": plain_ms, "max_abs_err": 0,
             **_grid_bound(seqs, lens, P, cap, kept)},
            "ops.seeding:batch_seed_anchors", args, 10,
            "ops.seeding:scan_launches"))
        if scan_grid is None:
            scan_grid = got
        del want

    # K3 on the first scan launch's grid
    anc, keep = scan_grid
    for m_out in COMPACT_M_OUTS:
        got = SD.compact_anchors(anc, keep, m_out)
        want = SD.compact_anchors_reference(anc, keep, m_out)
        lib = compact_by_sort(anc, keep, m_out)
        torch.cuda.synchronize()
        same = _equal_all(got, want) and _equal_all(got, lib)
        n_ovf = int((want[1] > m_out).sum())
        ms = time_ms(lambda: SD.compact_anchors(anc, keep, m_out), 20)
        plain_ms = time_ms(lambda: SD.compact_anchors_reference(
            anc, keep, m_out), 3)
        lib_ms = time_ms(lambda: compact_by_sort(anc, keep, m_out), 5)
        B, n = anc.shape[0], anc[0].numel()
        log(f"compaction check (B, n, m_out) = {(B, n, m_out)}: kept "
            f"{int(want[1].sum())}, overflow rows {n_ovf}, equal to the plain "
            f"version and to the stable-sort compaction {same}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sort(stable=True) "
            f"{lib_ms:.4f} ms")
        if not same:
            raise AssertionError(f"the compaction kernel disagrees at m_out "
                                 f"{m_out}")
        # what this grid needs: every keep flag, the kept anchors (no
        # other slot is read), the rows and counts out; ~3 operations a flag
        kept = int(want[1].sum())
        out["compact"].append(BUSY.add(
            {"shape": [B, n, m_out], "ms": ms, "plain_ms": plain_ms,
             "library_ms": lib_ms, "max_abs_err": 0, "overflow_rows": n_ovf,
             **bound(B * n + 8 * kept + B * (8 * m_out + 4), 3 * B * n)},
            "ops.seeding:compact_anchors", (anc, keep, m_out), 20,
            "ops.seeding:compact_launches"))
    check_compact_hand_rows(rng, anc[0].numel())
    # the anchor sort on that grid, and on the hand-built rows
    out["sort"] = check_anchor_sort(
        "scan grid, corpus reads, every read with N", anc, keep, rng,
        hand_rows=True)
    del anc, keep, scan_grid

    # K2: N-free corpus reads, unsharded and in MESH_SHARDS xval shards
    seqs, lens, s, ln = on_card(n_free[:MESH_B])
    args = (s, ln, index.dir_start, index.hs, cap)
    full = SD.batch_seed_anchors_fast(*args)
    same = _equal_all(full, SD.batch_seed_anchors_fast_reference(*args))
    kept = int(full[1].sum())
    ms = time_ms(lambda: SD.batch_seed_anchors_fast(*args), 10)
    plain_ms = time_ms(lambda: SD.batch_seed_anchors_fast_reference(*args), 2)
    log(f"closed-form seeding check (B, L, cap) = {(MESH_B, MESH_PAD, cap)}, "
        f"N-free corpus reads: kept anchors {kept}, equal {same}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not same:
        raise AssertionError("the closed-form kernel disagrees with the plain "
                             "version")
    out["fast"].append(BUSY.add(
        {"shape": [MESH_B, MESH_PAD, cap], "rows": "N-free", "ms": ms,
         "plain_ms": plain_ms, "max_abs_err": 0,
         **_grid_bound(seqs, lens, P, cap, kept)},
        "ops.seeding:batch_seed_anchors_fast", args, 10,
        "ops.seeding:fast_launches"))
    dir_sh, hs_sh, xb, sh_cap = MS.shard_index_by_xval(idx, MESH_SHARDS)
    tot_a = torch.zeros_like(full[0])
    tot_k = torch.zeros(full[1].shape, dtype=torch.int32, device="cuda")
    for sh in range(MESH_SHARDS):
        d = torch.from_numpy(dir_sh[sh].astype(np.int32)).cuda()
        h = torch.from_numpy(hs_sh[sh].view(np.int64)).cuda()
        kw = dict(x_base=int(xb[sh, 0]), x_hi=int(xb[sh, 1]))
        got = SD.batch_seed_anchors_fast(s, ln, d, h, sh_cap, **kw)
        if not _equal_all(got, SD.batch_seed_anchors_fast_reference(
                s, ln, d, h, sh_cap, **kw)):
            raise AssertionError(f"the closed-form kernel disagrees on shard "
                                 f"{sh}")
        tot_a += got[0]
        tot_k += got[1].to(torch.int32)
        del got, d, h
    psum = torch.equal(tot_a, full[0]) and torch.equal(tot_k > 0, full[1]) \
        and int(tot_k.max()) <= 1
    log(f"closed-form seeding in {MESH_SHARDS} xval shards: each equal to its "
        f"plain version, their sum equal to the unsharded grid {psum}")
    if not psum:
        raise AssertionError("the shards' sum differs from the unsharded grid")
    del tot_a, tot_k
    out["sort"] += check_anchor_sort(
        "closed-form grid, N-free corpus reads", *full, rng, hand_rows=False)
    del full

    # (b) mapping_step, both seeders, against the plain versions on the card
    for fast in (False, True):
        got = MS.mapping_step(s, ln, index.dir_start, index.hs, cap, 256,
                              fast=fast)
        seed = (SD.batch_seed_anchors_fast_reference if fast
                else SD.batch_seed_anchors_reference)
        srt, n = CD.sort_anchors_reference(
            *seed(s, ln, index.dir_start, index.hs, cap), 256)
        want = (srt, n, *CD.chain_dp_windowed_reference(srt, n))
        torch.cuda.synchronize()
        same = _equal_all(got, want)
        log(f"mapping_step (B, L, n_max) = {(MESH_B, MESH_PAD, 256)}, "
            f"fast={fast}: all six outputs equal to the plain versions' "
            f"{same}; anchors chained {int(want[1].sum())}, overflow rows "
            f"{int(want[5].sum())}")
        if not same:
            raise AssertionError(f"mapping_step(fast={fast}) differs from its "
                                 f"plain version")
    del s, ln

    # (a') seed_anchors_batch (K1 then K3): the main path of the compaction
    batch = with_n + n_free[:MESH_B]
    pad = 1 << int(np.ceil(np.log2(max(map(len, batch)))))
    SD.scan_launches = SD.compact_launches = 0
    got = SD.seed_anchors_batch(batch, index, pad, m_out=BATCH_M_OUT)
    out["scan_launches"] = SD.scan_launches
    out["compact_launches"] = SD.compact_launches
    exact = over = 0
    for r, a in zip(batch, got):
        if a is None:
            over += 1
        elif a == [int(v) for v in DI.query_anchors(idx, r, 0, len(r),
                                                    thd_alpha=15)]:
            exact += 1
        else:
            raise AssertionError("seed_anchors_batch differs from the host "
                                 "seeds of a read")
    log(f"seed_anchors_batch ({len(with_n)} reads with N + {MESH_B} N-free, "
        f"pad {pad}, m_out {BATCH_M_OUT}): {exact} reads equal to their host "
        f"seeds, {over} declared overflows; scan launches "
        f"{out['scan_launches']}, compaction launches "
        f"{out['compact_launches']}")
    if not out["scan_launches"] or not out["compact_launches"] or not exact:
        raise AssertionError("seed_anchors_batch did not run its kernels")
    del index
    torch.cuda.empty_cache()
    out["n_free"] = n_free[:MESH_B]
    return out


def _e2e(argv, timeout=900):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "linear_tpu_torch.parallel.e2e",
                          *argv, "--device", "cuda", "--backend", "gloo",
                          "--timeout", str(timeout)], capture_output=True,
                         text=True, env=env, cwd=ROOT)
    wall = time.time() - t0
    for line in res.stdout.splitlines():
        if "socket" not in line:
            log(f"  {line}")
    if res.returncode != 0:
        raise RuntimeError(f"e2e {' '.join(argv)} exited {res.returncode}:\n"
                           f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
    return res.stdout, wall


def check_ranks(d, g_fa, r_fa, idx, n_free, threads):
    """Phase 9 (c): two ranks on the one card (gloo), spawned: the grid
    mapping step at (2, 1) and (1, 2) against one process's
    mapping_step(fast=True), and map->SAM of the whole corpus against one
    process's host-seeded run. Returns the anchor sort launches of the
    ranks' steps run, the closed-form launches of their map run (the mesh
    path) and what it printed."""
    from linear_tpu_torch.ops import seeding as SD

    seqs, lens = SD.pad_reads(n_free, MESH_PAD)
    inputs = os.path.join(d, "mesh_world.npz")
    np.savez(inputs, seqs=seqs, lens=lens, dir=idx.dir, hs=idx.hs, n_max=256)
    stdout, wall = _e2e(["steps", "--inputs", inputs, "--ranks", "2",
                            "--layouts", "2x1,1x2", "--out",
                            os.path.join(d, "mesh_steps.npz")])
    sorts = [int(v) for v in re.findall(r"anchor sort launches (\d+)", stdout)]
    if "STEPS OK" not in stdout or len(sorts) != 2:
        raise AssertionError("the grid steps did not pass")
    log(f"grid steps over 2 ranks: every step equal to one process's; anchor "
        f"sort launches per rank {sorts}; {wall:.2f} s")
    if not all(sorts):
        raise AssertionError("a rank's mapping steps did not launch the "
                             "anchor sort kernel")
    out = os.path.join(d, "e2e_merged.sam")
    stdout, wall = _e2e(["--reads", r_fa, "--genome", g_fa, "--ranks", "2",
                            "--pad", str(MESH_PAD), "--threads", str(threads),
                            "--out", out])
    ranks = re.findall(r"block of (\d+) reads, seeded on the device (\d+), "
                       r"host seeds (\d+) with N, (\d+) over pad \d+, (\d+) "
                       r"overflowing m_out \d+; closed-form seeding launches "
                       r"(\d+), compaction launches (\d+)", stdout)
    if "E2E OK" not in stdout or len(ranks) != 2:
        raise AssertionError("the 2-rank map->SAM run did not pass")
    ranks = [list(map(int, r)) for r in ranks]
    launches = sum(r[5] for r in ranks)
    log(f"2-rank map->SAM of {N_READS} reads: byte-identical to one process; "
        f"per rank: closed-form seeding launches {[r[5] for r in ranks]}, "
        f"host seeds {[r[2] + r[3] + r[4] for r in ranks]} (N, over the pad, "
        f"overflow); {wall:.2f} s")
    if sum(r[0] for r in ranks) != N_READS or not all(r[5] for r in ranks):
        raise AssertionError("the ranks did not seed the corpus on the card")
    with open(out, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    return {"fast_launches": launches, "sort_launches": sum(sorts),
            "ranks": ranks, "wall_s": wall, "sha256": digest}


def align_regions(genomes, read, cords_str, cords_end, band):
    """The (query, reference) band regions that map.align.align_cords
    aligns for one read's cords: its record runs (if_create_new), the
    colinear runs of each (merge_cords_bands), cut by cx/cy on the run's
    strand (map/align.py:194-240; align.py itself stays as it is)."""
    from linear_tpu_torch.map.align import merge_cords_bands
    from linear_tpu_torch.out.bamlink import if_create_new
    from linear_tpu_torch.utils import seqio
    from linear_tpu_torch.utils.cordscalar import cid, cx, cy, strand

    n = len(cords_str)
    if n < 2:
        return []
    runs, s = [], 1
    for i in range(1, n):
        if i == n - 1 or if_create_new(cords_str[i], cords_end[i],
                                       cords_str[i + 1], cords_end[i + 1],
                                       8000):
            runs.append((s, i + 1))
            s = i + 1
    rc = seqio.revcomp(read)
    pairs = []
    for lo, hi in runs:
        g = genomes[cid(cords_str[lo])]
        qseq = rc if strand(cords_str[lo]) else read
        for rs, re_ in merge_cords_bands(cords_str, cords_end, lo, hi, band):
            gx0, gx1 = cx(cords_str[rs]), min(cx(cords_end[re_ - 1]), len(g))
            qy0, qy1 = cy(cords_str[rs]), min(cy(cords_end[re_ - 1]),
                                              len(qseq))
            if gx1 > gx0 and qy1 > qy0:
                pairs.append((qseq[qy0:qy1], g[gx0:gx1]))
    return pairs


def band_cells(nm, W: int) -> int:
    """The DP cells that a banded alignment computes: over rows 1..n of
    each pair, the band's columns j in [i - W, i + W) that lie in [0, m]."""
    cells = 0
    for n, m in nm.tolist():
        i = np.arange(1, n + 1)
        cells += int(np.maximum(0, np.minimum(m, i + W - 1)
                                - np.maximum(0, i - W) + 1).sum())
    return cells


def check_banded(g_fa, r_fa, threads):
    """Phase 10 (a): the banded alignment through banded_align_scores on
    the regions that -a 1 would align for the first BANDED_READS corpus
    reads (the Python engine's cords, mapped on the host), at each W of
    BANDED_WS; each launch against the plain version on the card, and the
    scores of the first ALN_ORACLE_READS reads' regions against the host
    traceback's; then the wide branch (W 16,385, and rows of 2^25) on the
    first regions through banded_align. Returns (results, launches of the
    entry point)."""
    import torch

    from linear_tpu_torch.map.align import banded_align_cigar_fast
    from linear_tpu_torch.map.mapper import Mapper, MapperConfig
    from linear_tpu_torch.ops import align_pallas as AP
    from linear_tpu_torch.utils import seqio

    t0 = time.time()
    m = Mapper([g_fa], MapperConfig(threads=threads, bal_flag=0),
               device="host")
    m.prepare()
    n = BANDED_READS
    block = next(seqio.read_blocks(r_fa))
    reads = block.seqs[:n]
    mapped = m.py_map_reads(reads, block.ids[:n], [None] * n, [None] * n,
                            Mapper.static_chunk_tids(n, threads))
    per_read = [align_regions(m.genomes, r, cs, ce, ALN_BAND)
                for r, (cs, ce, *_) in zip(reads, mapped)]
    pairs = [p for rr in per_read for p in rr]
    n_aln = sum(map(len, per_read[:ALN_ORACLE_READS]))
    qry, ref = [q for q, _ in pairs], [r for _, r in pairs]
    log(f"banded alignment regions: {len(pairs)} of the first {n} reads "
        f"({n_aln} of the first {ALN_ORACLE_READS}), query {min(map(len, qry))}-"
        f"{max(map(len, qry))} b, reference {min(map(len, ref))}-"
        f"{max(map(len, ref))} b; mapped and cut on the host in "
        f"{time.time() - t0:.2f} s")
    AP.launches = 0
    scores = {W: AP.banded_align_scores(qry, ref, W=W) for W in BANDED_WS}
    launches = AP.launches
    results = []
    for W in BANDED_WS:
        packed = AP.pack_pairs(qry, ref, W)
        a, bpad, nm = (torch.from_numpy(x).cuda() for x in packed)
        want, plain_ms = time_once(
            lambda: AP.banded_align_reference(a, bpad, nm, W))
        want = want.cpu().numpy()
        same = np.array_equal(scores[W], want)
        err = _max_abs_err([scores[W]], [want])
        ms = time_ms(lambda: AP.banded_align(a, bpad, nm, W), 5)
        cells = band_cells(packed[2], W)
        log(f"banded alignment check (B, L, KW) = {(len(qry), a.shape[1], 2 * W)}: "
            f"band cells {cells}, scores {int(want.min())}-{int(want.max())}, "
            f"equal to the plain version {same}, max_abs_err {err}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not same:
            raise AssertionError(f"the banded alignment kernel disagrees with "
                                 f"the plain version at W = {W}")
        # the packed codes and lengths in, a score out; ~10 integer
        # operations a band cell (substitution compare and select, diagonal
        # and vertical candidates and their max, the gap chain's max, the
        # end-cell checks)
        results.append(BUSY.add(
            {"shape": [len(qry), a.shape[1], 2 * W], "ms": ms,
             "plain_ms": plain_ms, "max_abs_err": err,
             **bound(sum(x.nbytes for x in packed) + 4 * len(qry),
                     10 * cells)},
            "ops.align_pallas:banded_align", (a, bpad, nm, W), 5,
            "ops.align_pallas:launches"))
        del a, bpad, nm
    # the wide branch: the first BANDED_WIDE_PAIRS regions cut to 1,000
    # bases at W 16,385 (past the register design's 16,384), and four of
    # them in rows of L = 2^25 (past its 2^25 - 1) at the -a band
    wide_q = [q[:1000] for q in qry[:BANDED_WIDE_PAIRS]]
    wide_r = [r[:1000] for r in ref[:BANDED_WIDE_PAIRS]]
    for W, L, k in ((BANDED_WIDE_W, None, BANDED_WIDE_PAIRS),
                    (ALN_BAND, AP.BANDED_MAX_L, 4)):
        packed = AP.pack_pairs(wide_q[:k], wide_r[:k], W, L)
        a, bpad, nm = (torch.from_numpy(x).cuda() for x in packed)
        got = AP.banded_align(a, bpad, nm, W)
        want, plain_ms = time_once(
            lambda: AP.banded_align_reference(a, bpad, nm, W))
        got, want = got.cpu().numpy(), want.cpu().numpy()
        same = np.array_equal(got, want)
        err = _max_abs_err([got], [want])
        ms = time_ms(lambda: AP.banded_align(a, bpad, nm, W), 3)
        cells = band_cells(packed[2], W)
        log(f"banded alignment check (B, L, KW) = {(k, a.shape[1], 2 * W)}, "
            f"wide branch: band cells "
            f"{cells}, scores {int(want.min())}-{int(want.max())}, equal to "
            f"the plain version {same}, max_abs_err {err}; kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms")
        if not same:
            raise AssertionError(f"the banded alignment kernel disagrees with "
                                 f"the plain version at W = {W}, L = "
                                 f"{a.shape[1]}")
        results.append({"shape": [k, a.shape[1], 2 * W], "ms": ms,
                        "device_ms": None, "plain_ms": plain_ms,
                        "max_abs_err": err,
                        **bound(sum(x.nbytes for x in packed) + 4 * k,
                                10 * cells)})
        if W == BANDED_WIDE_W:
            BUSY.add(results[-1], "ops.align_pallas:banded_align",
                     (a, bpad, nm, W), 3, "ops.align_pallas:launches")
        del a, bpad, nm, packed
    t0 = time.time()
    host = np.array([banded_align_cigar_fast(q, r, W=ALN_BAND)[0]
                     for q, r in pairs[:n_aln]])
    n_diff = int((host != scores[ALN_BAND][:n_aln]).sum())
    log(f"banded scores of the first {ALN_ORACLE_READS} reads' {n_aln} regions at "
        f"W = {ALN_BAND}: {n_aln - n_diff} equal to the host traceback's "
        f"(banded_align_cigar_fast, {time.time() - t0:.2f} s)")
    if n_diff or not n_aln:
        raise AssertionError(f"{n_diff} banded scores differ from the host "
                             "traceback's")
    torch.cuda.empty_cache()
    return results, launches


def gap_oracle(genome, read, gs, ge, rs, re_, a_lo, a_hi):
    """The host path of an item (tests/test_gap_dev.py:16-26, on the port's
    gap module): the two 9-mer streams, then g_create_anchors direction 0."""
    from linear_tpu_torch.map import gap as G

    g_hs = []
    G.g_map_hs_kmer(genome, g_hs, gs, ge, 9, 5, 0)
    G.g_map_hs_kmer(read, g_hs, rs, re_, 9, 1, 1)
    anchors = []
    G.g_create_anchors(g_hs, anchors, 9, 0, a_lo, a_hi, len(read) - 1, 0, 0,
                       G.GapParms())
    return np.asarray(anchors, dtype=np.uint64)


def gap_items(genome, rng):
    """GAP_ITEMS gap-interval items cut from the corpus genome as
    tests/test_gap_dev.py:45-66 cuts them: genome windows of 200-5,124
    bases, read windows of 200-4,096 from a read that overlaps the window
    (mutate's substitutions), every other item bounded to +-500 around the
    true diagonal. Every eighth window covers one of the genome's
    dinucleotide microsatellites (60 bases or more), whose 9-mers recur
    past the cap within one window; every 64th is longer than g_max
    (5,300 bases) or r_max (4,200) allows. No window holds N (the caller's
    filter). Returns (items, the oracle's arguments)."""
    from linear_tpu_torch.ops import gap_dev as GD

    eq = (genome[2:] == genome[:-2]) & (genome[:-2] != 4) \
        & (genome[1:-1] != genome[:-2])
    edges = np.diff(np.concatenate([[0], eq.astype(np.int8), [0]]))
    st, en = np.flatnonzero(edges == 1), np.flatnonzero(edges == -1)
    micro = st[en - st >= 60]
    items, wins = [], []
    while len(items) < GAP_ITEMS:
        t = len(items)
        glen = int(rng.integers(200, 5125))
        rlen = int(rng.integers(200, 4097))
        if t % 64 == 63:
            glen, rlen = (5300, rlen) if t % 128 == 63 else (glen, 4200)
        if t % 8 == 7:
            gs = int(micro[(t // 8) % len(micro)]) - int(rng.integers(0, 150))
        else:
            gs = int(rng.integers(0, len(genome) - 10_000))
        rs_pos = max(gs + int(rng.integers(-100, 100)), 0)
        read = mutate(rng, genome[rs_pos: rs_pos + rlen + 500])
        if (genome[gs: gs + glen + 8] == 4).any() or (read == 4).any():
            continue
        a_lo, a_hi = (GD.LLMIN, GD.LLMAX) if t % 2 == 0 else (
            gs - rs_pos - 500, gs - rs_pos + 500)
        g_stop = min(gs + glen, len(genome) - 9)
        r_stop = min(rlen, len(read) - 9)
        items.append({"gwin": genome[gs: g_stop + 8],
                      "g_n": max(g_stop - gs, 0), "gpos0": gs,
                      "rwin": read[: r_stop + 8], "r_n": max(r_stop, 0),
                      "rpos0": 0, "rvcp": len(read) - 1, "a_lo": a_lo,
                      "a_hi": a_hi})
        wins.append((genome, read, gs, gs + glen, 0, rlen, a_lo, a_hi))
    return items, wins


def gap_work(packed, g_max: int, cap: int):
    """Genome samples, read positions and capped candidate pairs of a gap
    anchor launch (the work its bound counts), on the card."""
    import torch

    from linear_tpu_torch.ops import gap_dev as GD

    gseq, g_n, _, rseq, r_n = (torch.from_numpy(x).cuda() for x in packed[:5])
    gval, _ = GD.stream_vals(gseq)
    rval, _ = GD.stream_vals(rseq)
    g_rel = 4 + 5 * torch.arange(g_max, device=gseq.device)
    g_ok = g_rel[None, :] < g_n[:, None]
    gv = gval.gather(1, g_rel.clamp(max=gval.shape[1] - 1)
                     .expand(gseq.shape[0], -1))
    gv = torch.where(g_ok, gv, 1 << 40).sort(1).values
    r_ok = torch.arange(rval.shape[1], device=rseq.device)[None, :] \
        < r_n[:, None]
    n_match = (torch.searchsorted(gv, rval, right=True)
               - torch.searchsorted(gv, rval))
    pairs = torch.where(r_ok, n_match.clamp(max=cap), 0)
    return int(g_ok.sum()), int(r_ok.sum()), int(pairs.sum())


def check_gap(genome, rng):
    """Phase 10 (b): batch_gap_anchors on GAP_ITEMS corpus items (the
    defaults g_max 1024, r_max 4096, cap 16, m_out 2048); the launch
    against the plain version on the card (count, overflow, and anchors
    and keys up to min(count, m_out)), the entry point's per-item result
    against the kernel's tensors, and the first GAP_ORACLE_ITEMS items
    without overflow against the host oracle. Returns (result, launches
    of the entry point)."""
    import torch

    from linear_tpu_torch.ops import gap_dev as GD

    g_max, r_max, cap, m_out = 1024, 4096, 16, 2048
    items, wins = gap_items(genome, rng)
    GD.launches = 0
    got = GD.batch_gap_anchors(items, g_max, r_max, cap, m_out)
    launches = GD.launches
    packed = GD.pack_items(items, g_max, r_max)
    args = [torch.from_numpy(x).cuda() for x in packed]
    kern = [t.cpu().numpy() for t in GD.gap_anchors(*args, g_max, r_max, cap,
                                                    m_out)]
    want, plain_ms = time_once(
        lambda: GD.gap_anchors_reference(*args, g_max, r_max, cap, m_out))
    want = [t.cpu().numpy() for t in want]
    defined = np.arange(m_out)[None, :] < np.minimum(want[2], m_out)[:, None]
    same = (np.array_equal(kern[2], want[2]) and np.array_equal(kern[3], want[3])
            and np.array_equal(np.where(defined, kern[0], 0),
                               np.where(defined, want[0], 0))
            and np.array_equal(np.where(defined, kern[1], 0),
                               np.where(defined, want[1], 0)))
    err = _max_abs_err([np.where(defined, x, 0) for x in kern[:2]] + kern[2:],
                       [np.where(defined, x, 0) for x in want[:2]] + want[2:])
    # windows too long for g_max or r_max: the packing clips them, so the
    # kernel's flag misses them and the entry point declares them itself
    too_long = np.array([it["g_n"] > 5 * g_max + 4 or it["r_n"] > r_max
                         for it in items])
    entry_same = all(
        (g is None) == bool(kern[3][i] or too_long[i])
        and (g is None or np.array_equal(
            g, kern[0][i, : kern[2][i]].view(np.uint64)))
        for i, g in enumerate(got))
    ms = time_ms(lambda: GD.gap_anchors(*args, g_max, r_max, cap, m_out), 20)
    n_ovf = sum(x is None for x in got)
    n_cap = int((want[3] & (want[2] <= m_out) & ~too_long).sum())
    t0 = time.time()
    checked = [i for i, x in enumerate(got) if x is not None][:GAP_ORACLE_ITEMS]
    oracle_same = all(np.array_equal(got[i], gap_oracle(*wins[i]))
                      for i in checked)
    samples, positions, cand = gap_work(packed, g_max, cap)
    kept = int(np.minimum(want[2], m_out).sum())
    log(f"gap anchors check: {len(items)} items, genome samples {samples}, "
        f"read positions {positions}, capped pairs {cand}, kept anchors "
        f"{int(want[2].sum())}, overflow items {n_ovf} ({n_cap} over the "
        f"cap, {int(too_long.sum())} too long); "
        f"kernel equal to the plain version {same}, max_abs_err {err}; the "
        f"entry point's items equal to the kernel's {entry_same}; the first "
        f"{len(checked)} items without overflow equal to the host oracle "
        f"{oracle_same} ({time.time() - t0:.2f} s); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    if not (same and entry_same):
        raise AssertionError("the gap anchor kernel disagrees with the plain "
                             "version")
    if not oracle_same or len(checked) < GAP_ORACLE_ITEMS:
        raise AssertionError("the gap anchors differ from the host oracle")
    if not (n_cap and too_long.any() and n_ovf < len(items) // 2):
        raise AssertionError("some items, and only a few, should overflow "
                             "the cap and the window lengths")
    # the packed windows and item scalars in, the kept anchors and keys,
    # counts and flags out; ~36 integer operations a 9-mer (genome samples
    # and read positions), ~3 a step of a read 9-mer's two binary searches
    # over the samples (log2 g_max steps), ~20 a capped pair
    # (g_hs_set_anchor, the bounds, the emission key)
    steps = 2 * int(np.log2(g_max))
    result = BUSY.add(
        {"shape": [len(items), g_max, r_max, cap, m_out], "ms": ms,
         "plain_ms": plain_ms, "max_abs_err": err, "overflow_items": n_ovf,
         **bound(sum(x.nbytes for x in packed) + 16 * kept + 5 * len(items),
                 36 * (samples + positions) + 3 * steps * positions
                 + 20 * cand)},
        "ops.gap_dev:gap_anchors", (*args, g_max, r_max, cap, m_out), 20,
        "ops.gap_dev:launches")
    del args
    torch.cuda.empty_cache()
    return result, launches


def check_gap_edges(genome, rng) -> list:
    """Phase 10 (b'): gap_anchors past the kernel's shared tables (g_max
    1,025, r_max 4,097: its keyed kernel takes every item) and on windows
    that start within 5 g_max of 2^30 (the block-scan kernel merges those
    items' kept pairs by JAX's emission key): GAP_EDGE_ITEMS items each
    whose windows fill g_max and r_max, against the plain version on the
    card (count, overflow, and anchors and keys up to min(count, m_out))."""
    import torch

    from linear_tpu_torch.ops import gap_dev as GD

    cap, m_out = 16, 2048
    out = []
    for g_max, r_max, near in GAP_EDGE_LIMITS:
        items = []
        while len(items) < GAP_EDGE_ITEMS:
            glen, rlen = 5 * g_max, r_max
            gs = int(rng.integers(0, len(genome) - glen - 1000))
            rs_pos = gs + int(rng.integers(0, 100))
            read = mutate(rng, genome[rs_pos: rs_pos + rlen + 500])
            if (genome[gs: gs + glen + 8] == 4).any() or (read == 4).any():
                continue
            t = len(items)
            items.append({
                "gwin": genome[gs: gs + glen + 8], "g_n": glen,
                "gpos0": (1 << 30) - 1500 - 700 * t if near else gs,
                "rwin": read[: rlen + 8], "r_n": rlen, "rpos0": 0,
                "rvcp": len(read) - 1,
                "a_lo": GD.LLMIN if t % 2 == 0 else gs - rs_pos - 500,
                "a_hi": GD.LLMAX if t % 2 == 0 else gs - rs_pos + 500})
        packed = GD.pack_items(items, g_max, r_max)
        args = [torch.from_numpy(x).cuda() for x in packed]
        kern = [t.cpu().numpy() for t in GD.gap_anchors(
            *args, g_max, r_max, cap, m_out)]
        want, plain_ms = time_once(lambda: GD.gap_anchors_reference(
            *args, g_max, r_max, cap, m_out))
        want = [t.cpu().numpy() for t in want]
        defined = (np.arange(m_out)[None, :]
                   < np.minimum(want[2], m_out)[:, None])
        got_d = [np.where(defined, x, 0) for x in kern[:2]] + kern[2:]
        want_d = [np.where(defined, x, 0) for x in want[:2]] + want[2:]
        same = all(np.array_equal(x, y) for x, y in zip(got_d, want_d))
        err = _max_abs_err(got_d, want_d)
        ms = time_ms(lambda: GD.gap_anchors(*args, g_max, r_max, cap, m_out),
                     10)
        samples, positions, cand = gap_work(packed, g_max, cap)
        kept = int(np.minimum(want[2], m_out).sum())
        tag = "windows near 2^30" if near else "past the shared tables"
        log(f"gap anchors check (B, g_max, r_max) = "
            f"{(len(items), g_max, r_max)}, {tag}: kept anchors "
            f"{int(want[2].sum())}, overflow items {int(want[3].sum())}, "
            f"equal {same}, max_abs_err {err}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        if not same or not kept:
            raise AssertionError(f"the gap anchor kernel disagrees with the "
                                 f"plain version ({tag}, g_max {g_max}, "
                                 f"r_max {r_max})")
        steps = 2 * int(np.ceil(np.log2(g_max)))
        out.append({"shape": [len(items), g_max, r_max, cap, m_out],
                    "rows": tag, "ms": ms, "device_ms": None,
                    "plain_ms": plain_ms,
                    "max_abs_err": err,
                    **bound(sum(x.nbytes for x in packed) + 16 * kept
                            + 5 * len(items),
                            36 * (samples + positions) + 3 * steps * positions
                            + 20 * cand)})
        if near:
            BUSY.add(out[-1], "ops.gap_dev:gap_anchors",
                     (*args, g_max, r_max, cap, m_out), 10,
                     "ops.gap_dev:launches")
        del args
    torch.cuda.empty_cache()
    return out


def host_seeds(index, read):
    """The host's seeds of a whole read (getDIndexMatchAll)."""
    from linear_tpu_torch.index import dindex as DI

    return DI.query_anchors(index, read, 0, len(read))


def subset_reads(d, r_fa, n):
    """The first n reads of the corpus, as a file of their own."""
    from linear_tpu_torch.utils import seqio

    fa = os.path.join(d, f"reads_first{n}.fa")
    if not os.path.exists(fa):
        block = next(seqio.read_blocks(r_fa))
        seqio.write_fasta(fa + ".tmp", block.ids[:n], block.seqs[:n])
        os.replace(fa + ".tmp", fa)
    return fa


OT_FILES = ((1, ".apf"), (2, ".sam"), (4, ".bam"), (8, "_pbsv.bam"))


def run_filter(d, g_fa, r_fa, device, threads, extra=(), tag="", engine=None,
               ot: int = 2):
    """One CLI run with LINEAR_TPU_ENGINE=engine (default native) and
    -ot `ot`; returns (sam sha256, stats dict). stats["files"] holds the
    sha256 of every output file that -ot names."""
    prefix = os.path.join(d, f"out{tag}_{device}")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env["LINEAR_TPU_ENGINE"] = engine or "native"
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "linear_tpu_torch", "filter", r_fa, g_fa,
         "-t", str(threads), "-o", prefix, "-ot", str(ot), "--device", device,
         *extra], capture_output=True, text=True, env=env, cwd=ROOT)
    wall = time.time() - t0
    if res.returncode != 0:
        raise RuntimeError(f"filter {' '.join(extra)} --device {device} "
                           f"exited {res.returncode}:\n{res.stderr[-4000:]}")
    for line in res.stderr.splitlines():
        if line.startswith("--") or line.startswith("Time in sum"):
            log(f"  [{tag or 'b1'} {device}] {line}")
    stats = {"wall_s": wall}
    m = re.search(r"Time in sum\[s\] ([0-9.]+)", res.stderr)
    stats["time_in_sum_s"] = float(m.group(1))
    m = re.search(r"seeded reads (\d+) of (\d+), mapped with device seeds "
                  r"(\d+), seed kernel launches (\d+)", res.stderr)
    if m:
        stats.update(seeded=int(m.group(1)), fetched=int(m.group(2)),
                     mapped_with_device_seeds=int(m.group(3)),
                     launches=int(m.group(4)))
        m = re.search(r"superchunks \(m_out 128: (\d+), m_out 512: (\d+)\), "
                      r"their reads \(m_out 128: (\d+), m_out 512: (\d+)\); "
                      r"seeded on the host: (\d+) with N, (\d+) "
                      r"overflowing", res.stderr)
        stats.update(superchunks=[int(m.group(1)), int(m.group(2))],
                     tier_reads=[int(m.group(3)), int(m.group(4))],
                     host_n=int(m.group(5)), host_overflow=int(m.group(6)))
        m = re.search(r"--Device index \(cuda\): (built on the card|uploaded)"
                      r"(?: \(genome has N\))? in ([0-9.]+) s(?:, build kernel "
                      r"launches (\d+))?", res.stderr)
        stats.update(index=m.group(1), index_s=float(m.group(2)),
                     build_launches=int(m.group(3) or 0))
    m = re.search(r"extended on the device (\d+) of (\d+) eligible, kernel "
                  r"launches (\d+); host re-map: (\d+) with N, (\d+) over "
                  r"\d+ hits, (\d+) overflowing C, (\d+) re-apx", res.stderr)
    if m:
        stats.update(zip(("extended", "eligible", "ext_launches", "remap_n",
                          "remap_hits", "remap_overflow", "remap_reapx"),
                         map(int, m.groups())))
    m = re.search(r"chained on the device (\d+) of (\d+) seeded reads, kernel "
                  r"launches (\d+); host DP: (\d+) with fewer than 2 anchors, "
                  r"(\d+) over \d+ anchors, (\d+) overflowing W", res.stderr)
    if m:
        stats.update(zip(("chained", "chain_seeded", "chain_launches",
                          "chain_few", "chain_many", "chain_overflow"),
                         map(int, m.groups())))
    m = re.search(r"--Device \(cuda\): (.*) runs no device work", res.stderr)
    if m:
        stats["no_device_work"] = m.group(1)
    stats["files"] = {}
    for bit, ext in OT_FILES:
        if ot & bit:
            with open(prefix + ext, "rb") as fh:
                stats["files"][ext] = hashlib.sha256(fh.read()).hexdigest()
    return stats["files"][".sam"], stats


def check_seeding_run(st) -> None:
    """The seeding counts of one cuda run."""
    if not st["seeded"] or st["mapped_with_device_seeds"] != st["seeded"]:
        raise AssertionError(f"seeded reads {st['seeded']}, mapped with "
                             f"device seeds {st['mapped_with_device_seeds']}: "
                             "device seeds were not used")
    if sum(st["superchunks"]) != st["launches"]:
        raise AssertionError("superchunks seeded != seed kernel launches")
    if st["seeded"] + st["host_n"] + st["host_overflow"] != sum(
            st["tier_reads"]):
        raise AssertionError("device seeding does not account for every "
                             "eligible read")


def check_chaining_run(st) -> None:
    """The seeding and chaining counts of one Python-engine cuda run."""
    check_seeding_run(st)
    if not (st["chain_launches"] > 0 and st["chained"] > 0):
        raise AssertionError("the Python engine did not chain on the card")
    if st["chain_seeded"] != st["seeded"] or st["chain_seeded"] != sum(
            st[k] for k in ("chained", "chain_few", "chain_many",
                            "chain_overflow")):
        raise AssertionError("device chaining does not account for every "
                             "seeded read")


def python_engine_runs(d, g_fa, r_fa, threads):
    """The Python-engine paths (phase 8, last part): returns the stats of
    each cuda run by name."""
    out = {}
    for name, n, extra, engine in (
            ("py_b1", PY_B1_READS, (), "py"),
            ("py_b0", PY_B0_READS, ("-b", "0"), "py"),
            ("aln", ALN_READS, ("-a", "1", "-b", "0"), None)):
        fa = subset_reads(d, r_fa, n)
        runs = {dev: run_filter(d, g_fa, fa, dev, threads, extra, name, engine)
                for dev in ("cuda", "host")}
        for dev, (_, st) in runs.items():
            log(f"filter {name} ({n} reads) --device {dev} -t {threads}: "
                f"{json.dumps(st)}; {n / st['time_in_sum_s']:.2f} reads/s "
                f"end to end")
        if runs["cuda"][0] != runs["host"][0]:
            raise AssertionError(f"{name}: SAM of --device cuda differs from "
                                 "host")
        check_chaining_run(runs["cuda"][1])
        msg = ""
        if engine == "py":
            nat, st = run_filter(d, g_fa, fa, "host", threads, extra,
                                 name + "_native")
            if nat != runs["host"][0]:
                raise AssertionError(f"{name}: the Python engine's SAM differs "
                                     "from the native engine's")
            msg = f", == the native engine's ({st['time_in_sum_s']} s)"
        st = runs["cuda"][1]
        log(f"SAM {name} --device cuda == host{msg} (sha256 {runs['cuda'][0]});"
            f" chained on the card {st['chained']} of {st['chain_seeded']} "
            f"seeded reads in {st['chain_launches']} launches")
        out[name] = st
    return out


def other_configurations(d, g_fa, r_fa, threads, sam_b1: str) -> dict:
    """Phase 11: the configurations beside the default one, each --device
    cuda against --device host, every output file byte-identical. sam_b1 is
    the sha256 of phase 8's -b 1 SAM, which the run from a loaded index
    must reproduce. Returns each cuda run's stats by name."""
    few = subset_reads(d, r_fa, OTHER_READS)
    out = {}
    for name, fa, n, extra, ot in (
            ("ot15", r_fa, N_READS, (), 15),
            ("i2", r_fa, N_READS, ("-i", "2"), 2),
            ("i3", few, OTHER_READS, ("-i", "3"), 2),
            ("f0", few, OTHER_READS, ("-f", "0"), 2),
            ("f1", few, OTHER_READS, ("-f", "1"), 2)):
        # the cuda and host runs of a configuration without device work are
        # the same host code: they run side by side, and their times say
        # nothing of the card
        with ThreadPoolExecutor(1 if name == "ot15" else 2) as pool:
            runs = dict(zip(("cuda", "host"), pool.map(
                lambda dev: run_filter(d, g_fa, fa, dev, threads, extra, name,
                                       ot=ot), ("cuda", "host"))))
        for dev, (_, st) in runs.items():
            log(f"filter {name} ({' '.join(extra) or '-b 1'} -ot {ot}, {n} "
                f"reads) --device {dev} -t {threads}: {json.dumps(st)}; "
                f"{n / st['time_in_sum_s']:.2f} reads/s end to end")
        st = runs["cuda"][1]
        if st["files"] != runs["host"][1]["files"]:
            raise AssertionError(f"{name}: a file of --device cuda differs "
                                 "from host")
        if name == "ot15":
            check_seeding_run(st)
            if not st["launches"] or len(st["files"]) != 4:
                raise AssertionError("-ot 15 --device cuda did not seed on "
                                     "the card, or wrote fewer than 4 files")
            if st["files"][".sam"] != sam_b1:
                raise AssertionError("the -ot 15 SAM differs from the -ot 2 "
                                     "SAM")
        elif st.get("no_device_work") != " ".join(extra) or "launches" in st:
            raise AssertionError(f"{name}: --device cuda must say that it "
                                 "does no device work")
        log(f"{name}: {', '.join(st['files'])} of --device cuda == host "
            f"(sha256 {' '.join(v[:16] for v in st['files'].values())})")
        out[name] = st
    # index files: save on the host, load on the card
    path = os.path.join(d, "smoke_index")
    _, st_save = run_filter(d, g_fa, r_fa, "host", threads,
                            ("--save-index", path), "idxsave")
    sam, st_load = run_filter(d, g_fa, r_fa, "cuda", threads,
                              ("--load-index", path), "idxload")
    check_seeding_run(st_load)
    log(f"filter --save-index (host) {st_save['time_in_sum_s']} s, "
        f"{os.path.getsize(path + '.npz')} B; --load-index --device cuda "
        f"{json.dumps(st_load)}")
    if not (sam == st_save["files"][".sam"] == sam_b1):
        raise AssertionError("the SAM of a run with a saved or loaded index "
                             "differs from the run that builds it")
    log(f"SAM --load-index --device cuda == --save-index host == -b 1 "
        f"(sha256 {sam})")
    out["idxload"] = st_load
    return out


def tool(name: str, *args: str) -> str:
    """`python -m linear_tpu_torch.tools.<name> *args` on the card: its last
    line of stdout (raises when it exits non-zero)."""
    res = subprocess.run([sys.executable, "-m",
                          f"linear_tpu_torch.tools.{name}", *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    if res.returncode:
        raise AssertionError(f"tools.{name} exited {res.returncode}: "
                             + res.stderr[-3000:])
    return res.stdout.strip().splitlines()[-1]


def surface_phase(g_fa, r_fa, threads) -> dict:
    """Phase 12: Mapper.warmup on the card (its time and the launches it
    makes), Mapper._device_seed_block on the first BLOCK_READS corpus reads
    against the --device cpu Mapper's (the plain version), every entry
    equal and None at the same reads, with its launches counted on this run;
    then the tools profile_stages (1024 reads, --json) and bench_devbuild
    (46.7 Mb, the device build equal to the host build) in processes of
    their own."""
    from linear_tpu_torch.map.mapper import Mapper, MapperConfig
    from linear_tpu_torch.ops import chain_dp as CD
    from linear_tpu_torch.ops import seeding as SD
    from linear_tpu_torch.utils import seqio

    m = Mapper([g_fa], MapperConfig(threads=threads), device="cuda")
    m.prepare()
    seed0, chain0 = SD.launches, CD.launches
    t0 = time.time()
    m.warmup()
    out = {"warmup_s": time.time() - t0,
           "warmup_launches": {"seed_superchunk": SD.launches - seed0,
                               "chain_dp_windowed": CD.launches - chain0}}
    log(f"Mapper.warmup() on the card: {out['warmup_s']:.3f} s (index "
        f"{m.dev_index_source} in {m.dev_index_seconds:.3f} s), kernel "
        f"launches {out['warmup_launches']}")
    if not all(out["warmup_launches"].values()):
        raise AssertionError("warmup did not launch every kernel of its path")
    block = next(seqio.read_blocks(r_fa))
    sub = seqio.SeqSet(ids=block.ids[:BLOCK_READS],
                       seqs=block.seqs[:BLOCK_READS])
    plain = Mapper([g_fa], MapperConfig(threads=threads), device="cpu")
    plain.f2, plain.index = m.f2, m.index
    want = plain._device_seed_block(sub)
    SD.launches = 0
    t0 = time.time()
    got = m._device_seed_block(sub)
    t_block = time.time() - t0
    out["block_launches"] = SD.launches
    same = ([g is None for g in got] == [w is None for w in want]
            and all(w is None or (g.dtype == np.uint64
                                  and np.array_equal(g, w))
                    for g, w in zip(got, want)))
    n_seeded = sum(g is not None for g in got)
    log(f"Mapper._device_seed_block on {BLOCK_READS} corpus reads: seeded "
        f"{n_seeded}, None {BLOCK_READS - n_seeded} (N bases, 200 bases or "
        f"fewer, or over m_out {m.SEED_M_OUT}), every entry equal to the "
        f"plain version's {same}; {t_block:.3f} s, seed kernel launches "
        f"{out['block_launches']}")
    if not same or not out["block_launches"] or not n_seeded:
        raise AssertionError("block seeding on the card differs from the "
                             "plain version, or launched no kernel")
    del m, plain
    t0 = time.time()
    line = tool("profile_stages", "1024", "--json")
    out["profile_stages"] = json.loads(line)
    log(f"profile_stages ({time.time() - t0:.1f} s): {line}")
    t0 = time.time()
    line = tool("bench_devbuild", "46.7", "--json")
    out["bench_devbuild"] = json.loads(line)
    log(f"bench_devbuild ({time.time() - t0:.1f} s): {line}")
    if out["bench_devbuild"].get("device_equal_host") is not True:
        raise AssertionError("the device DIndex build at 46.7 Mb differs "
                             "from the host build")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from linear_tpu_torch import native
    from linear_tpu_torch.index import dindex as DI
    from linear_tpu_torch.ops import _cuda
    from linear_tpu_torch.ops import seeding as SD

    t_start = time.time()
    smi = common.nvidia_smi()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    for name in ("lt_engine", "lt_seqio", "lt_sort"):
        native.build(name)
        log(f"g++ build {name}: {native.BUILD_SECONDS[name]:.2f} s")
    _cuda.build()
    log(f"nvcc build {_cuda.LIB_NAME}: {_cuda.build_seconds:.2f} s")
    log("ptxas: " + " | ".join(
        ln.strip() for ln in _cuda.ptxas_info.splitlines()
        if "registers" in ln or "Compiling" in ln))

    d = os.path.join(native.BUILD_DIR, "smoke")
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    genome, g_fa, r_fa = common.make_corpus(d)
    g_nf, gnf_fa = make_nfree(d, genome)
    log(f"corpus: genome {len(genome)} b ({int((genome == 4).sum())} N), "
        f"{N_READS} reads: {time.time() - t0:.2f} s")
    threads = os.cpu_count() or 8
    t0 = time.time()
    idx = DI.build_dindex([genome], threads)
    index = SD.upload_index(idx.dir, idx.hs, "cuda")
    torch.cuda.synchronize()
    log(f"index: dir {idx.dir.nbytes} B, hs {idx.hs.nbytes} B, cap "
        f"{index.cap}, built and uploaded in {time.time() - t0:.2f} s")

    checks = check_kernel(index, genome, np.random.default_rng(SEED + 1))
    log(f"phase 4: at {time.time() - t_start:.1f} s")
    del index
    torch.cuda.empty_cache()
    ext_checks = check_extend(g_fa, r_fa, genome, threads,
                              np.random.default_rng(SEED + 5))
    torch.cuda.empty_cache()
    db_check = check_devbuild(g_nf, threads)
    log(f"phases 5-6: at {time.time() - t_start:.1f} s")
    chain_checks, full_checks, full_launches = check_chain_dp(
        g_fa, r_fa, genome, threads, np.random.default_rng(SEED + 2))
    log(f"phase 7: at {time.time() - t_start:.1f} s")

    # the main paths, in fresh processes (the pipeline forks before CUDA).
    # -b 1 in turns: cuda, host, host, cuda
    runs = [(dev, *run_filter(d, g_fa, r_fa, dev, threads))
            for dev in ("cuda", "host", "host", "cuda")]
    for dev, _, st in runs:
        log(f"filter --device {dev} -t {threads}: {json.dumps(st)}; "
            f"{N_READS / st['time_in_sum_s']:.2f} reads/s end to end "
            f"(index build included)")
    sam_cuda, st_cuda = runs[0][1], runs[0][2]
    if any(sam != sam_cuda for _, sam, _ in runs):
        raise AssertionError("SAM of --device cuda differs from --device host")
    log(f"SAM --device cuda == --device host, 4 runs (sha256 {sam_cuda})")
    if not st_cuda.get("launches"):
        raise AssertionError("the seed kernel was never launched on the main path")
    for dev, _, st in runs:
        if dev == "cuda":
            check_seeding_run(st)
            if st["index"] != "uploaded":
                raise AssertionError("a genome with N must upload its index")
    log(f"seeded share: {st_cuda['seeded'] / N_READS:.4f} of the reads seeded "
        f"on the card and mapped with those seeds; the host seeded "
        f"{st_cuda['host_n']} reads with N and {st_cuda['host_overflow']} "
        f"overflowing m_out 512")

    # -b 0, the serial loop with the extension on the card
    b0 = {dev: run_filter(d, g_fa, r_fa, dev, threads, ("-b", "0"), "b0")
          for dev in ("cuda", "host")}
    for dev, (_, st) in b0.items():
        log(f"filter -b 0 --device {dev} -t {threads}: {json.dumps(st)}; "
            f"{N_READS / st['time_in_sum_s']:.2f} reads/s end to end")
    if b0["cuda"][0] != b0["host"][0]:
        raise AssertionError("-b 0 SAM of --device cuda differs from host")
    st_b0 = b0["cuda"][1]
    check_seeding_run(st_b0)
    if not (st_b0["ext_launches"] > 0 and st_b0["extended"] > 0):
        raise AssertionError("-b 0 --device cuda did not extend on the card")
    if st_b0["eligible"] != sum(st_b0[k] for k in (
            "extended", "remap_n", "remap_hits", "remap_overflow",
            "remap_reapx")):
        raise AssertionError("the -b 0 extension does not account for every "
                             "eligible read")
    log(f"SAM -b 0 --device cuda == host (sha256 {b0['cuda'][0]}); extended "
        f"on the card {st_b0['extended']} of {st_b0['eligible']} eligible "
        f"reads in {st_b0['ext_launches']} launches")

    # -b 1 on the N-free genome: the card builds the index
    nf = {dev: run_filter(d, gnf_fa, r_fa, dev, threads, (), "nfree")
          for dev in ("cuda", "host")}
    for dev, (_, st) in nf.items():
        log(f"filter N-free genome --device {dev} -t {threads}: "
            f"{json.dumps(st)}; {N_READS / st['time_in_sum_s']:.2f} reads/s "
            f"end to end")
    if nf["cuda"][0] != nf["host"][0]:
        raise AssertionError("N-free SAM of --device cuda differs from host")
    st_nf = nf["cuda"][1]
    check_seeding_run(st_nf)
    if st_nf["index"] != "built on the card" or not st_nf["build_launches"]:
        raise AssertionError("the N-free genome's index was not built on "
                             "the card")
    log(f"SAM N-free --device cuda == host (sha256 {nf['cuda'][0]}); index "
        f"built on the card in {st_nf['index_s']} s with "
        f"{st_nf['build_launches']} build kernel launches")

    log(f"phase 8, native engine runs: at {time.time() - t_start:.1f} s")
    py = python_engine_runs(d, g_fa, r_fa, threads)
    log(f"phase 8, Python engine runs: at {time.time() - t_start:.1f} s")

    # phase 9: the padded seeding kernels and the mesh path
    t9 = time.time()
    seeding = check_padded_seeding(r_fa, idx, genome,
                                   np.random.default_rng(SEED + 3))
    mesh = check_ranks(d, g_fa, r_fa, idx, seeding.pop("n_free"), threads)
    log(f"phase 9: {time.time() - t9:.2f} s")

    # phase 10: the banded alignment and the gap anchors
    t10 = time.time()
    banded, banded_launches = check_banded(g_fa, r_fa, threads)
    gap, gap_launches = check_gap(genome, np.random.default_rng(SEED + 4))
    gap_edges = check_gap_edges(genome, np.random.default_rng(SEED + 6))
    log(f"phase 10: {time.time() - t10:.2f} s")
    if not (full_launches and banded_launches and gap_launches):
        raise AssertionError("an entry point of phase 7 or 10 did not launch "
                             "its kernel")

    # phase 11: BAM output, -i 2/3, -f 0/1 and the index files
    t11 = time.time()
    other_configurations(d, g_fa, r_fa, threads, sam_cuda)
    log(f"phase 11: {time.time() - t11:.2f} s")

    # phase 12: warmup, block seeding, profile_stages, bench_devbuild
    t12 = time.time()
    surface = surface_phase(g_fa, r_fa, threads)
    log(f"phase 12: {time.time() - t12:.2f} s")

    # the card's busy time of every kernel call queued above, in a fresh
    # process
    t0 = time.time()
    BUSY.measure(d)
    log(f"busy times: {time.time() - t0:.2f} s")

    def entry(name, source, replaces, launches, checks, main, **extra):
        return {"name": name, "route": "cuda",
                "source": f"linear_tpu_torch/ops/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in checks),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main.get("library_ms"),
                "device_ms": main.get("device_ms"), **extra}

    log(f"smoke: {time.time() - t_start:.1f} s from the card's query to here")
    print(json.dumps({"kernels": [
        entry("seed_superchunk", "seed_superchunk.cu",
              "linear_tpu/ops/seeding.py:443", st_cuda["launches"], checks,
              checks[0], shapes=checks,
              warmup_launches=surface["warmup_launches"]["seed_superchunk"],
              block_launches=surface["block_launches"]),
        entry("filter_extend", "filter_extend.cu",
              "linear_tpu/ops/extend_dev.py:537", st_b0["ext_launches"],
              ext_checks, ext_checks[0], shapes=ext_checks),
        entry("devbuild", "devbuild.cu", "linear_tpu/ops/devbuild.py:44",
              st_nf["build_launches"], [db_check], db_check,
              build_s=db_check["build_s"], upload_s=db_check["upload_s"]),
        entry("chain_dp_windowed", "chain_dp.cu",
              "linear_tpu/ops/chain_dp.py:137", py["py_b1"]["chain_launches"],
              chain_checks, chain_checks[1], shapes=chain_checks),
        entry("seed_anchors_scan", "seed_anchors.cu",
              "linear_tpu/ops/seeding.py:210", seeding["scan_launches"],
              seeding["scan"], seeding["scan"][0], shapes=seeding["scan"]),
        entry("seed_anchors_fast", "seed_anchors.cu",
              "linear_tpu/ops/seeding.py:772", mesh["fast_launches"],
              seeding["fast"], seeding["fast"][0], shapes=seeding["fast"]),
        entry("compact_anchors", "seed_anchors.cu",
              "linear_tpu/ops/seeding.py:420", seeding["compact_launches"],
              seeding["compact"], seeding["compact"][-1],
              shapes=seeding["compact"]),
        entry("sort_anchors", "sort_anchors.cu",
              "linear_tpu/parallel/mesh.py:44", mesh["sort_launches"],
              seeding["sort"], seeding["sort"][0], shapes=seeding["sort"],
              path="mesh mapping step"),
        entry("chain_dp_full", "chain_dp.cu",
              "linear_tpu/ops/chain_dp.py:86", full_launches, full_checks,
              full_checks[1], shapes=full_checks, path=ENTRY_ONLY),
        entry("banded_align", "banded_align.cu",
              "linear_tpu/ops/align_pallas.py:142", banded_launches, banded,
              banded[0], shapes=banded, path=ENTRY_ONLY),
        entry("gap_anchors", "gap_anchors.cu", "linear_tpu/ops/gap_dev.py:76",
              gap_launches, [gap] + gap_edges, gap,
              shapes=[gap] + gap_edges, path=ENTRY_ONLY),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
