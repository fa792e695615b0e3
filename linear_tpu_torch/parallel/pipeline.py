"""3-stage pipelined mapping (counterpart of linear_tpu.parallel.pipeline;
the reference's parallel_io scheduler, src/parallel_io.cpp, process3
src/linear.cpp:67-95):

  Stage F (feeder thread)   stream read blocks from disk and hand tasks to
                            the pool; with a device, a _SeedCollector thread
                            reads and seeds the block superchunk by
                            superchunk, and a task ships once its reads'
                            seeds have landed (PyTorch releases the GIL in
                            device calls).
                            With the Python engine the collector also runs
                            the chain DP of the seeded reads on the device
                            (Mapper._device_chain_block), and a task ships
                            with its reads' DP tables.
  Stage C (process pool)    per-read residual in the native engine (chaining,
                            extension, gaps, SAM) or in the Python engine,
                            which starts from the device's DP tables where it
                            has them. Workers are forked after the
                            index/features are built and share them
                            copy-on-write.
  Stage P (main thread)     in-order drain and file emission (mirrors
                            p_PrintResults ordering, src/parallel_io.cpp:522).

The pool forks in PipelineMapper.__init__, before anything initialises
CUDA: the device index is uploaded later (Mapper._ensure_dev_index), and
workers never touch torch.cuda. A device error is never swallowed: the
collector keeps it, and the feeder and the drain re-raise it.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..map.chaining import chain_records_from_dp
from ..map.mapper import MAX_SEED_READ_LEN, THD_MIN_READ_LEN
from ..utils import seqio

_WORKER_MAPPER = None  # set in children via fork


def _init_worker(mapper):
    global _WORKER_MAPPER
    _WORKER_MAPPER = mapper


def _task_reads(reads, rids):
    """Materialise a task's reads: either the pickled (seqs, ids) pair or
    a ("range", path, b0, b1, n) byte-range spec the worker re-reads from
    the source file (drops the dominant task-IPC payload)."""
    if not (isinstance(reads, tuple) and reads and reads[0] == "range"):
        return reads, rids
    _, path, b0, b1, _n = reads
    ids, seqs = seqio.parse_records_range(path, b0, b1)
    return seqs, ids


def _map_chunk(task):
    """Worker: the residual for a CHUNK of reads -> list of (cords_str,
    cords_end, sam, BAM lines). With collect_cords False the cords lists
    come back empty (SAM-only callers never read them), and without BAM
    lines either the native engine maps the chunk in one ctypes crossing.
    The Python engine rebuilds the ChainsRecords of the reads the device
    chained from their raw DP tables (linear_tpu/parallel/pipeline.py:
    95-113)."""
    reads, rids, seeds, chains, collect_bam, collect_cords, persist = task
    reads, rids = _task_reads(reads, rids)
    m = _WORKER_MAPPER
    # State model (linear_tpu.map.mapper.Mapper.gap_parms): the reference's
    # GapParms are per COMPUTE THREAD and persist across tasks. With ONE
    # worker that schedule is deterministic and the worker never resets
    # (persist=True); with several, fresh parms per task reproduce the
    # reference's observed split-schedule outcome.
    if not persist:
        m.reset_gap_parms()
    if not m.use_native():
        chain_pre = [None if c is None else
                     (c[0], chain_records_from_dp(c[1], c[2], c[3], len(c[0])))
                     for c in chains]
        out = m.py_map_reads(reads, rids, seeds, chain_pre, [0] * len(reads),
                             collect_bam)
    elif not (collect_bam or collect_cords):
        return [([], [], m.native_engine().map_block(reads, rids,
                                                     seeds_list=seeds), [])]
    else:
        out = [m.native_map_read(read, rid, seeds=s, collect_bam=collect_bam)
               for read, rid, s in zip(reads, rids, seeds)]
    return out if collect_cords else [([], [], sam, bl)
                                      for _, _, sam, bl in out]


@dataclass
class BlockResult:
    block: "seqio.SeqSet"
    cords_str: List[List[int]]
    cords_end: List[List[int]]
    sam: str
    bam_lines: List
    n_reads: int = 0  # read count (block may be an unparsed placeholder)

    @property
    def n(self) -> int:
        return self.n_reads or len(self.block.seqs)


@dataclass
class PipeCounters:
    """Counts of one PipelineMapper.run, which the CLI prints at the end of
    a run: reads fetched (stage F) and, with device seeding, what the
    device did with them; and the live dashboard of the run, the
    counterpart of the reference's P_Tasks::printRunningInfos
    (src/parallel_io.cpp:69-97) and of linear_tpu's PipeCounters: reads
    fetched, seeded on the device, through the worker residual (stage C)
    and drained in order (stage P), each with its rate, redrawn on stderr
    every `interval` seconds by a thread between start() and stop().
    LINEAR_TPU_DASH=1 turns it on, =0 off; unset, it is on when stderr is
    a terminal. Each count has one writer thread."""

    t0: float = field(default_factory=time.time)
    fetched: int = 0          # reads read from disk
    seeded: int = 0           # reads whose device seeds landed
    computed: int = 0         # reads through the worker residual
    emitted: int = 0          # reads drained in order
    shipped_seeded: int = 0   # reads handed to the pool with device seeds
    # m_out -> superchunks the device seeded at that tier, and the reads
    # whose device seeding ended there (the base tier leaves out the reads
    # it passes on to tier 2)
    superchunks: Dict[int, int] = field(default_factory=dict)
    tier_reads: Dict[int, int] = field(default_factory=dict)
    # eligible reads the device did not seed, which the worker seeds:
    # reads with N bases (2-bit wire) and reads that overflowed tier 2
    host_n: int = 0
    host_overflow: int = 0
    # seconds after t0 at which the first and the last device seeds of the
    # run landed (None: none did)
    seed_first_s: Optional[float] = None
    seed_last_s: Optional[float] = None
    enabled: Optional[bool] = None  # the dashboard; None: LINEAR_TPU_DASH
    interval: float = 0.5
    _stop: threading.Event = field(default_factory=threading.Event,
                                   repr=False)
    _th: Optional[threading.Thread] = field(default=None, repr=False)
    _last_lines: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.enabled is None:
            env = os.environ.get("LINEAR_TPU_DASH")
            self.enabled = (env != "0" if env is not None
                            else sys.stderr.isatty())

    def start(self) -> "PipeCounters":
        """Start the dashboard thread, when enabled."""
        if self.enabled:
            self._th = threading.Thread(target=self._loop, daemon=True)
            self._th.start()
        return self

    def stop(self) -> None:
        """Stop the dashboard thread and draw the final counts."""
        self._stop.set()
        if self._th is not None:
            self._th.join()
            self._th = None
            self._render(final=True)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._render()
            self._stop.wait(self.interval)

    def _render(self, final: bool = False) -> None:
        el = max(time.time() - self.t0, 1e-9)
        up = f"\x1b[{self._last_lines}A" if self._last_lines else ""
        rows = [("I/O::in", self.fetched), ("Seeded", self.seeded),
                ("Compute", self.computed), ("Processed", self.emitted)]
        sys.stderr.write(up + "".join(
            f"\x1b[2K  {name}:\t{cnt}\ttime:{el:.2f}[s]\t"
            f"speed:{cnt / el:.2f}[reads/s]\n" for name, cnt in rows))
        sys.stderr.flush()
        self._last_lines = 0 if final else len(rows)

    def add_superchunk(self, m_out: int, base_tier: bool, idxs,
                       anchors) -> None:
        """Count one superchunk the device seeded at tier m_out: anchors
        are None for the reads it left to the host (N bases at the base
        tier, an overflow of the last tier)."""
        n_got = sum(a is not None for a in anchors)
        self.superchunks[m_out] = self.superchunks.get(m_out, 0) + 1
        self.tier_reads[m_out] = self.tier_reads.get(m_out, 0) + len(idxs)
        self.seeded += n_got
        if base_tier:
            self.host_n += len(idxs) - n_got
        else:
            self.host_overflow += len(idxs) - n_got
        now = time.time() - self.t0
        if self.seed_first_s is None:
            self.seed_first_s = now
        self.seed_last_s = now


class _SeedCollector(threading.Thread):
    """Runs Mapper._device_seed_stream2 over one block, chunk by chunk,
    marking reads FINAL (seeded, or left to the worker's host seeding) as
    device results land; the feeder ships a task only once all its reads
    are final. `reads(a, b)` returns the sequences of block reads [a, b).
    With the Python engine the device also chains each superchunk's seeded
    reads before they turn final (`chains`: raw DP tables, or None for the
    engine's host DP). An exception is kept in `error`; the feeder and the
    drain re-raise it."""

    def __init__(self, mapper, n: int, reads, counters: PipeCounters):
        super().__init__(daemon=True)
        self.final = np.zeros(n, dtype=bool)
        self.seeds: List = [None] * n
        self.chains: List = [None] * n
        self.chain = not mapper.use_native()
        self.error: Optional[BaseException] = None
        self.mapper = mapper
        self.n = n
        self.reads = reads
        self.c = counters
        self.cond = threading.Condition()

    def _chunks(self):
        # superchunk-sized chunks, but a short first one: the pool waits
        # for the first chunk's parse and seeds before its first task
        step = self.mapper.SEED_SUPERCHUNK
        a = 0
        while a < self.n:
            b = min(a + (max(1, step // 8) if a == 0 else step), self.n)
            seqs = self.reads(a, b)
            with self.cond:
                # ineligible reads are never yielded: final at once
                for j, r in enumerate(seqs):
                    if not (THD_MIN_READ_LEN < len(r) <= MAX_SEED_READ_LEN):
                        self.final[a + j] = True
                self.cond.notify_all()
            yield a, seqs
            a = b

    def run(self):
        try:
            for m_out, idxs, anchors in self.mapper._device_seed_stream2(
                    self._chunks()):
                chains = (self.mapper._device_chain_block(anchors, raw=True)
                          if self.chain else [None] * len(idxs))
                with self.cond:
                    for i, a, ch in zip(idxs, anchors, chains):
                        self.seeds[i] = a
                        self.chains[i] = ch
                        self.final[i] = True
                    self.cond.notify_all()
                self.c.add_superchunk(m_out, m_out == self.mapper.SEED_M_OUT,
                                      idxs, anchors)
        except BaseException as e:  # re-raised by the feeder and the drain
            self.error = e
        finally:
            with self.cond:
                self.final[:] = True
                self.cond.notify_all()

    def wait_final(self, i: int, j: int) -> None:
        """Block until reads [i, j) are final; raise the collector's error."""
        with self.cond:
            self.cond.wait_for(lambda: self.final[i:j].all())
        if self.error is not None:
            raise self.error


class PipelineMapper:
    """Drives Mapper over one read file with the 3-stage pipeline."""

    def __init__(self, mapper, n_workers: Optional[int] = None,
                 csize_workers: Optional[int] = None):
        self.mapper = mapper
        # one worker more than cores: workers stall on result pickling /
        # task IPC often enough that mild oversubscription wins
        self.n_workers = n_workers or (max(os.cpu_count() or 1, 1) + 1)
        # task boundaries (hence the fresh-GapParms-per-task schedule that
        # gap-phase output depends on) derive from csize_workers — callers
        # pass the REQUESTED -t so the same command yields the same output
        # on hosts with different core counts
        self.csize_workers = csize_workers or self.n_workers
        self.counters: Optional[PipeCounters] = None  # of the last run
        # the children inherit the mapper copy-on-write, so it is prepared
        # (host only, no device) before the fork
        mapper.prepare()
        ctx = mp.get_context("fork")
        self.pool = ctx.Pool(self.n_workers, initializer=_init_worker,
                             initargs=(mapper,))

    def close(self) -> None:
        self.pool.close()
        self.pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def run(self, read_path: str, collect_bam: bool = False,
            collect_cords: bool = True) -> Iterator[BlockResult]:
        """Yields per-block results in input order.

        Task boundaries (csize) are fixed by the block size alone; only WHEN
        a task is handed to the pool depends on the device. With device
        seeding a collector thread reads and seeds the block chunk by chunk,
        and the feeder hands each task to the pool once all its reads are
        final: every read the device can seed is mapped with its device
        seeds, and device work overlaps the workers' residual."""
        m = self.mapper
        pool = self.pool
        q: "queue.Queue" = queue.Queue(maxsize=64)
        END_BLOCK = object()
        c = self.counters = PipeCounters()
        seeding = m.device_work()

        def feeder():
            try:
                # byte offsets let workers (and the seed collector) read
                # their chunk from the file instead of receiving the reads
                # pickled (None for gzipped input: the reads are pickled)
                offs = seqio.scan_record_offsets(read_path)
                # SAM-only runs never parse a whole block in THIS process:
                # blocks become offset ranges
                need_parse = collect_cords or offs is None

                def blocks_iter():
                    if need_parse:
                        for b in seqio.read_blocks(read_path):
                            yield b, len(b.seqs)
                    else:
                        for s0 in range(0, len(offs) - 1, 50000):
                            yield seqio.SeqSet(), min(50000, len(offs) - 1 - s0)

                g0 = 0  # global record index of the current block start
                coll = None
                for block, n in blocks_iter():
                    c.fetched += n
                    csize = max(1, -(-n // (4 * self.csize_workers)))
                    spans = [(i, min(i + csize, n)) for i in range(0, n, csize)]
                    persist = self.n_workers == 1
                    seeds: List = [None] * n
                    chains: List = [None] * n
                    if seeding:
                        # at most one collector: the previous block's has
                        # drained its device work before this one starts
                        if coll is not None:
                            coll.join()
                        if need_parse:
                            def reads(a, b, blk=block):
                                return blk.seqs[a:b]
                        else:
                            def reads(a, b, g=g0):
                                return seqio.parse_records_range(
                                    read_path, int(offs[g + a]),
                                    int(offs[g + b]))[1]
                        coll = _SeedCollector(m, n, reads, c)
                        coll.start()
                        seeds, chains = coll.seeds, coll.chains
                    for i, j in spans:
                        if seeding:
                            coll.wait_final(i, j)
                        if offs is not None:
                            payload = ("range", read_path, int(offs[g0 + i]),
                                       int(offs[g0 + j]), j - i)
                            rid_payload = None
                        else:
                            payload = block.seqs[i:j]
                            rid_payload = block.ids[i:j]
                        task_seeds = seeds[i:j]
                        q.put((payload, rid_payload, task_seeds,
                               chains[i:j], collect_bam, collect_cords,
                               persist))
                        c.shipped_seeded += sum(s is not None
                                                for s in task_seeds)
                    q.put((END_BLOCK, block, n, coll))
                    g0 += n
                q.put(None)
            except BaseException as e:  # surface in main thread
                q.put(e)

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        c.start()
        try:
            yield from self._drain(q, pool, END_BLOCK, c)
        finally:
            c.stop()
        th.join()

    def _drain(self, q, pool, END_BLOCK, c: PipeCounters):
        pending: List = []  # AsyncResults of the current block, in order
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            if isinstance(item, tuple) and item and item[0] is END_BLOCK:
                _, block, n_reads, coll = item
                results = [r for ar in pending for r in ar.get()]
                pending = []
                if coll is not None:
                    # the block's output does not depend on its seeds, but
                    # a device failure must fail the run
                    coll.join()
                    if coll.error is not None:
                        raise coll.error
                c.emitted += n_reads
                yield BlockResult(block, [r[0] for r in results],
                                  [r[1] for r in results],
                                  "".join(r[2] for r in results),
                                  [ln for r in results for ln in r[3]],
                                  n_reads=n_reads)
                continue
            p0 = item[0]
            n_task = (p0[4] if isinstance(p0, tuple) and p0
                      and p0[0] == "range" else len(p0))
            pending.append(pool.apply_async(
                _map_chunk, (item,), callback=lambda res, k=n_task: setattr(
                    c, "computed", c.computed + k)))
