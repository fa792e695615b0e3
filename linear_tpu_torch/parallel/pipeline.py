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

With tracing on (PipelineMapper.trace; LINEAR_TPU_TRACE), a run's
PipeCounters also records spans of every stage, per block, superchunk and
task (the workers' come back with their tasks' results), each thread's
CPU time, and the workers' native phase times; write_trace writes them as
Chrome trace-event JSON.

The pool forks in PipelineMapper.__init__, before anything initialises
CUDA: the device index is uploaded later (Mapper._ensure_dev_index), and
workers never touch torch.cuda. A device error is never swallowed: the
collector keeps it, and the feeder and the drain re-raise it.
"""
from __future__ import annotations

import itertools
import json
import multiprocessing as mp
import os
import queue
import sys
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional

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
    95-113). A traced task carries its task id as an eighth item and comes
    back as (that list, the worker's spans, its native phase ns)."""
    if len(task) == 7:
        return _residual(*task)
    c = PipeCounters(trace=True, enabled=False)
    with c.span("worker.task", task[7]) as sp:
        out = _residual(*task[:7], c=c)
        sp.args = {k + "_ns": v for k, v in c.worker_ns.items()}
    return out, c.spans, c.worker_ns


def _residual(reads, rids, seeds, chains, collect_bam, collect_cords,
              persist, c=None):
    """_map_chunk's work; `c` (a traced PipeCounters) gets the spans of the
    reads' parse and of the engine call, and the native engine's phase ns
    of that call."""
    span = c.span if c is not None else _no_span
    with span("worker.parse"):
        reads, rids = _task_reads(reads, rids)
    m = _WORKER_MAPPER
    # State model (linear_tpu.map.mapper.Mapper.gap_parms): the reference's
    # GapParms are per COMPUTE THREAD and persist across tasks. With ONE
    # worker that schedule is deterministic and the worker never resets
    # (persist=True); with several, fresh parms per task reproduce the
    # reference's observed split-schedule outcome.
    if not persist:
        m.reset_gap_parms()
    ne = m.native_engine() if c is not None and m.use_native() else None
    if ne is not None:
        # what earlier tasks and the warm-up left in the counters
        ne.stage_ns()
        ne.apx_stage_ns()
    with span("worker.map"):
        if not m.use_native():
            chain_pre = [None if ch is None else
                         (ch[0], chain_records_from_dp(ch[1], ch[2], ch[3],
                                                       len(ch[0])))
                         for ch in chains]
            out = m.py_map_reads(reads, rids, seeds, chain_pre,
                                 [0] * len(reads), collect_bam)
        elif not (collect_bam or collect_cords):
            out = [([], [], m.native_engine().map_block(
                reads, rids, seeds_list=seeds), [])]
        else:
            out = [m.native_map_read(read, rid, seeds=s,
                                     collect_bam=collect_bam)
                   for read, rid, s in zip(reads, rids, seeds)]
    if ne is not None:
        c.add_worker_ns(dict(zip(WORKER_STAGES,
                                 ne.stage_ns() + ne.apx_stage_ns())))
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


# the native engine's phase counters a traced task reads: le_stage_ns
# (features, apx, gap, output) and le_apx_stage_ns (the apx phase's host
# seeding, chain and extension)
WORKER_STAGES = ("features", "apx", "gap", "output", "apx.host_seed",
                 "apx.chain", "apx.extend")


class Span(NamedTuple):
    """One traced stage of a run, in one thread of one process."""

    id: int
    parent: int     # the span open around it in its thread; -1: none
    name: str
    pid: int
    tid: int        # threading.get_native_id()
    t0: int         # time.perf_counter_ns(): CLOCK_MONOTONIC on Linux,
    t1: int         # one clock for the forked workers too
    cpu0: int       # time.thread_time_ns() of its thread
    cpu1: int
    task: int = -1  # the task's id, where the span is of one task
    args: Optional[dict] = None


class _SpanScope:
    """Records a Span on `c` from __enter__ to __exit__; `args` may be set
    inside."""

    __slots__ = ("c", "name", "task", "args", "id", "parent", "t0", "cpu0")

    def __init__(self, c: "PipeCounters", name: str, task: int):
        self.c, self.name, self.task, self.args = c, name, task, None

    def __enter__(self) -> "_SpanScope":
        stack = self.c._stack()
        self.parent = stack[-1] if stack else -1
        self.id = next(self.c._ids)
        stack.append(self.id)
        # the thread's CPU is read inside the wall interval
        self.t0 = time.perf_counter_ns()
        self.cpu0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc) -> None:
        cpu1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        self.c._stack().pop()
        self.c.spans.append(Span(self.id, self.parent, self.name, os.getpid(),
                                 threading.get_native_id(), self.t0, t1,
                                 self.cpu0, cpu1, self.task, self.args))


_NO_SPAN = nullcontext()


def _no_span(name: str, task: int = -1):
    return _NO_SPAN


def trace_path() -> Optional[str]:
    """LINEAR_TPU_TRACE: the file a CLI run writes its trace to, which
    also turns tracing on; None when unset, empty or "0"."""
    v = os.environ.get("LINEAR_TPU_TRACE")
    return v if v and v != "0" else None


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
    a terminal. Each count has one writer thread.

    With `trace` on, the run also records its spans (span(); per block,
    superchunk and task, never per read), the CPU time of the feeder, the
    seed collectors and the drain, and the workers' native phase ns
    summed over tasks (worker_ns, keys WORKER_STAGES)."""

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
    trace: bool = False
    spans: List[Span] = field(default_factory=list, repr=False)
    feeder_cpu_ns: int = 0
    collector_cpu_ns: int = 0
    drain_cpu_ns: int = 0
    worker_ns: Dict[str, int] = field(default_factory=dict)
    _ids: Iterator[int] = field(default_factory=itertools.count, repr=False)
    _open: threading.local = field(default_factory=threading.local,
                                   repr=False)
    _stop: threading.Event = field(default_factory=threading.Event,
                                   repr=False)
    _th: Optional[threading.Thread] = field(default=None, repr=False)
    _last_lines: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.enabled is None:
            env = os.environ.get("LINEAR_TPU_DASH")
            self.enabled = (env != "0" if env is not None
                            else sys.stderr.isatty())

    def span(self, name: str, task: int = -1):
        """A context that records a span `name` in the calling thread while
        tracing is on, and does nothing otherwise."""
        return _SpanScope(self, name, task) if self.trace else _NO_SPAN

    def _stack(self) -> List[int]:
        st = getattr(self._open, "ids", None)
        if st is None:
            st = self._open.ids = []
        return st

    def steps(self, it, name: str):
        """it, with a span `name` around the making of each item while
        tracing is on."""
        if not self.trace:
            yield from it
            return
        it, end = iter(it), object()
        while True:
            with self.span(name):
                x = next(it, end)
            if x is end:
                return
            yield x

    def add_worker_ns(self, ns: Dict[str, int]) -> None:
        """Add a task's native phase ns (keys WORKER_STAGES)."""
        for k, v in ns.items():
            self.worker_ns[k] = self.worker_ns.get(k, 0) + v

    def adopt(self, spans: List[Span]) -> None:
        """Add the spans a worker recorded for one task, under ids of this
        run."""
        ids = {sp.id: next(self._ids) for sp in spans}
        self.spans.extend(sp._replace(id=ids[sp.id],
                                      parent=ids.get(sp.parent, -1))
                          for sp in spans)

    def trace_events(self, label: str = "") -> List[dict]:
        """The run's spans as Chrome trace events ("X", microseconds on
        CLOCK_MONOTONIC), with a thread_name event for each thread."""
        ev, names = [], {}
        for sp in self.spans:
            names.setdefault((sp.pid, sp.tid), sp.name.split(".")[0])
            args = {"id": sp.id, "parent": sp.parent,
                    "cpu_us": (sp.cpu1 - sp.cpu0) / 1e3}
            if sp.task >= 0:
                args["task"] = sp.task
            if label:
                args["run"] = label
            ev.append({"name": sp.name, "ph": "X", "ts": sp.t0 / 1e3,
                       "dur": (sp.t1 - sp.t0) / 1e3, "pid": sp.pid,
                       "tid": sp.tid, "args": {**args, **(sp.args or {})}})
        ev.extend({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                   "args": {"name": role}}
                  for (pid, tid), role in names.items())
        return ev

    def totals(self) -> dict:
        """The run's counts and CPU and phase times, for a trace file."""
        return {k: getattr(self, k) for k in (
            "fetched", "seeded", "computed", "emitted", "shipped_seeded",
            "host_n", "host_overflow", "feeder_cpu_ns", "collector_cpu_ns",
            "drain_cpu_ns", "worker_ns")} | {"spans": len(self.spans)}

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
            with self.c.span("collector.read"):
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
        cpu0 = time.thread_time_ns() if self.c.trace else 0
        # the counters go along only when traced, so that a replacement of
        # _device_seed_stream2 that takes the chunks alone keeps working
        kw = {"counters": self.c} if self.c.trace else {}
        try:
            for m_out, idxs, anchors in self.mapper._device_seed_stream2(
                    self._chunks(), **kw):
                if self.chain:
                    with self.c.span("collector.chain"):
                        chains = self.mapper._device_chain_block(anchors,
                                                                 raw=True)
                else:
                    chains = [None] * len(idxs)
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
            if self.c.trace:
                self.c.collector_cpu_ns += time.thread_time_ns() - cpu0

    def wait_final(self, i: int, j: int) -> None:
        """Block until reads [i, j) are final; raise the collector's error."""
        with self.cond:
            self.cond.wait_for(lambda: self.final[i:j].all())
        if self.error is not None:
            raise self.error


class PipelineMapper:
    """Drives Mapper over one read file with the 3-stage pipeline. `trace`
    (default: LINEAR_TPU_TRACE set, trace_path) turns on the runs'
    tracing (PipeCounters.trace)."""

    def __init__(self, mapper, n_workers: Optional[int] = None,
                 csize_workers: Optional[int] = None,
                 trace: Optional[bool] = None):
        self.mapper = mapper
        self.trace = trace_path() is not None if trace is None else trace
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
        c = self.counters = PipeCounters(trace=self.trace)
        tr = c.trace
        seeding = m.device_work()

        def feeder():
            cpu0 = time.thread_time_ns() if tr else 0
            try:
                # byte offsets let workers (and the seed collector) read
                # their chunk from the file instead of receiving the reads
                # pickled (None for gzipped input: the reads are pickled)
                with c.span("feeder.offsets"):
                    offs = seqio.scan_record_offsets(read_path)
                # SAM-only runs never parse a whole block in THIS process:
                # blocks become offset ranges
                need_parse = collect_cords or offs is None

                def blocks_iter():
                    if need_parse:
                        for b in c.steps(seqio.read_blocks(read_path),
                                         "feeder.block"):
                            yield b, len(b.seqs)
                    else:
                        for s0 in range(0, len(offs) - 1, 50000):
                            yield seqio.SeqSet(), min(50000, len(offs) - 1 - s0)

                g0 = 0  # global record index of the current block start
                k = 0  # task id, when traced
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
                            with c.span("feeder.wait_seeds", k):
                                coll.wait_final(i, j)
                        if offs is not None:
                            payload = ("range", read_path, int(offs[g0 + i]),
                                       int(offs[g0 + j]), j - i)
                            rid_payload = None
                        else:
                            payload = block.seqs[i:j]
                            rid_payload = block.ids[i:j]
                        task_seeds = seeds[i:j]
                        task = (payload, rid_payload, task_seeds,
                                chains[i:j], collect_bam, collect_cords,
                                persist)
                        with c.span("feeder.put", k):
                            q.put(task + (k,) if tr else task)
                        k += 1
                        c.shipped_seeded += sum(s is not None
                                                for s in task_seeds)
                    q.put((END_BLOCK, block, n, coll))
                    g0 += n
                q.put(None)
            except BaseException as e:  # surface in main thread
                q.put(e)
            finally:
                if tr:
                    c.feeder_cpu_ns += time.thread_time_ns() - cpu0

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        c.start()
        try:
            yield from self._drain(q, pool, END_BLOCK, c)
        finally:
            c.stop()
        th.join()

    def _drain(self, q, pool, END_BLOCK, c: PipeCounters):
        """The in-order drain. Traced, its CPU runs from each resumption to
        the next yield: the consumer's time between blocks is not its."""
        tr = c.trace
        cpu0 = time.thread_time_ns() if tr else 0
        pending: List = []  # AsyncResults of the current block, in order
        while True:
            with c.span("drain.get"):
                item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            if isinstance(item, tuple) and item and item[0] is END_BLOCK:
                _, block, n_reads, coll = item
                with c.span("drain.results"):
                    results = []
                    for ar in pending:
                        res = ar.get()
                        if tr:
                            res, w_spans, w_ns = res
                            c.adopt(w_spans)
                            c.add_worker_ns(w_ns)
                        results.extend(res)
                pending = []
                if coll is not None:
                    # the block's output does not depend on its seeds, but
                    # a device failure must fail the run
                    coll.join()
                    if coll.error is not None:
                        raise coll.error
                c.emitted += n_reads
                with c.span("drain.join"):
                    br = BlockResult(block, [r[0] for r in results],
                                     [r[1] for r in results],
                                     "".join(r[2] for r in results),
                                     [ln for r in results for ln in r[3]],
                                     n_reads=n_reads)
                if tr:
                    c.drain_cpu_ns += time.thread_time_ns() - cpu0
                yield br
                if tr:
                    cpu0 = time.thread_time_ns()
                continue
            p0 = item[0]
            n_task = (p0[4] if isinstance(p0, tuple) and p0
                      and p0[0] == "range" else len(p0))
            with c.span("drain.submit", item[7] if tr else -1):
                pending.append(pool.apply_async(
                    _map_chunk, (item,),
                    callback=lambda res, k=n_task: setattr(
                        c, "computed", c.computed + k)))
        if tr:
            c.drain_cpu_ns += time.thread_time_ns() - cpu0


def write_trace(path: str, runs) -> None:
    """Write the spans and counters of traced runs, [(label, PipeCounters)]
    (a CLI run: one a read file), as one Chrome trace-event JSON file, which
    Perfetto and chrome://tracing open: timestamps in microseconds of
    CLOCK_MONOTONIC, each run's totals under otherData."""
    events = [e for label, c in runs for e in c.trace_events(label)]
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"clock": "CLOCK_MONOTONIC (time.perf_counter_ns)",
                         "ts_unit": "us",
                         "runs": [{"run": label, **c.totals()}
                                  for label, c in runs]}}
    with open(path, "w") as f:
        json.dump(doc, f)
