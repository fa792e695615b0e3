"""One run of a cell: data, set-up, the measured window, the comparison
with the plain reference, and the result line's contents.

  data     genome and read files from the seed (gen/), written as FASTA
           under a fresh directory in $TMPDIR, before any program import;
           with a donor in the traffic, the reads come from the donor
           (gen/donor.py) and the genome written is the reference;
  set-up   (setup_s) the port's own order for a `filter` run
           (linear_tpu_torch/cli.py): import its host modules; Mapper on
           the genome and, with -b 1, PipelineMapper (prepare, then fork
           the workers); import torch and the ops modules;
           Mapper._ensure_dev_index (CUDA context, kernel library, the
           device index built or uploaded, a first launch); one pass of a
           warm-up file of the traffic (1,024 reads) as the window maps;
  window   the pool's read files mapped one after another, as the CLI
           maps several read files: with -b 1 each through
           PipelineMapper.run, with -b 0 by the serial loop of
           Mapper.map_block over its blocks; each block consumed as the
           CLI's emit does (the SAM text, Mapper.apf_block for -ot 1, and
           for -ot 4 or 8 the file's BAM written, as the CLI writes it,
           into the run's temporary directory), the text kept in memory,
           and every output digested; every file of the pool is mapped
           once, and at `seconds` the file in progress is finished.
           reads_per_s = reads emitted / (last drain - window start);
  check    after the window, the port's workers closed and its device
           state read back and freed: the device index, a sample of the
           device seeds and every first pass's SAM (and APF) against the
           reference (reference/), every later pass's digest against its
           file's first pass, and with a donor the SV signals of the
           first passes' SAM (reference/svsignal.py). attempted counts
           each read of the pool once (its file's first pass), failed
           those of them with no primary record there.

A traced run (trace=True) also wraps the seeding calls in spans, reads
the workers' and the main process's CPU time from the OS over the window,
turns the program's own tracing on (PipelineMapper.trace) from the
window's start through the profiled pass, and after the window maps one
more steady file (the pool's second) under torch.profiler; the metric
readers (metrics/<name>.py) take their numbers from the context it
returns. Untraced runs never turn the program's tracing on.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from gen import donor as DN
from gen import genome as GG
from gen import reads as GR
from lib import fasta, procstat
from lib import program as PG
from lib import trace as TR
from reference import dindex as RD
from reference import fasta as RF
from reference import placement as RP
from reference import seeds as RS
from reference import svsignal as SVS

MIN_SEED_LEN = 200        # reads of 200 bases or fewer are not seeded
MAX_SEED_LEN = 1 << 17    # nor are reads longer than this
TIERS = (128, 512)        # anchor slots of the two seeding tiers
SEED_SAMPLE = 48          # reads a file whose device seeds are compared
FORBIDDEN = ("jax", "jaxlib", "flax", "linear_tpu")
# the configuration's flags the harness carries out, as the CLI does;
# a configuration file with any other is refused
FLAGS = {"index_type", "feature_type", "gap_len", "bal_flag", "output_type",
         "threads", "engine"}
ENGINES = ("native", "py")    # LINEAR_TPU_ENGINE of the run


class NoCard(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check_flags(flags: dict) -> None:
    """Raise ValueError on a flag, or a flag's value, that the harness
    would not carry out as the CLI does."""
    bad = sorted(set(flags) - FLAGS)
    if bad:
        raise ValueError(f"flags the harness does not carry out: {bad}")
    if int(flags["bal_flag"]) not in (0, 1):
        raise ValueError(f"-b {flags['bal_flag']}: not 0 or 1")
    ot = int(flags["output_type"])
    if not 1 <= ot <= 15:
        raise ValueError(f"-ot {ot}: not 1 to 15")
    if not ot & 3:
        raise ValueError(f"-ot {ot}: neither SAM nor APF, from which the "
                         "comparison reads the placements")
    if flags.get("engine", "native") not in ENGINES:
        raise ValueError(f"engine {flags['engine']!r}: not one of {ENGINES}")


def threads_of(flags: dict) -> int:
    t = flags["threads"]
    return (os.cpu_count() or 1) if t == "host_cores" else int(t)


def make_data(cell: dict, seed: int, d: str):
    """Genome, warm-up and read files of the cell in d: (genome path,
    warm-up path, [(path, names, truth, read lengths)], the donor: the
    traffic's, or the reference itself)."""
    rng = np.random.default_rng(seed)
    cfg, traffic = cell["config"], cell["traffic"]
    g, mask = GG.make(rng, cfg["genome"])
    g_path = os.path.join(d, "genome.fa")
    fasta.write_genome(g_path, cfg["genome"]["id"], g)
    d_spec = DN.spec_of(traffic)
    donor = (DN.identity(g) if d_spec is None
             else DN.make(rng, g, mask, d_spec))
    files = []
    for fi, (reads, truth) in enumerate(GR.make_pool(rng, donor, traffic,
                                                     mask)):
        names = [f"f{fi}r{i}" for i in range(len(reads))]
        path = os.path.join(d, f"reads{fi}.fa")
        fasta.write_reads(path, names, reads)
        files.append((path, names, truth,
                      np.array([len(r) for r in reads], dtype=np.int64)))
    warm = GR.make_warmup(rng, donor, traffic)
    w_path = os.path.join(d, "warmup.fa")
    fasta.write_reads(w_path, [f"w{i}" for i in range(len(warm))], warm)
    return g_path, w_path, files, donor


def seed_sample(seed: int, lens: np.ndarray, k: int = SEED_SAMPLE) -> set:
    """Read indices of a file whose device seeds are compared: k drawn
    from the seed, and the file's longest read."""
    rng = np.random.default_rng([seed, 7])
    pick = rng.choice(len(lens), min(k, len(lens)), replace=False)
    return set(pick.tolist()) | {int(np.argmax(lens))}


def power_limit():
    """The first card's power limit as nvidia-smi reads it ("700.00 W"), or
    None where nvidia-smi cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def forbidden_modules(names=None) -> list:
    """The FORBIDDEN top-level names (the part before the first dot,
    compared whole) among the loaded modules' names."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run(cell: dict, seed: int, seconds: float, trace: bool = False,
        device: str = "cuda", control: bool = False) -> dict:
    """One run; returns {"setup_s", "reads_per_s", "attempted", "failed",
    "checks": {name: (value, limit)}, "device": {...}, "ctx": metric
    context (traced runs), "breakdown"}. Raises NoCard without the cards
    the cell asks for (device "cuda")."""
    flags = cell["config"]["flags"]
    check_flags(flags)
    if "donor" in cell["traffic"] and not int(flags["output_type"]) & 2:
        raise ValueError("a donor's SV signals are read from the SAM: the "
                         "configuration writes none")
    tmp = tempfile.mkdtemp(prefix="linear_bench.", dir=os.environ.get(
        "TMPDIR") or None)
    engine = os.environ.get("LINEAR_TPU_ENGINE")
    # the engine the configuration states, whatever the caller's
    # environment says; the workers inherit it when they fork
    os.environ["LINEAR_TPU_ENGINE"] = flags.get("engine", "native")
    try:
        return _run(cell, seed, seconds, trace, device, control, tmp)
    finally:
        if engine is None:
            os.environ.pop("LINEAR_TPU_ENGINE", None)
        else:
            os.environ["LINEAR_TPU_ENGINE"] = engine
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, control, tmp):
    flags = cell["config"]["flags"]
    threads = threads_of(flags)
    ot = int(flags["output_type"])
    t = time.perf_counter()
    g_path, w_path, files, donor = make_data(cell, seed, tmp)
    log(f"data: genome and {len(files)} read files in "
        f"{time.perf_counter() - t:.3f} s")

    # ----------------------------------------------------------- set-up
    t0 = time.perf_counter()
    from linear_tpu_torch.map.mapper import Mapper, MapperConfig
    from linear_tpu_torch.parallel.pipeline import PipelineMapper

    t_imp_host = time.perf_counter() - t0
    cfg = MapperConfig(gap_len=int(flags["gap_len"]), output_type=ot,
                       threads=threads, index_type=int(flags["index_type"]),
                       feature_t=int(flags["feature_type"]),
                       bal_flag=int(flags["bal_flag"]), cmd_line="")
    t1 = time.perf_counter()
    mapper = Mapper([g_path], cfg, device=device)
    mapper.prepare()
    if not mapper.device_work():
        raise ValueError("the configuration gives the device no work: the "
                         "CLI maps it on the host engines")
    # -b 1: the pipeline forks its workers here; -b 0: the serial loop
    # tracing off whatever LINEAR_TPU_TRACE says: a traced run turns it on
    # for its window alone
    pipeline = (PipelineMapper(
        mapper, n_workers=max(1, min(threads, (os.cpu_count() or 1) + 1)),
        csize_workers=max(1, threads), trace=False)
        if cfg.bal_flag else None)
    t_prepare = time.perf_counter() - t1
    try:
        return _after_fork(cell, seed, seconds, trace, device, control,
                           files, donor, g_path, w_path, threads, ot, mapper,
                           pipeline, t0, t_imp_host, t_prepare, tmp)
    finally:
        # stops and joins the workers (a second close is a no-op)
        if pipeline is not None:
            pipeline.close()


def _after_fork(cell, seed, seconds, trace, device, control, files, donor,
                g_path, w_path, threads, ot, mapper, pipeline, t0, t_imp_host,
                t_prepare, tmp):
    t2 = time.perf_counter()
    import torch

    from linear_tpu_torch.ops import chain_dp, devbuild, extend_dev  # noqa: F401
    from linear_tpu_torch.ops import seeding as SD
    from linear_tpu_torch.out import bam as BAM
    from linear_tpu_torch.out import bamlink as BL
    from linear_tpu_torch.parallel.pipeline import PipeCounters
    from linear_tpu_torch.utils import seqio

    t_imp_dev = time.perf_counter() - t2
    t3 = time.perf_counter()
    chips = int(cell["workload"]["chips"])
    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= chips):
        raise NoCard(f"the cell asks for {chips} CUDA device(s); "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                     " available")
    mapper._ensure_dev_index()
    t4 = time.perf_counter()
    collect_bam = bool(ot & 12)
    counters = {}

    def blocks(path):
        """(block, cords_str, sam, BAM lines, reads) of each block of the
        read file, from the CLI's -b 1 pipeline or its -b 0 serial loop;
        counters["file"] is the file's PipeCounters."""
        if pipeline is not None:
            for br in pipeline.run(path, collect_bam=collect_bam,
                                   collect_cords=bool(ot & 1)):
                yield br.block, br.cords_str, br.sam, br.bam_lines, br.n
            counters["file"] = pipeline.counters
            return
        c = counters["file"] = PipeCounters()
        for block in seqio.read_blocks(path):
            cs, _, sam, *bl = mapper.map_block(block, counters=c,
                                               collect_bam=collect_bam)
            yield block, cs, sam, bl[0] if bl else [], len(block.seqs)

    def bam_digest(lines) -> str:
        """sha256 of the BAM files -ot 4 and -ot 8 ask for, written as the
        CLI writes them (out.bam.write_bam) into the run's temporary
        directory and removed once read."""
        h = hashlib.sha256()
        path = os.path.join(tmp, "pass.bam")
        for flag, header in ((4, mapper.sam_header), (8, lambda: (
                BL.sam_header_pbsv(mapper.genome_ids, mapper.genome_lens,
                                   mapper.cfg.read_group,
                                   mapper.cfg.sample_name,
                                   mapper.cfg.cmd_line)))):
            if ot & flag:
                BAM.write_bam(path, header(), mapper.genome_ids,
                              mapper.genome_lens, lines)
                with open(path, "rb") as f:
                    h.update(f.read())
                os.remove(path)
        return h.hexdigest()

    # warm-up: one pass of a small file of the cell's traffic, so that the
    # window finds the workers' engines, the seeding tiers' pinned buffers
    # and kernels, and the pages of the shared index already in use
    w_bam = []
    for block, cs, _, bl, _ in blocks(w_path):
        if ot & 1:
            mapper.apf_block(cs, block)
        w_bam.extend(bl)
    if collect_bam:
        bam_digest(w_bam)
    t_end_setup = time.perf_counter()
    setup = {"import_s": t_imp_host + t_imp_dev, "prepare_s": t_prepare,
             "device_s": t4 - t3, "warmup_s": t_end_setup - t4}
    setup_s = t_end_setup - t0

    # ------------------------------------------------- hooks of the window
    undo = []
    state = {"file": 0, "first": True}
    samples = [seed_sample(seed, lens) for _, _, _, lens in files]
    got_seeds: list = [dict() for _ in files]
    orig_stream = mapper._device_seed_stream2

    def tapped(chunks, **kw):
        want = samples[state["file"]] if state["first"] else ()
        rec = got_seeds[state["file"]]
        # traced, the pipeline's collector passes its counters= on
        for m_out, idxs, anchors in spans.iterate(orig_stream(chunks, **kw),
                                                  "seed.stream"):
            if want:
                for i, a in zip(idxs, anchors):
                    if i in want:
                        rec[i] = (m_out, None if a is None else a.copy())
            yield m_out, idxs, anchors

    mapper._device_seed_stream2 = tapped
    if control:
        # the control: a narrower seeding than the configuration states.
        # A read whose probe overflows the last tier keeps the anchors of
        # its first slots instead of being seeded on the host, and every
        # anchor loses its strand bit (61) on the way back from the device
        def narrowed(handle, n_valid, n_mask, m_out):
            anc, count, probed = SD._landed(handle)
            res, ov = [], np.zeros(n_valid, dtype=bool)
            for i in range(n_valid):
                if n_mask[i]:
                    res.append(None)
                elif probed[i] > m_out and m_out < TIERS[-1]:
                    res.append(None)
                    ov[i] = True
                else:
                    res.append(anc[i, : count[i]] & ~np.uint64(1 << 61))
            return res, ov

        collect = SD.collect_wire
        SD.collect_wire = narrowed
        undo.append(lambda: setattr(SD, "collect_wire", collect))
    spans = TR.Spans()
    spans.on = trace
    launches = []
    if trace:
        def after_collect(a, out):
            if spans.profiling:
                handle, _n_valid, _n_mask, m_out = a[:4]
                wire = handle.wire.numpy()
                lens = wire[:, -8:].copy().view(np.int64).ravel()
                probed = (handle.out.numpy()[:, -1] >> 32)
                launches.append((lens[: _n_valid], m_out,
                                 probed[: _n_valid]))

        spans.profiling = False
        undo.append(spans.wrap(SD, "pack_superchunk", "seed.pack"))
        undo.append(spans.wrap(SD, "dispatch_wire", "seed.dispatch"))
        undo.append(spans.wrap(SD, "collect_wire", "seed.collect",
                               after=after_collect))
        undo.append(spans.wrap(seqio, "parse_records_range", "reads.parse"))
        read_blocks = seqio.read_blocks
        seqio.read_blocks = lambda *a, **k: spans.iterate(
            read_blocks(*a, **k), "reads.block")
        undo.append(lambda: setattr(seqio, "read_blocks", read_blocks))
        pids = ([p.pid for p in pipeline.pool._pool]
                if pipeline is not None else [])

    # ----------------------------------------------------------- window
    # (file index, reads, sam digest, apf digest, bam digest, seeded,
    # fetched)
    passes = []
    texts = [None] * len(files)
    program = []    # each pass's PipeCounters

    def map_file(fi, first):
        """One pass of read file fi, consumed as the CLI's emit does."""
        state["file"], state["first"] = fi, first
        sam, apf, bam, n = [], [], [], 0
        tf0 = time.perf_counter_ns()
        for block, cs, sam_b, bl, n_b in spans.iterate(
                blocks(files[fi][0]),
                "drain.wait" if pipeline is not None else "map_block"):
            t_e = time.perf_counter_ns()
            if ot & 2:
                sam.append(sam_b)
            if ot & 1:
                apf.append(mapper.apf_block(cs, block))
            bam.extend(bl)
            n += n_b
            spans.add("emit", t_e, time.perf_counter_ns())
        if collect_bam:
            t_e = time.perf_counter_ns()
            d_bam = bam_digest(bam)
            spans.add("emit", t_e, time.perf_counter_ns())
        else:
            d_bam = ""
        tf1 = time.perf_counter_ns()
        sam_t, apf_t = "".join(sam), "".join(apf)
        c = counters["file"]
        program.append(c)
        passes.append((fi, n, hashlib.sha256(sam_t.encode()).hexdigest(),
                       hashlib.sha256(apf_t.encode()).hexdigest(), d_bam,
                       c.shipped_seeded, c.fetched))
        if texts[fi] is None:
            texts[fi] = (sam_t, apf_t)
        log(f"pass {len(passes) - 1}: file {fi}, {n} reads in "
            f"{(tf1 - tf0) / 1e9:.3f} s")
        return tf0, tf1

    if trace:
        if pipeline is not None:
            pipeline.trace = True
        cpu_main0 = procstat.cpu_seconds(os.getpid())
        cpu_work0 = procstat.total(pids)
    tw0 = time.perf_counter()
    k = 0
    while True:
        map_file(k % len(files), k < len(files))
        k += 1
        # every file of the pool once, then until `seconds` have passed
        if k >= len(files) and time.perf_counter() - tw0 >= seconds:
            break
    tw1 = time.perf_counter()
    window_s = tw1 - tw0
    n_window = len(passes)
    reads = sum(p[1] for p in passes)
    if trace:
        cpu_main = procstat.cpu_seconds(os.getpid()) - cpu_main0
        cpu_work = procstat.total(pids) - cpu_work0
        # one more pass of a steady file, after the window, under the
        # profiler: its trace gives the device metrics and the breakdown
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else [])) as prof:
            with record_function(TR.SYNC):
                sync_ns = time.perf_counter_ns()
            spans.profiling = True
            _, tf1 = map_file(min(1, len(files) - 1), False)
            spans.profiling = False
            if device == "cuda":
                torch.cuda.synchronize()
        if pipeline is not None:
            pipeline.trace = False
        prof_window = (sync_ns / 1e9, tf1 / 1e9)
        dev_events = TR.device_events(prof.events(), sync_ns)
    for u in reversed(undo):
        u()
    mapper._device_seed_stream2 = orig_stream

    # ------------------------------------- device state read back, freed
    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
                "count": int(cell["workload"]["chips"]),
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                      if device == "cuda" else 0),
                "power_limit": power_limit() if device == "cuda" else None,
                "host_cores": os.cpu_count()}
    di = mapper._dev_index
    dir_d = di.dir_start.cpu().numpy()
    hs_d = di.hs.cpu().numpy().view(np.uint64)
    mapper._dev_index = None
    del di
    if device == "cuda":
        torch.cuda.empty_cache()
    if pipeline is not None:
        pipeline.close()
    bad_mods = forbidden_modules()
    if bad_mods:
        raise RuntimeError(f"modules loaded that the port may not load: "
                           f"{', '.join(bad_mods)}")

    # ------------------------------------------------------------ check
    t = time.perf_counter()
    checks, failed = compare(cell, files, g_path, threads, ot, dir_d, hs_d,
                             got_seeds, samples, texts, passes, donor)
    log(f"check: reference and comparison in "
        f"{time.perf_counter() - t:.3f} s")
    # each read of the pool once: every file has its first pass in the
    # window, however many passes of it the window holds
    attempted = sum(len(files[fi][1]) for fi in range(len(files))
                    if texts[fi] is not None)
    out = {"setup_s": setup_s, "reads_per_s": reads / window_s,
           "attempted": attempted, "failed": failed, "checks": checks,
           "device": dev_info, "setup": setup, "window_s": window_s,
           "passes": len(passes)}
    if trace:
        eligible = 0
        for fi, *_ in passes[:n_window]:
            lens = files[fi][3]
            eligible += int(((lens > MIN_SEED_LEN)
                             & (lens <= MAX_SEED_LEN)).sum())
        p0, p1 = prof_window
        out["ctx"] = {
            "setup": setup, "window_s": window_s, "reads": reads,
            "cores": os.cpu_count(), "eligible": eligible,
            "shipped_seeded": sum(p[5] for p in passes[:n_window]),
            "workers": len(pids),
            "main_cpu_s": cpu_main, "workers_cpu_s": cpu_work,
            "superchunks": spans.count("seed.dispatch"),
            "superchunk_span_s": spans.total_s(
                {"seed.pack", "seed.dispatch", "seed.collect"}),
            "device_events": dev_events, "launches": launches,
            "trace_window": (p0, p1),
            "program": [c for c in program[:n_window] if c.trace],
        }
        out["device"]["busy_s"] = TR.busy_seconds(dev_events, p0, p1)
        out["device"]["window_s"] = p1 - p0
        out["breakdown"] = {
            "device_ops": TR.top_ops([e for e in dev_events
                                      if p0 <= e[1] <= p1]),
            "idle_gaps": TR.idle_gaps(dev_events, [s for s in spans.items
                                                   if s[0] != "file"],
                                      p0, p1),
            "idle_gaps_program": PG.idle_gaps_program(
                dev_events, program[-1].spans, p0, p1)}
    return out


def compare(cell, files, g_path, threads, ot, dir_d, hs_d, got_seeds,
            samples, texts, passes, donor):
    """{name: (value, limit)} of every number compared, and the reads of
    the pool with no primary record in their file's first pass."""
    limits = cell["limits"]
    checks = {}
    # the device index
    _, genomes = RF.read_fasta(g_path)
    dir_r, hs_r = RD.build(genomes, threads)
    n = min(len(hs_r), len(hs_d))
    bad = (int((dir_r != dir_d).sum()) if dir_r.shape == dir_d.shape
           else len(dir_r))
    bad += int((hs_r[:n] != hs_d[:n]).sum()) + abs(len(hs_r) - len(hs_d))
    checks["index_mismatch"] = bad
    # the device seeds of the sampled reads of each first pass
    bad = 0
    for fi, (path, _, _, _) in enumerate(files):
        if texts[fi] is None:
            continue
        _, reads = RF.read_fasta(path)
        for i in sorted(samples[fi]):
            r = reads[i]
            got = got_seeds[fi].get(i)
            if not (MIN_SEED_LEN < len(r) <= MAX_SEED_LEN):
                bad += got is not None
                continue
            anc, probed = RS.anchors(r, dir_r, hs_r)
            if probed <= TIERS[0]:
                want = (TIERS[0], anc)
            elif probed <= TIERS[1]:
                want = (TIERS[1], anc)
            else:
                want = (TIERS[1], None)
            ok = (got is not None and got[0] == want[0]
                  and (got[1] is None) == (want[1] is None)
                  and (want[1] is None or np.array_equal(got[1], want[1])))
            bad += not ok
    checks["seed_mismatch_reads"] = bad
    # placements of each first pass, digests of the later passes
    total = mis_sam = mis_apf = 0
    missing_by_file = {}
    for fi, (path, names, truth, _) in enumerate(files):
        if texts[fi] is None:
            continue
        sam_t, apf_t = texts[fi]
        uniq = np.flatnonzero(truth[:, 3])
        u_names = [names[i] for i in uniq.tolist()]
        total += len(uniq)
        if ot & 2:
            pl = RP.sam_primaries(sam_t)
            n_prim = pl.pop(None)
            # a read with more than one primary record is not placed either
            for nm, v in n_prim.items():
                if v > 1:
                    pl.pop(nm, None)
            mis_sam += RP.misplaced(pl, u_names, truth[uniq])
            missing_by_file[fi] = sum(1 for nm in names if nm not in n_prim)
        if ot & 1:
            mis_apf += RP.misplaced(RP.apf_first_blocks(apf_t), u_names,
                                    truth[uniq])
    first = {}
    digest_bad = 0
    for fi, n_reads, d_sam, d_apf, d_bam, *_ in passes:
        if fi in first:
            digest_bad += first[fi] != (n_reads, d_sam, d_apf, d_bam)
        else:
            first[fi] = (n_reads, d_sam, d_apf, d_bam)
    checks["digest_mismatch_passes"] = digest_bad
    if ot & 2:
        checks["sam_misplaced_pct"] = 100.0 * mis_sam / max(total, 1)
    if ot & 1:
        checks["apf_misplaced_pct"] = 100.0 * mis_apf / max(total, 1)
    if "donor" in cell["traffic"]:
        checks["sv_signal_missed_pct"] = sv_missed(donor, files, texts)
    failed = sum(missing_by_file.values())
    return {k: (v, limits[k]) for k, v in checks.items()}, failed


def sv_missed(donor, files, texts) -> float:
    """sv_signal_missed_pct of the first passes' SAM (reference/svsignal),
    the pool's reads taken together; the counts by SV type go to the
    log."""
    got = [fi for fi in range(len(files)) if texts[fi] is not None]
    names = [nm for fi in got for nm in files[fi][1]]
    truth = np.concatenate([files[fi][2] for fi in got])
    res = SVS.check(donor.svs, "\n".join(texts[fi][0] for fi in got),
                    names, truth[:, 4:6], truth[:, 6])
    for kind in DN.TYPES:
        of = [f for sv, _, f in res if sv.kind == kind]
        log(f"sv {kind}: {sum(of)} of {len(of)} counted found "
            f"({sum(sv.kind == kind for sv in donor.svs)} in the donor)")
    return SVS.missed_pct(res)
