"""Multi-process runs of the mesh path: map->SAM across ranks, and the steps
against one process (counterpart of tools/e2e_multiproc.py and of the grid
check of tools/dryrun_multiproc.py).

    python -m linear_tpu_torch.parallel.e2e [map] [--reads R --genome G]
        [--ranks 2] [--ix 1] [--pad 4096] [--threads 4] [--device cuda]
        [--backend nccl|gloo] [--out merged.sam]
    python -m linear_tpu_torch.parallel.e2e steps [--inputs world.npz]
        [--ranks 2] [--layouts 2x1,1x2] [--device cuda] [--backend ...]
        [--out steps.npz]

The parent spawns the ranks as fresh processes (never forks one that holds
CUDA), joined by torch.distributed through MASTER_ADDR/MASTER_PORT on
localhost, WORLD_SIZE and RANK; rank r takes device cuda:(r % cards) or the
CPU. The backend defaults to NCCL for cuda and gloo for cpu; ranks that
share one card must pass --backend gloo (NCCL refuses two ranks on one
device, and nothing here switches backends).

map: the ranks form a (ranks / ix, ix) grid. Tasks are fixed 8-read chunks
of the input, each mapped with fresh GapParms; dp block d of the grid owns
the reads of a contiguous run of tasks, and rank (d, i) maps every ix-th of
them. Each rank seeds its block on its device with grid_seed_anchors
(closed form over its xval shard, summed over ix) in launches of 256 rows,
compacts the rows (ops.seeding.compact_anchors, m_out 8192) and maps its
tasks with the native engine and those seeds; reads with N, longer than the
pad, or overflowing m_out take host seeds. The per-task SAM bytes are
all_gathered (padded, on CPU tensors, over a gloo group) and merged in input
order. The parent meanwhile maps every task in one process with host seeds,
and the run passes only if rank 0's merged SAM is byte-identical to it.
Without --reads/--genome the corpus is tools/e2e_multiproc.py's world: 64
reads on a 200 kb genome (seed 20260821).

steps: every rank runs, for each (dp, ix) layout, grid_mapping_step; for
(1, ranks) also index_sharded_seed_step; for (ranks, 1) also
sharded_mapping_step and, if the inputs hold an extension batch,
sharded_extend_step. Rank 0 writes the gathered outputs to --out; the
parent runs the single-device steps (mapping_step fast and scan, the
unsharded closed-form seeding, filter_extend) on its own device, adds them
as ref_*, and the run passes only if every layout equals them on the
masked-valid parts (anchors, p2, score and length below n_anchors; n,
overflow and the seeding grids whole). Without --inputs the world is
tools/dryrun_multiproc.py's: 8 reads of 1.5 kb at pad 2048 on a 30 kb
genome (seed 77), n_max 128.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

TASK = 8          # reads a task (the multi-worker -b 1 schedule)
CHUNK = 256       # rows of a dp block per seeding launch
M_OUT = 8192      # anchor slots a read after compaction
NAMES = ("anc", "n", "p2", "score", "length", "overflow")
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ------------------------------------------------------------------ worlds


def make_world():
    """tools/e2e_multiproc.py's corpus: (genome, reads, ids)."""
    from ..utils import seqio

    rng = np.random.default_rng(20260821)
    genome = rng.integers(0, 4, 200000).astype(np.uint8)
    reads, ids = [], []
    for i in range(64):
        ln = int(rng.integers(1200, 3500))
        pos = int(rng.integers(0, len(genome) - ln))
        r = genome[pos: pos + ln].copy()
        sub = rng.random(ln) < 0.06
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        kind = i % 4
        if kind == 1:
            r = seqio.revcomp(r)
        elif kind == 2:  # deletion SV (drives the gap module)
            mid = len(r) // 2
            r = np.concatenate([r[:mid], r[mid + 400:]])
        elif kind == 3:  # insertion SV
            mid = len(r) // 2
            ins = rng.integers(0, 4, 300).astype(np.uint8)
            r = np.concatenate([r[:mid], ins, r[mid:]])
        reads.append(r)
        ids.append(f"read{i} sim")
    return genome, reads, ids


def steps_world(path: str) -> None:
    """tools/dryrun_multiproc.py's world as a steps input file."""
    from ..index import dindex as DI

    rng = np.random.default_rng(77)
    genome = rng.integers(0, 4, 30000).astype(np.uint8)
    idx = DI.build_dindex([genome], 4)
    seqs = np.zeros((8, 2048), dtype=np.uint8)
    lens = np.zeros((8,), dtype=np.int64)
    for i in range(8):
        pos = int(rng.integers(0, len(genome) - 1500))
        r = genome[pos: pos + 1500].copy()
        sub = rng.random(len(r)) < 0.08
        r[sub] = (r[sub] + 1) % 4
        seqs[i, : len(r)] = r
        lens[i] = len(r)
    np.savez(path, seqs=seqs, lens=lens, dir=idx.dir, hs=idx.hs, n_max=128)


# --------------------------------------------------------------- processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv: list, n: int, log_dir: str):
    """Start n ranks of `python -m linear_tpu_torch.parallel.e2e argv
    --child`, each logging to log_dir/rank<r>.log."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               PYTHONPATH=_PKG_PARENT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    for r in range(n):
        log = open(os.path.join(log_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "linear_tpu_torch.parallel.e2e", *argv,
             "--child"], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def wait_ranks(procs, timeout: float) -> list:
    """Wait for every rank; once one fails or the time is up, stop the
    rest (they would wait in a collective). Returns the exit codes."""
    t_end = time.time() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            if time.time() > t_end or any(p.poll() not in (None, 0)
                                          for p, _ in procs):
                break
            time.sleep(0.1)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    return [p.returncode for p, _ in procs]


def _print_logs(log_dir: str, n: int) -> None:
    for r in range(n):
        with open(os.path.join(log_dir, f"rank{r}.log")) as fh:
            for line in fh:
                print(f"[rank {r}] {line}", end="", flush=True)


def _rank_device(device: str, backend: str, world: int) -> str:
    import torch

    if device == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    cards = torch.cuda.device_count()
    if backend == "nccl" and world > cards:
        raise RuntimeError(f"NCCL needs a card a rank: {world} ranks on "
                           f"{cards} card(s); pass --backend gloo")
    import torch.distributed as dist

    dev = f"cuda:{dist.get_rank() % cards}"
    torch.cuda.set_device(dev)
    return dev


def _parse_layouts(spec: str, ranks: int) -> list:
    if not spec:
        return [(d, ranks // d) for d in range(ranks, 0, -1) if ranks % d == 0]
    out = []
    for item in spec.split(","):
        d, i = (int(v) for v in item.lower().split("x"))
        if d * i != ranks:
            raise ValueError(f"layout {item}: {d * i} ranks, not {ranks}")
        out.append((d, i))
    return out


# --------------------------------------------------------------------- map


def _load_corpus(reads_fa: str, genome_fa: str, threads: int):
    from ..map.mapper import Mapper, MapperConfig
    from ..utils import seqio

    m = Mapper([genome_fa], MapperConfig(gap_len=50, threads=threads),
               device="host")
    m.prepare()
    ids, reads = [], []
    for block in seqio.read_blocks(reads_fa):
        ids += block.ids
        reads += block.seqs
    return m, reads, ids


def map_tasks(m, reads, ids, task_ids, seeds=None) -> dict:
    """Map the given tasks with fresh GapParms each; {task: SAM text}.
    seeds: {read index: uint64 anchors or None}; missing or None: host
    seeds."""
    out = {}
    for ti in task_ids:
        m.reset_gap_parms()
        parts = []
        for i in range(ti * TASK, min((ti + 1) * TASK, len(reads))):
            s = None if seeds is None else seeds.get(i)
            parts.append(m.native_map_read(reads[i], ids[i], seeds=s,
                                           tid=0)[2])
        out[ti] = "".join(parts)
    return out


def _layout(n_reads: int, n_dp: int, n_ix: int):
    """(rows of a dp block, owner rank of each task)."""
    n_tasks = -(-n_reads // TASK)
    rows = -(-n_tasks // n_dp) * TASK
    owner = []
    for ti in range(n_tasks):
        d = ti * TASK // rows
        owner.append(d * n_ix + (ti - d * rows // TASK) % n_ix)
    return rows, owner


def child_map(args) -> None:
    import torch
    import torch.distributed as dist

    from ..ops import seeding as SD
    from . import mesh as MS
    from .dist import init_distributed

    rank = init_distributed(args.backend)
    world = dist.get_world_size()
    n_ix = args.ix
    n_dp = world // n_ix
    device = _rank_device(args.device, args.backend, world)
    m, reads, ids = _load_corpus(args.reads, args.genome, args.threads)
    n = len(reads)
    mesh = MS.make_grid_mesh(n_dp, n_ix, device)
    shard = MS.local_index_shard(mesh, MS.shard_index_by_xval(m.index, n_ix))
    rows, owner = _layout(n, n_dp, n_ix)
    d = mesh.coord("dp")
    lo, hi = d * rows, min((d + 1) * rows, n)
    ch = min(CHUNK, rows)
    host_n = sum(1 for i in range(lo, hi) if (reads[i] == 4).any())
    host_pad = sum(1 for i in range(lo, hi)
                   if len(reads[i]) > args.pad and not (reads[i] == 4).any())

    def device_read(i):
        return not (reads[i] == 4).any() and len(reads[i]) <= args.pad

    # seed the dp block in launches of ch rows; every rank runs the same
    # launches, since the ix sum is a collective
    seeds, n_ovf = {}, 0
    t0 = time.time()
    for c0 in range(0, rows, ch):
        batch = np.zeros((n_dp * ch, args.pad), dtype=np.uint8)
        blens = np.zeros((n_dp * ch,), dtype=np.int64)
        for dd in range(n_dp):
            for j in range(ch):
                gi = dd * rows + c0 + j
                if gi < min((dd + 1) * rows, n) and device_read(gi):
                    batch[dd * ch + j, : len(reads[gi])] = reads[gi]
                    blens[dd * ch + j] = len(reads[gi])
        anc, keep = MS.grid_seed_anchors(mesh, batch, blens, shard)
        comp, count = SD.compact_anchors(anc, keep, M_OUT)
        del anc, keep
        comp = comp.cpu().numpy().view(np.uint64)
        count = count.cpu().numpy()
        for j in range(ch):
            gi = lo + c0 + j
            if gi < hi and device_read(gi):
                if count[j] > M_OUT:
                    n_ovf += 1
                else:
                    seeds[gi] = comp[j, : count[j]].copy()
    t_seed = time.time() - t0
    mine = [ti for ti, r in enumerate(owner) if r == rank]
    t0 = time.time()
    sams = map_tasks(m, reads, ids, mine, seeds)
    t_map = time.time() - t0
    print(f"(dp {d}, ix {mesh.coord('ix')}) on {device}: block of {hi - lo} "
          f"reads, seeded on the device {len(seeds)}, host seeds {host_n} "
          f"with N, {host_pad} over pad {args.pad}, {n_ovf} overflowing "
          f"m_out {M_OUT}; closed-form seeding launches {SD.fast_launches}, "
          f"compaction launches {SD.compact_launches}; seeding {t_seed:.3f} "
          f"s; {len(mine)} tasks mapped in {t_map:.3f} s", flush=True)

    # ordered merge: every rank's per-task SAM bytes, padded, over a gloo
    # group (host tensors whatever the mesh's backend)
    host = dist.new_group(backend="gloo")
    n_tasks = len(owner)
    payload = [sams.get(ti, "").encode() for ti in range(n_tasks)]
    width = torch.tensor([max([len(p) for p in payload] + [1])])
    dist.all_reduce(width, op=dist.ReduceOp.MAX, group=host)
    buf = torch.zeros((n_tasks, int(width)), dtype=torch.uint8)
    lens = torch.zeros((n_tasks,), dtype=torch.int64)
    for ti, p in enumerate(payload):
        if p:
            buf[ti, : len(p)] = torch.frombuffer(bytearray(p), dtype=torch.uint8)
        lens[ti] = len(p)
    bufs = [torch.empty_like(buf) for _ in range(world)]
    all_lens = [torch.empty_like(lens) for _ in range(world)]
    dist.all_gather(bufs, buf, group=host)
    dist.all_gather(all_lens, lens, group=host)
    if rank == 0:
        merged = [bufs[owner[ti]][ti, : int(all_lens[owner[ti]][ti])]
                  .numpy().tobytes() for ti in range(n_tasks)]
        with open(args.out, "wb") as fh:
            fh.write(m.sam_header().encode() + b"".join(merged))
    dist.barrier(group=host)
    dist.destroy_process_group()


def main_map(args) -> int:
    from ..utils import seqio

    work = tempfile.mkdtemp(prefix="lt_e2e_")
    if not args.reads:
        genome, reads, ids = make_world()
        args.genome = os.path.join(work, "g.fa")
        args.reads = os.path.join(work, "r.fa")
        seqio.write_fasta(args.genome, ["chrE2E"], [genome])
        seqio.write_fasta(args.reads, ids, reads)
    if args.ranks % args.ix:
        raise ValueError(f"--ix {args.ix} does not divide --ranks {args.ranks}")
    args.out = args.out or os.path.join(work, "merged.sam")
    argv = ["map", "--reads", args.reads, "--genome", args.genome,
            "--ix", str(args.ix), "--pad", str(args.pad), "--threads",
            str(args.threads), "--device", args.device, "--backend",
            args.backend, "--out", args.out]
    t0 = time.time()
    procs = spawn_ranks(argv, args.ranks, work)
    # meanwhile: every task in this process, host seeds
    m, reads, ids = _load_corpus(args.reads, args.genome, args.threads)
    n_tasks = -(-len(reads) // TASK)
    want = m.sam_header().encode() + "".join(
        map_tasks(m, reads, ids, range(n_tasks)).values()).encode()
    t_single = time.time() - t0
    rcs = wait_ranks(procs, args.timeout)
    _print_logs(work, args.ranks)
    if rcs != [0] * args.ranks:
        print(f"e2e: rank exit codes {rcs} (logs in {work})", file=sys.stderr)
        return 1
    with open(args.out, "rb") as fh:
        got = fh.read()
    if got != want:
        ref = os.path.join(work, "single.sam")
        with open(ref, "wb") as fh:
            fh.write(want)
        print(f"e2e: the merged SAM {args.out} differs from the "
              f"single-process SAM {ref}", file=sys.stderr)
        return 1
    n_dp = args.ranks // args.ix
    print(f"E2E OK: {len(reads)} reads, {n_tasks} tasks over {args.ranks} "
          f"ranks (dp {n_dp}, ix {args.ix}, {args.device}, {args.backend}): "
          f"merged SAM byte-identical to the single-process host-seeded run "
          f"({len(got)} bytes); single process {t_single:.3f} s, whole run "
          f"{time.time() - t0:.3f} s", flush=True)
    return 0


# ------------------------------------------------------------------- steps


def _extension(data, device):
    """The inputs' extension batch on `device`, or None."""
    import torch

    from ..ops import extend_dev as ED

    if "ext_packed" not in data:
        return None
    gf = ED.GenomeFeats(
        *(torch.from_numpy(data[k]).to(device)
          for k in ("gf_cat", "gf_off", "gf_rows")))
    args = [data[k] for k in ("ext_packed", "ext_lens", "ext_hits",
                              "ext_n_hits")]
    return args, gf, int(data["ext_C"])


def child_steps(args) -> None:
    import torch.distributed as dist

    from ..ops import chain_dp as CD
    from ..ops import seeding as SD
    from . import mesh as MS
    from .dist import init_distributed

    rank = init_distributed(args.backend)
    world = dist.get_world_size()
    device = _rank_device(args.device, args.backend, world)
    data = dict(np.load(args.inputs))
    seqs, lens = data["seqs"], data["lens"]
    index = SimpleNamespace(dir=data["dir"], hs=data["hs"])
    n_max = int(data["n_max"])
    ext = _extension(data, device)
    res = {}
    for n_dp, n_ix in _parse_layouts(args.layouts, world):
        tag = f"{n_dp}x{n_ix}"
        mesh = MS.make_grid_mesh(n_dp, n_ix, device)
        shard = MS.local_index_shard(mesh, MS.shard_index_by_xval(index, n_ix))
        out = MS.grid_mapping_step(mesh, seqs, lens, shard, n_max)
        for name, t in zip(NAMES, out):
            res[f"grid_{tag}_{name}"] = MS.gather(mesh, t).numpy()
        if n_dp == 1:
            ix = MS.Mesh((n_ix,), ("ix",), device)
            anc, keep = MS.index_sharded_seed_step(
                ix, seqs, lens, MS.local_index_shard(
                    ix, MS.shard_index_by_xval(index, n_ix)))
            res[f"ix{n_ix}_anc"] = anc.cpu().numpy()
            res[f"ix{n_ix}_keep"] = keep.cpu().numpy()
        if n_ix == 1:
            dp = MS.make_dp_mesh(device)
            out = MS.sharded_mapping_step(
                dp, seqs, lens, data["dir"].astype(np.int32),
                data["hs"].view(np.int64), shard.cap, n_max)
            for name, t in zip(NAMES, out):
                res[f"dp{n_dp}_map_{name}"] = MS.gather(dp, t).numpy()
            if ext is not None:
                e_args, gf, C = ext
                out = MS.sharded_extend_step(dp, *e_args, gf, C)
                for name, t in zip(("cords", "ncords", "ovf"), out):
                    res[f"dp{n_dp}_ext_{name}"] = MS.gather(dp, t).numpy()
    print(f"rank {rank} on {device}: layouts {args.layouts or 'all'}; "
          f"closed-form seeding launches {SD.fast_launches}, scan seeding "
          f"launches {SD.scan_launches}, anchor sort launches "
          f"{CD.sort_launches}", flush=True)
    if rank == 0:
        np.savez(args.out, **res)
    dist.barrier()
    dist.destroy_process_group()


def _masked_equal(got: dict, want: dict) -> bool:
    """The mapping step's outputs: n and overflow whole; anchors, p2,
    score and length below n (the sort's tail holds unkept slots)."""
    n = want["n"]
    if not (np.array_equal(got["n"], n)
            and np.array_equal(got["overflow"], want["overflow"])):
        return False
    for name in ("anc", "p2", "score", "length"):
        g, w = got[name], want[name]
        if g.shape != w.shape:
            return False
        msk = np.arange(w.shape[1])[None, :] < n[:, None]
        if not np.array_equal(np.where(msk, g, 0), np.where(msk, w, 0)):
            return False
    return True


def main_steps(args) -> int:
    import torch

    from ..ops import extend_dev as ED
    from ..ops import seeding as SD
    from . import mesh as MS

    work = tempfile.mkdtemp(prefix="lt_steps_")
    if not args.inputs:
        args.inputs = os.path.join(work, "world.npz")
        steps_world(args.inputs)
    args.out = args.out or os.path.join(work, "steps.npz")
    layouts = _parse_layouts(args.layouts, args.ranks)
    argv = ["steps", "--inputs", args.inputs, "--device", args.device,
            "--backend", args.backend, "--out", args.out]
    if args.layouts:
        argv += ["--layouts", args.layouts]
    procs = spawn_ranks(argv, args.ranks, work)
    # meanwhile: the single-device steps on this process's device
    device = "cpu" if args.device == "cpu" else "cuda"
    data = dict(np.load(args.inputs))
    seqs = torch.from_numpy(data["seqs"]).to(device)
    lens = torch.from_numpy(data["lens"]).to(device)
    index = SD.upload_index(data["dir"], data["hs"], device)
    n_max = int(data["n_max"])
    ref = {}
    for fast in (True, False):
        out = MS.mapping_step(seqs, lens, index.dir_start, index.hs,
                              index.cap, n_max, fast=fast)
        for name, t in zip(NAMES, out):
            ref[f"ref_{'fast' if fast else 'scan'}_{name}"] = t.cpu().numpy()
    anc, keep = SD.batch_seed_anchors_fast(seqs, lens, index.dir_start,
                                           index.hs, index.cap)
    ref["ref_seed_anc"], ref["ref_seed_keep"] = (anc.cpu().numpy(),
                                                 keep.cpu().numpy())
    ext = _extension(data, device)
    if ext is not None:
        e_args, gf, C = ext
        out = ED.filter_extend(*(torch.from_numpy(a).to(device)
                                 for a in e_args), gf, C)
        for name, t in zip(("cords", "ncords", "ovf"), out):
            ref[f"ref_ext_{name}"] = t.cpu().numpy()
    rcs = wait_ranks(procs, args.timeout)
    _print_logs(work, args.ranks)
    if rcs != [0] * args.ranks:
        print(f"steps: rank exit codes {rcs} (logs in {work})", file=sys.stderr)
        return 1
    res = dict(np.load(args.out))
    bad = []

    def step(prefix):
        return {k: res[f"{prefix}_{k}"] for k in NAMES}

    fast = {k: ref[f"ref_fast_{k}"] for k in NAMES}
    scan = {k: ref[f"ref_scan_{k}"] for k in NAMES}
    for n_dp, n_ix in layouts:
        tag = f"{n_dp}x{n_ix}"
        if not _masked_equal(step(f"grid_{tag}"), fast):
            bad.append(f"grid_mapping_step {tag}")
        if n_dp == 1 and not (
                np.array_equal(res[f"ix{n_ix}_anc"], ref["ref_seed_anc"])
                and np.array_equal(res[f"ix{n_ix}_keep"],
                                   ref["ref_seed_keep"])):
            bad.append(f"index_sharded_seed_step ix {n_ix}")
        if n_ix == 1:
            if not _masked_equal(step(f"dp{n_dp}_map"), scan):
                bad.append(f"sharded_mapping_step dp {n_dp}")
            if ext is not None and not all(
                    np.array_equal(res[f"dp{n_dp}_ext_{k}"], ref[f"ref_ext_{k}"])
                    for k in ("cords", "ncords", "ovf")):
                bad.append(f"sharded_extend_step dp {n_dp}")
    np.savez(args.out, **res, **ref)
    if bad:
        print("steps: differ from one device: " + ", ".join(bad),
              file=sys.stderr)
        return 1
    n = ref["ref_fast_n"]
    print(f"STEPS OK: {args.ranks} ranks ({args.device}, {args.backend}), "
          f"layouts {' '.join(f'{d}x{i}' for d, i in layouts)}: every step "
          f"equals one device; batch {tuple(data['seqs'].shape)}, n_max "
          f"{n_max}, anchors kept {int(ref['ref_seed_keep'].sum())}, chained "
          f"rows {int((n > 0).sum())}", flush=True)
    return 0


# ---------------------------------------------------------------------- cli


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m linear_tpu_torch.parallel.e2e",
                                description=__doc__.split("\n")[0])
    p.add_argument("mode", nargs="?", default="map", choices=["map", "steps"])
    p.add_argument("--reads", default="")
    p.add_argument("--genome", default="")
    p.add_argument("--inputs", default="", help="steps: the world .npz")
    p.add_argument("--layouts", default="",
                   help="steps: comma-separated DPxIX (default: every split)")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--ix", type=int, default=1, help="map: xval shards")
    p.add_argument("--pad", type=int, default=4096)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl for cuda, gloo for cpu")
    p.add_argument("--out", default="")
    p.add_argument("--timeout", type=float, default=1800.0)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.backend is None:
        args.backend = "nccl" if args.device == "cuda" else "gloo"
    if args.child:
        (child_map if args.mode == "map" else child_steps)(args)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("e2e: --device cuda: no CUDA device is available",
                  file=sys.stderr)
            return 1
    return (main_map if args.mode == "map" else main_steps)(args)


if __name__ == "__main__":
    sys.exit(main())
