"""Time some of the port's CUDA kernels on synthetic inputs, in this checkout
or side by side in several.

    python -m linear_tpu_torch.kernel_times
    python linear_tpu_torch/kernel_times.py --roots A B C --out times.json
    python -m linear_tpu_torch.kernel_times --busy jobs.pt

--busy times the calls that chip_smoke.py queued in a file (see busy()) in
this fresh process and prints their busy times as one JSON line.

A root is a checkout (a directory that holds linear_tpu_torch/). With
--roots the kernels of every root are built at once, one process each, and
then the roots are timed in the order given and again in reverse (A B C C B
A; a root may be named more than once), each turn in a process of its own
that imports that root's package. Every turn times every case on the same
inputs, made from --seed with numpy: "ms" is a call of the entry point by
CUDA events over --iters calls after a warm one (host work included),
"host_ms" the host's time to issue a call (the floor of "ms" when the card
is the faster), "device_ms" the card's busy time a call by torch.profiler
("device_parts": each kernel's share; "device_events": each kernel's
traced count over "iters" calls). "sha" is a digest of the case's
outputs, so two roots that agree show the same one; a
case that a root refuses (ValueError) reads "refused". It prints a JSON
line a turn and a table of each root's turns, and writes the card's name
and power limit (nvidia-smi) with the turns to --out.

The cases: the windowed chain DP on (256, 512) rows at W 1, 33, 64 and 128;
the full chain DP on the same rows, on (64, 8192) and (256, 8192)
long-read rows and on (4, 12288) and (4, 20480) rows (two long-read rows,
one chain of 12,288 or 20,480 anchors, 3,000 of them shuffled; at 20,480
the tables lie in the device scratch); the gap anchors on 512 items at the defaults (1024, 4096,
16, 2048) and on 16 items near 2^30; the banded alignment on 625 pairs of
up to 7,000 bases at W 100, 128 and 600 and on 16 of them cut to 1,000
bases at W 16,385 (the wide branch); the seed superchunk kernel at
(rows, pad, m_out) =
(1024, 8192, 128) and (256, 8192, 512), and the anchor sort of the scan
grid (256, 191,488) at n_max 256 and 8192 and its compaction (K3) at m_out
1024 and 8192, on a corpus made as chip_smoke.py makes its own
(seed_corpus). --cases keeps the cases whose name holds one
of the words given.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np


def _anchor(x, y):
    """Anchors whose getAnchorX is x and whose read position is y."""
    return ((x - y + (1 << 20)) << 20) + y


def chain_rows(rng, B: int, lo: int, hi: int, read_len: int):
    """B rows of lo..hi anchors: three quarters along one diagonal with a
    drift of a few bases (a read's true hits, 15 bases apart on average),
    the rest scattered within 50 kb of it; sorted descending by anchor-x
    as the kernels take them."""
    rows = []
    for _ in range(B):
        n = int(rng.integers(lo, hi + 1))
        n_true = 3 * n // 4
        y = np.sort(rng.choice(read_len, n_true, replace=False))
        x0 = int(rng.integers(100_000, 4_000_000))
        x = x0 + y + np.cumsum(rng.integers(-2, 3, n_true))
        yn = rng.integers(0, read_len, n - n_true)
        xn = x0 + rng.integers(-50_000, 50_000, n - n_true)
        xs = np.concatenate([x, xn]).astype(np.int64)
        ys = np.concatenate([y, yn]).astype(np.int64)
        order = np.argsort(-xs, kind="stable")
        rows.append(_anchor(xs[order], ys[order]))
    return rows


def pad_rows(rows, N: int):
    arr = np.zeros((len(rows), N), dtype=np.int64)
    cnt = np.zeros((len(rows),), dtype=np.int32)
    for k, r in enumerate(rows):
        arr[k, : len(r)] = r
        cnt[k] = len(r)
    return arr, cnt


def mutate(rng, seq, rate: float = 0.08):
    out = seq.copy()
    sub = rng.random(len(out)) < rate
    out[sub] = (out[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    return out.astype(np.uint8)


def gap_items(rng, genome, n: int, near: bool):
    """Gap-interval items: genome windows of 200-5,124 bases and read
    windows of 200-4,096 from a mutated copy of the genome there, every
    other item bounded to +-500 around the true diagonal; `near` puts the
    windows' starts within 5 g_max of 2^30 and fills g_max and r_max."""
    items = []
    for t in range(n):
        glen = 5120 if near else int(rng.integers(200, 5125))
        rlen = 4096 if near else int(rng.integers(200, 4097))
        gs = int(rng.integers(0, len(genome) - 10_000))
        rs = gs + int(rng.integers(0, 100))
        read = mutate(rng, genome[rs: rs + rlen + 500])
        bounded = t % 2 == 1
        items.append({"gwin": genome[gs: gs + glen + 8], "g_n": glen,
                      "gpos0": (1 << 30) - 1500 - 700 * t if near else gs,
                      "rwin": read[: rlen + 8], "r_n": rlen, "rpos0": 0,
                      "rvcp": len(read) - 1,
                      "a_lo": gs - rs - 500 if bounded else -(1 << 40),
                      "a_hi": gs - rs + 500 if bounded else 1 << 40})
    return items


def band_pairs(rng, n: int):
    """Query and reference pairs of 200-7,000 bases: the query a copy of
    the reference with 10 % substitutions and a few short indels."""
    qry, ref = [], []
    for _ in range(n):
        r = rng.integers(0, 4, int(rng.integers(200, 7001))).astype(np.uint8)
        q = mutate(rng, r, 0.10)
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(q)))
            k = int(rng.integers(1, 6))
            q = (np.delete(q, range(p, min(p + k, len(q))))
                 if rng.random() < 0.5 else
                 np.insert(q, p, rng.integers(0, 4, k).astype(np.uint8)))
        qry.append(q[:7000])
        ref.append(r)
    return qry, ref


# the seed and sort cases: chip_smoke.py's corpus genome and reads (its
# DIndex built on the card from the genome with its N replaced), the seed
# kernel's two m_out tiers at the corpus' pad, and the scan grid of the
# mesh path at the corpus index's cap (P * cap = 544 * 352 = 191,488 slots a
# row) sorted at the mapping steps' n_max and at the chain DP's widest
CORPUS_GENOME, CORPUS_READ_LEN, CORPUS_PAD = 4_600_000, 7000, 8192
SEED_TIERS = ((1024, 128), (256, 512))
SORT_B, SORT_CAP, SORT_N_MAXES = 256, 352, (256, 8192)
COMPACT_M_OUTS = (1024, 8192)


def seed_corpus(rng, genome_len: int, n_reads: int, device, threads: int = 8):
    """(index, reads): a genome of genome_len bases as chip_smoke.py makes
    its corpus (make_genomic_genome), its DIndex built on `device` from the
    genome with every N replaced by a random base, and n_reads reads of
    about 7 kb simulated from the genome with its N (simulate_reads)."""
    from linear_tpu_torch.ops import devbuild as DB
    from linear_tpu_torch.utils import simdata

    genome = simdata.make_genomic_genome(rng, genome_len)
    g = genome.copy()
    n = g == 4
    g[n] = rng.integers(0, 4, int(n.sum()))
    index = DB.device_build_to_index(*DB.build_dindex_device([g], device,
                                                             threads))
    reads = simdata.simulate_reads(rng, genome, n_reads,
                                   min(CORPUS_READ_LEN, genome_len // 4))
    return index, reads


def seed_inputs(index, reads, rows: int, pad: int):
    """The wire of the first `rows` reads on the index's device."""
    import torch

    from linear_tpu_torch.ops import seeding as SD

    wire, _ = SD.pack_superchunk(reads[:rows], pad, rows)
    return torch.from_numpy(wire).to(index.device)


def sort_inputs(index, reads, B: int, pad: int, cap: int):
    """The scan grid (anchors, keep), each (B, P, cap), of the first B
    reads: what the mesh's mapping step sorts."""
    import torch

    from linear_tpu_torch.ops import seeding as SD

    seqs, lens = SD.pad_reads(reads[:B], pad)
    dev = index.device
    return SD.batch_seed_anchors(torch.from_numpy(seqs).to(dev),
                                 torch.from_numpy(lens).to(dev),
                                 index.dir_start, index.hs, cap)


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        h.update(t.detach().to("cpu").contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def defined_seeds(res):
    """The defined part of seed_superchunk's rows: anchors[:count] (the
    rest zeroed) and the tail column."""
    import torch

    m_out = res.shape[1] - 1
    cols = torch.arange(m_out, device=res.device)[None, :]
    live = cols < (res[:, -1:] & 0xFFFFFFFF)
    return torch.where(live, res[:, :-1], 0), res[:, -1]


def seed_sort_cases(seed: int, dev: str = "cuda"):
    """(name, fn, digest view) of the seed superchunk, anchor sort and
    compaction cases, from their own numpy generator."""
    from linear_tpu_torch.ops import chain_dp as CD
    from linear_tpu_torch.ops import seeding as SD

    index, reads = seed_corpus(np.random.default_rng(seed), CORPUS_GENOME,
                               SEED_TIERS[0][0], dev)
    out = []
    for rows, m_out in SEED_TIERS:
        w = seed_inputs(index, reads, rows, CORPUS_PAD)

        out.append((f"seed_superchunk ({rows}, {CORPUS_PAD}, {m_out})",
                    lambda w=w, m_out=m_out: SD.seed_superchunk(w, index,
                                                                m_out),
                    defined_seeds))
    anc, keep = sort_inputs(index, reads, SORT_B, CORPUS_PAD, SORT_CAP)
    n = anc[0].numel()
    for n_max in SORT_N_MAXES:
        out.append((f"sort_anchors ({SORT_B}, {n}) -> {n_max}",
                    lambda n_max=n_max: CD.sort_anchors(anc, keep, n_max),
                    None))
    for m_out in COMPACT_M_OUTS:
        out.append((f"compact_anchors ({SORT_B}, {n}) -> {m_out}",
                    lambda m_out=m_out: SD.compact_anchors(anc, keep, m_out),
                    None))
    return out


def cases(seed: int, words=None):
    """(name, fn, digest view or None) for every case whose name holds one
    of `words` (all without), the inputs on the card."""
    def wanted(*names):
        return words is None or any(w in n for w in words for n in names)

    out = []
    if wanted("chain_dp", "gap_anchors", "banded_align"):
        out += [c + (None,) for c in _older_cases(seed)]
    if wanted("seed_superchunk", "sort_anchors", "compact_anchors"):
        out += seed_sort_cases(seed)
    return [c for c in out if wanted(c[0])]


def _older_cases(seed: int):
    """(name, fn) of the chain DP, gap anchor and banded alignment cases,
    from one numpy generator."""
    import torch

    from linear_tpu_torch.ops import align_pallas as AP
    from linear_tpu_torch.ops import chain_dp as CD
    from linear_tpu_torch.ops import gap_dev as GD

    rng = np.random.default_rng(seed)
    dev = "cuda"
    arr, cnt = pad_rows(chain_rows(rng, 256, 65, 512, 7000), 512)
    a512, c512 = torch.from_numpy(arr).to(dev), torch.from_numpy(cnt).to(dev)
    arr, cnt = pad_rows(chain_rows(rng, 64, 513, 8192, 120_000), 8192)
    a8k, c8k = torch.from_numpy(arr).to(dev), torch.from_numpy(cnt).to(dev)
    out = [(f"chain_dp_windowed (256, 512) W {W}",
            lambda W=W: CD.chain_dp_windowed(a512, c512, W=W))
           for W in (1, 33, 64, 128)]
    arr, cnt = pad_rows(wide_rows(rng), WIDE_N)
    a12k, c12k = torch.from_numpy(arr).to(dev), torch.from_numpy(cnt).to(dev)
    arr, cnt = pad_rows(wide_rows(np.random.default_rng(seed + 2),
                                  SCRATCH_N), SCRATCH_N)
    a20k, c20k = torch.from_numpy(arr).to(dev), torch.from_numpy(cnt).to(dev)
    # a full launch of the smoke's width, from a generator of its own (the
    # other cases' inputs stay as they were)
    arr, cnt = pad_rows(chain_rows(np.random.default_rng(seed + 1), 256, 513,
                                   8192, 120_000), 8192)
    a256, c256 = torch.from_numpy(arr).to(dev), torch.from_numpy(cnt).to(dev)
    out += [("chain_dp (256, 512)", lambda: CD.chain_dp(a512, c512)),
            ("chain_dp (64, 8192)", lambda: CD.chain_dp(a8k, c8k)),
            ("chain_dp (256, 8192)", lambda: CD.chain_dp(a256, c256)),
            (f"chain_dp (4, {WIDE_N})", lambda: CD.chain_dp(a12k, c12k)),
            (f"chain_dp (4, {SCRATCH_N})", lambda: CD.chain_dp(a20k, c20k))]
    genome = rng.integers(0, 4, 2_000_000).astype(np.uint8)
    for n, near, tag in ((512, False, "512 items"),
                         (16, True, "16 items near 2^30")):
        packed = [torch.from_numpy(x).to(dev) for x in
                  GD.pack_items(gap_items(rng, genome, n, near))]
        out.append((f"gap_anchors {tag}",
                    lambda p=packed: GD.gap_anchors(*p, 1024, 4096, 16, 2048)))
    qry, ref = band_pairs(rng, 625)
    for W in (100, 128, 600):
        a, bpad, nm = (torch.from_numpy(x).to(dev)
                       for x in AP.pack_pairs(qry, ref, W))
        out.append((f"banded_align (625, {a.shape[1]}) W {W}",
                    lambda a=a, b=bpad, m=nm, W=W: AP.banded_align(a, b, m, W)))
    W = BANDED_WIDE_W
    a, bpad, nm = (torch.from_numpy(x).to(dev) for x in AP.pack_pairs(
        [q[:1000] for q in qry[:16]], [r[:1000] for r in ref[:16]], W))
    out.append((f"banded_align (16, {a.shape[1]}) W {W}",
                lambda a=a, b=bpad, m=nm: AP.banded_align(a, b, m, W)))
    return out


# the full DP's wide cases: past the 11,622 anchors a row that its first
# design kept in shared memory, and past the 18,944 of its redesign (the
# tables in the device scratch); and the banded alignment's first W past the
# register design
WIDE_N = 12288
SCRATCH_N = 20480
BANDED_WIDE_W = 16385
# cases whose calls take milliseconds: a tenth of the iterations
SLOW_CASES = ("chain_dp (64, 8192)", "chain_dp (256, 8192)",
              f"chain_dp (4, {WIDE_N})", f"chain_dp (4, {SCRATCH_N})",
              f"W {BANDED_WIDE_W}")


def wide_rows(rng, n: int = WIDE_N):
    """The full DP's rows past its old shared-memory limit, as chip_smoke.py
    builds them: two long-read rows of 4,000-8,192 anchors (chain_rows),
    one chain of n anchors 20 apart in x and y (every column chained), and
    3,000 anchors of that chain shuffled (JAX's mask, not the sort, decides
    there)."""
    chain = _anchor(600000 - 20 * np.arange(n, dtype=np.int64),
                    900000 - 20 * np.arange(n, dtype=np.int64))
    return chain_rows(rng, 2, 4000, 8192, 120_000) + [
        chain, chain[rng.permutation(3000)]]


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


def host_ms(fn, iters: int) -> float:
    """The host's time to issue a call (ms, the host clock over iters calls
    that are not waited for; the card then catches up): the floor of a
    CUDA-event time when the card's share is smaller."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def device_ms(fn, iters: int, parts=None, counts=None) -> float:
    """The card's busy time a call: the device events torch.profiler
    traces over iters calls, after a warm one. A kernel traced count times
    counts count / iters launches a call at its mean; the profiler at times
    delivers fewer events than a window launched (seen on the H100 for
    long kernels: one of five), and such a kernel then counts one launch a
    call. `parts`, a dict, gets each device event's name (its first 48
    characters) and its time a call; `counts` its traced count over the
    iters calls, which shows a dropped event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.count:
            continue
        a_call = (e.self_device_time_total / e.count / 1e3
                  * max(1, round(e.count / iters)))
        total += a_call
        if parts is not None:
            parts[e.key[:48]] = a_call
        if counts is not None:
            counts[e.key[:48]] = e.count
    return total


def run_here(seed: int, iters: int, words=None) -> dict:
    """Every case (of `words`) in this process, on the package it
    imports."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    import linear_tpu_torch
    from linear_tpu_torch.ops import _cuda

    _cuda.lib()
    res = {"root": os.path.dirname(os.path.dirname(
        os.path.abspath(linear_tpu_torch.__file__))), "cases": {}}
    for name, fn, view in cases(seed, words):
        try:
            out = fn()
        except ValueError as e:
            res["cases"][name] = {"refused": str(e)[:120]}
            continue
        torch.cuda.synchronize()
        n = (max(1, iters // 10) if any(w in name for w in SLOW_CASES)
             else iters)
        parts, counts = {}, {}
        res["cases"][name] = {"ms": time_ms(fn, n),
                              "host_ms": host_ms(fn, n),
                              "device_ms": device_ms(fn, n, parts, counts),
                              "device_parts": parts,
                              "device_events": counts, "iters": n,
                              "sha": _digest(view(out) if view else out)}
    return res


def busy(path: str, windows: int = 3) -> list:
    """The card's busy time a call of each job in the file `path`
    (torch.save of (entry point "module:name", args, kwargs, iters, launch
    counter "module:name") tuples, chip_smoke.py's queue), in this fresh
    process: device_ms over iters calls, the inputs moved to the card, each
    tensor once. A window in which the profiler traced no device event is
    traced again, windows times at most, and then the job's time is None.
    Returns per job {"device_ms", "windows": [{"events", "launches"}]}, the
    traced count of each device event beside the kernel launches the window
    made by the entry point's counter."""
    import dataclasses
    import importlib

    import torch

    from linear_tpu_torch.ops import _cuda

    _cuda.lib()
    on_card = {}

    def cuda(obj):
        if isinstance(obj, torch.Tensor):
            if id(obj) not in on_card:
                on_card[id(obj)] = (obj, obj.cuda())
            return on_card[id(obj)][1]
        if isinstance(obj, (list, tuple)):
            return type(obj)(cuda(o) for o in obj)
        if isinstance(obj, dict):
            return {k: cuda(v) for k, v in obj.items()}
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{
                f.name: cuda(getattr(obj, f.name))
                for f in dataclasses.fields(obj)})
        return obj

    def attr(path):
        mod, name = path.split(":")
        return importlib.import_module(mod), name

    out = []
    for fn_path, args, kw, iters, counter in torch.load(path,
                                                        weights_only=False):
        mod, name = attr(fn_path)
        fn = getattr(mod, name)
        cmod, cname = attr(counter)
        a, k = cuda(args), cuda(kw)
        res = {"device_ms": None, "windows": []}
        for _ in range(windows):
            counts = {}
            before = getattr(cmod, cname)
            ms = device_ms(lambda: fn(*a, **k), iters, counts=counts)
            res["windows"].append({"events": counts, "launches": (
                getattr(cmod, cname) - before) * iters // (iters + 1)})
            if counts:
                res["device_ms"] = ms
                break
        out.append(res)
    return out


def _child(root: str, argv: list) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="*", default=None)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cases", nargs="*", default=None,
                    help="time only the cases whose name holds one of these")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--busy", default=None, metavar="JOBS",
                    help="the busy time of each call queued in this file "
                         "(chip_smoke.py): one JSON line")
    args = ap.parse_args(argv)
    if args.busy:
        print(json.dumps(busy(args.busy)))
        return 0
    if args.build_only:
        from linear_tpu_torch.ops import _cuda

        _cuda.build()
        return 0
    if not args.roots:
        print(json.dumps(run_here(args.seed, args.iters, args.cases)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    order = [os.path.abspath(r) for r in args.roots]
    roots = list(dict.fromkeys(order))
    builds = [_child(r, ["--build-only"]) for r in roots]
    if any(p.wait() for p in builds):
        raise SystemExit("a root's kernels did not build")
    turns = []
    for root in order + order[::-1]:
        p = _child(root, ["--seed", str(args.seed), "--iters",
                          str(args.iters)]
                   + (["--cases", *args.cases] if args.cases else []))
        line = p.communicate()[0].strip().splitlines()[-1]
        if p.returncode:
            raise SystemExit(f"the turn of {root} failed")
        print(line, flush=True)
        turns.append(json.loads(line))
    names = list(turns[0]["cases"])
    for name in names:
        print(name)
        for root in roots:
            cells = []
            for t in turns:
                if t["root"] != root:
                    continue
                c = t["cases"][name]
                cells.append("refused" if "refused" in c else
                             f"{c['ms']:.4f} ms (device {c['device_ms']:.4f}, "
                             f"host {c['host_ms']:.4f}) sha {c['sha']}")
            print(f"  {os.path.basename(root)}: " + "; ".join(cells))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "turns": turns}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
