"""The port's developer tools (`python -m linear_tpu_torch.tools.<name>`) on
the CPU at a tiny size: each runs with --device cpu and exits 0, and with
--device cuda on a machine without a card exits non-zero. diffstage's trace
of the port equals the trace of linear_tpu's tools/diffstage.py on the same
8 reads with the gap module on (gap_len 50), line for line, and its diff
says so; a changed line is reported. And chip_smoke.py's queue of the
calls whose busy time a fresh process measures."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import test_torch_native_ready  # noqa: F401  (the JAX package's libraries)
from linear_tpu_torch.utils import seqio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a corpus of the tools' own generator at a size the CPU maps in seconds
TINY = ("--genome-len", "600000", "--corpus-reads", "64", "--read-len", "3000")
RUNS = {
    "profile_stages": ["16", "--json", *TINY],
    "profile_residual": ["8", *TINY],
    "bench_devbuild": ["0.3", "--json"],
    "bench_scale": ["--sizes", "300000,600000", "--reads", "32",
                    "--read-len", "2000", "--threads", "4", "--workers", "2"],
}


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", LINEAR_TPU_DASH="0",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def _tool(name, args, device, cwd=ROOT, **env):
    return subprocess.run(
        [sys.executable, "-m", f"linear_tpu_torch.tools.{name}", *args,
         "--device", device] if device else
        [sys.executable, "-m", f"linear_tpu_torch.tools.{name}", *args],
        cwd=cwd, env=_env(**env), capture_output=True, text=True,
        timeout=600)


@pytest.fixture(scope="module")
def eight_reads(tmp_path_factory):
    """test_torch_pyengine's genome (60 kb with an N-gap) and its first 8
    reads: one at or below 200 bases, a 6 kb read, a read with N, every
    third reverse-complemented."""
    d = tmp_path_factory.mktemp("diffstage")
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 60000).astype(np.uint8)
    genome[30000:30300] = 4
    seqio.write_fasta(str(d / "g.fa"), ["chr1 test"], [genome])
    reads = []
    for i in range(8):
        ln = [150, 201, 6000][i] if i < 3 else int(rng.integers(1000, 4000))
        pos = int(rng.integers(0, 60000 - ln))
        r = genome[pos: pos + ln].copy()
        sub = rng.random(ln) < 0.05
        r[sub] = (r[sub] + 1) % 4
        if i == 7:
            p2 = int(rng.integers(0, 55000))
            r = np.concatenate([r, genome[p2: p2 + 1500]])
        if i % 3 == 2:
            r = seqio.revcomp(r)
        if i == 5:
            r[100:103] = 4
        reads.append(r)
    seqio.write_fasta(str(d / "r.fa"), [f"read{i} t" for i in range(8)],
                      reads)
    return d


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tool_runs_on_cpu(name):
    p = _tool(name, RUNS[name], "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    if name == "profile_stages":
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["device"] == "cpu" and out["n_reads"] == 16
        for key in ("dev_seed_reads_per_s", "host_hits_reads_per_s",
                    "dev_extend_reads_per_s", "host_finish_reads_per_s",
                    "host_full_reads_per_s", "host_full_seeded_reads_per_s",
                    "host_apx_us_per_read", "dindex_native_build_s",
                    "hindex_native_build_s", "warmup_s"):
            assert out[key] > 0, key
        assert out["seed_kernel"]["bound_ms"] > 0
        assert "seed_wire" not in out  # the copy rates are the card's
    elif name == "bench_devbuild":
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["device_equal_host"] is True and out["entries"] > 0
    elif name == "bench_scale":
        rows = p.stdout.strip().splitlines()
        assert rows[0].split()[0] == "genome" and len(rows) == 3
        assert [r.split()[0] for r in rows[1:]] == ["0.3M", "0.6M"]
    else:
        assert "device seed + chain (cpu)" in p.stderr
        assert "cumulative" in p.stdout


def test_profile_stages_host_runs_no_device_stage():
    p = _tool("profile_stages", ["8", "--json", *TINY], "host")
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert "dev_seed_reads_per_s" not in out and out["host_full_reads_per_s"]


@pytest.mark.parametrize("name", sorted(RUNS) + ["diffstage"])
def test_tool_cuda_without_a_card_fails(name, eight_reads, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot run")
    args = RUNS.get(name, ["trace", "--reads", str(eight_reads / "r.fa"),
                           "--genome", str(eight_reads / "g.fa")])
    p = _tool(name, args, "cuda", LINEAR_TPU_DBG=str(tmp_path / "t.txt"))
    assert p.returncode != 0
    assert "Traceback" in p.stderr or "nvidia-smi" in p.stderr


def test_diffstage_trace_equals_linear_tpu(eight_reads, tmp_path):
    """The port's trace, with host seeds and with the plain seed kernel's
    (cpu), against linear_tpu's tools/diffstage.py trace: identical."""
    d = eight_reads
    ref = tmp_path / "ref.txt"
    args = ["--reads", str(d / "r.fa"), "--genome", str(d / "g.fa"),
            "--gap-len", "50"]
    p = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "diffstage.py"),
                        "trace", *args], cwd=ROOT,
                       env=_env(LINEAR_TPU_DBG=str(ref)),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    ref_lines = ref.read_text().splitlines()
    assert len(ref_lines) > 100
    assert {"ANCH", "CHA1", "APXF", "GAPF", "REFC"} <= {
        ln.split()[0] for ln in ref_lines}
    for device in ("host", "cpu"):
        mine = tmp_path / f"{device}.txt"
        p = _tool("diffstage", ["trace", *args], device,
                  LINEAR_TPU_DBG=str(mine))
        assert p.returncode == 0, p.stderr[-3000:]
        if device == "cpu":
            assert "seeded on the device 6 of 8 reads" in p.stdout
        assert mine.read_text().splitlines() == ref_lines
        p = _tool("diffstage", ["diff", str(ref), str(mine)], None)
        assert p.returncode == 0
        assert p.stdout.startswith(f"traces identical ({len(ref_lines)} "
                                   "stage lines")
    # one value changed on a line of the gap phase
    k = next(i for i, ln in enumerate(ref_lines)
             if ln.startswith("GAPF") and int(ln.split()[1]) > 0)
    tag, n, v0, *rest = ref_lines[k].split()
    bad = ref_lines[:k] + [" ".join([tag, n, str(int(v0) ^ 1), *rest])] \
        + ref_lines[k + 1:]
    (tmp_path / "bad.txt").write_text("\n".join(bad) + "\n")
    p = _tool("diffstage", ["diff", str(ref), str(tmp_path / "bad.txt")],
              None)
    assert p.returncode == 1
    assert p.stdout.startswith(f"line {k}: stage GAPF diverges")


def test_diffstage_trace_needs_the_dbg_path(eight_reads):
    p = _tool("diffstage", ["trace", "--reads", str(eight_reads / "r.fa"),
                            "--genome", str(eight_reads / "g.fa")], "host",
              LINEAR_TPU_DBG="")
    assert p.returncode == 2 and "LINEAR_TPU_DBG" in p.stderr


def test_smoke_busy_queue(tmp_path):
    """chip_smoke.Busy, the queue of calls whose busy time a fresh process
    measures: each tensor goes to host memory once (a DeviceIndex shared by
    two calls is saved once), the jobs load back as they were saved, and
    a record's time is the sum of its calls', None when one traced
    nothing."""
    import importlib.util

    import torch

    from linear_tpu_torch.ops import seeding as SD

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    busy = cs.Busy()
    index = SD.DeviceIndex(dir_start=torch.arange(1 << 16, dtype=torch.int32),
                           hs=torch.arange(8, dtype=torch.int64), cap=32)
    wire = torch.zeros((4, 12), dtype=torch.uint8)
    one, two = {"shape": [4]}, {"shape": [8]}
    assert busy.add(one, "ops.seeding:seed_superchunk", (wire, index, 128),
                    20, "ops.seeding:launches") is one
    busy.add(two, "ops.seeding:seed_superchunk", (wire, index, 512), 20,
             "ops.seeding:launches")
    busy.add(two, "ops.chain_dp:chain_dp_windowed", (wire, wire), 10,
             "ops.chain_dp:launches", W=64)
    assert one["device_ms"] is None
    a, b = busy.jobs[0][1], busy.jobs[1][1]
    assert a[1].dir_start is b[1].dir_start and a[0] is b[0]
    path = tmp_path / "jobs.pt"
    torch.save(busy.jobs, path)
    assert path.stat().st_size < 2 * 4 * (1 << 16)
    loaded = torch.load(path, weights_only=False)
    fn, args, kw, iters, counter = loaded[2]
    assert (fn, kw, iters, counter) == (
        "linear_tpu_torch.ops.chain_dp:chain_dp_windowed", {"W": 64}, 10,
        "linear_tpu_torch.ops.chain_dp:launches")
    assert isinstance(loaded[0][1][1], SD.DeviceIndex)
    assert torch.equal(loaded[0][1][1].dir_start, index.dir_start)
    window = {"events": {"k": 20}, "launches": 20}
    busy.fill([{"device_ms": 0.5, "windows": [window]},
               {"device_ms": 0.25, "windows": [window]},
               {"device_ms": 1.0, "windows": [window]}])
    assert one["device_ms"] == 0.5 and two["device_ms"] == 1.25
    assert busy.jobs == [] and busy.records == []
    busy.add(one, "ops.seeding:seed_superchunk", (wire, index, 128), 20,
             "ops.seeding:launches")
    busy.add(one, "ops.seeding:seed_superchunk", (wire, index, 128), 20,
             "ops.seeding:launches")
    busy.fill([{"device_ms": None, "windows": [window] * 3},
               {"device_ms": 0.5, "windows": [window]}])
    assert one["device_ms"] is None
