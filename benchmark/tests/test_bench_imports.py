"""The harness's set-up path and window, run on the CPU at a tiny size in
a fresh process, load no module whose top-level name (the part before the
first dot, compared whole) is jax, jaxlib, flax or linear_tpu; and the
harness refuses a result without a CUDA card."""
import json
import os
import subprocess
import sys

import bench_tiny

SCRIPT = r"""
import json, sys
sys.path[:0] = [{root!r}, {bench!r}, {tests!r}]
import bench_tiny
from lib import cellrun
res = cellrun.run(bench_tiny.cell("ecoli_k12.clr", reads=12), 2**35 + 1, 0.1,
                  device="cpu")
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"tops": tops, "correct_inputs": res["attempted"]}}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_setup_and_window_load_no_jax():
    code = SCRIPT.format(root=bench_tiny.ROOT, bench=bench_tiny.BENCH,
                         tests=os.path.dirname(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct_inputs"] > 0
    tops = set(got["tops"])
    assert "linear_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "linear_tpu"}, tops


def test_forbidden_names_are_compared_whole():
    from lib import cellrun

    assert cellrun.forbidden_modules(
        ["linear_tpu_torch", "linear_tpu_torch.ops.seeding", "numpy",
         "jaxlib.xla_client", "flax", "linear_tpu.map"]) == [
             "flax", "jaxlib", "linear_tpu"]
    assert cellrun.forbidden_modules(["linear_tpu_torch.map"]) == []


def test_no_card_no_result():
    """Without CUDA (this machine) run.py exits non-zero with no JSON on
    standard output."""
    out = subprocess.run(
        [sys.executable, os.path.join(bench_tiny.BENCH, "run.py"),
         "--workload", "ecoli_k12.clr", "--seed", str(2**33 + 9),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, env=_env(),
        cwd=bench_tiny.ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
