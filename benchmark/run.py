"""The benchmark of linear_tpu_torch, the PyTorch and CUDA port of the
Linear long-read mapper, on NVIDIA GPUs.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json (lib/cellrun.py says what a run does) and
prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics, each read by metrics/<name>.py), device,
with --trace 1 breakdown, and last the numbers compared, each with its
limit, which also end standard error. Without the CUDA devices the cell
asks for, or with jax or the JAX package loaded, it exits non-zero and
prints no result. --control 1 runs the control of the comparison instead
of the program as it is (see PERF.md); the benchmark's runs never do.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))
# the port's dependencies must not bring JAX in with them
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from lib import cellrun, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    try:
        res = cellrun.run(cell, args.seed, args.seconds,
                          trace=bool(args.trace), control=bool(args.control))
    except cellrun.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = spec.reader(m["name"])(res["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    correct = all(v <= lim for v, lim in res["checks"].values())
    for name, (v, lim) in res["checks"].items():
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": res["device"]}
    if args.trace:
        out["breakdown"] = res["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in res["checks"].items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
