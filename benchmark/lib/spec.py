"""A cell's specification, found by name: BENCHMARK.json's workload entry,
its configuration file, its traffic file (traffic/<traffic>.json), its
limits file (limits/<workload>.json) and the reader of each metric
(metrics/<metric>.py). Adding a cell, a mix or a metric adds files and
entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """{"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"} of the workload `name`: the configuration, traffic and
    limits as their files hold them, and the metric entries this cell
    reports."""
    b = benchmark(root)
    w = {x["name"]: x for x in b["workloads"]}.get(name)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = {x["name"]: x for x in b["configs"]}[w["config"]]
    bench_dir = os.path.join(root, "benchmark")

    def applies(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in b["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in b["per_layer"]
                 if applies(m) and m["moves"] in e2e_names]
    return {
        "workload": w,
        "config": _load(os.path.join(root, c["file"])),
        "traffic": _load(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json")),
        "limits": _load(os.path.join(bench_dir, "limits", name + ".json")),
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The `read(ctx)` function of metrics/<metric>.py."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
