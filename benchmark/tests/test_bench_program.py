"""The readers of the program's own tracing (lib/program.py) on synthetic
passes and on a traced pipeline run on the CPU, and idle_gaps_program on
hand-built spans and device events."""
import os
from types import SimpleNamespace

import numpy as np
import pytest

import bench_tiny  # noqa: F401  (sys.path)
from lib import fasta
from lib import program as P


def _sp(name, t0, t1, task=-1):
    return SimpleNamespace(name=name, t0=int(t0), t1=int(t1), task=task)


def _pass(spans, emitted=10, **kw):
    c = SimpleNamespace(spans=spans, emitted=emitted, feeder_cpu_ns=0,
                        collector_cpu_ns=0, drain_cpu_ns=0, worker_ns={})
    for k, v in kw.items():
        setattr(c, k, v)
    return c


MS = 1_000_000


def _ctx():
    # two passes of a 1 s window, 2 workers; task ids restart a pass
    a = _pass([_sp("feeder.put", 0, 1 * MS, 0), _sp("feeder.put", 1 * MS,
                                                     2 * MS, 1),
               _sp("feeder.wait_seeds", 2 * MS, 12 * MS, 1),
               _sp("worker.task", 3 * MS, 103 * MS, 0),
               _sp("worker.task", 6 * MS, 106 * MS, 1)],
              emitted=100, feeder_cpu_ns=50 * MS, collector_cpu_ns=100 * MS,
              drain_cpu_ns=20 * MS,
              worker_ns={"gap": 300 * MS, "apx.host_seed": 40 * MS})
    b = _pass([_sp("feeder.put", 500 * MS, 501 * MS, 0),
               _sp("feeder.wait_seeds", 490 * MS, 500 * MS, 0),
               _sp("worker.task", 502 * MS, 802 * MS, 0)],
              emitted=100, feeder_cpu_ns=50 * MS, collector_cpu_ns=100 * MS,
              drain_cpu_ns=30 * MS,
              worker_ns={"gap": 100 * MS, "apx.host_seed": 0})
    return {"program": [a, b], "window_s": 1.0, "workers": 2}


@pytest.mark.parametrize("name,want", [
    ("pipeline.feeder_cpu_share", 10.0),
    ("pipeline.collector_cpu_share", 20.0),
    ("pipeline.drain_cpu_share", 5.0),
    ("pipeline.seed_wait_share", 2.0),
    # (3 - 1) + (6 - 2) + (502 - 501) ms over 3 tasks
    ("pipeline.task_queue_ms", 7 / 3),
    # 500 ms of tasks over 2 workers x 1 s
    ("workers.idle_share", 75.0),
    ("workers.host_seed_ms_per_read", 0.2),
    ("workers.gap_ms_per_read", 2.0),
])
def test_reader_on_synthetic_passes(name, want):
    assert P.READERS[name](_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(P.READERS))
def test_reader_nothing_to_read(name):
    """No traced pass (tracing off, or a program without it), and a pass
    with no pool task (the -b 0 loop: seeding spans only): None."""
    read = P.READERS[name]
    assert read({"window_s": 1.0, "workers": 8}) is None
    assert read({"program": [], "window_s": 1.0, "workers": 8}) is None
    serial = _pass([_sp("collector.pack", 0, MS)])
    assert read({"program": [serial], "window_s": 1.0,
                 "workers": 0}) is None


def test_idle_gaps_program():
    """Each idle gap goes to the collector's innermost span open at its
    middle, else the feeder's, else the drain's, else "none"; worker and
    unknown spans name nothing."""
    s = 1_000_000_000
    dev = [("k", 1.0, 2.0), ("k", 4.0, 5.0), ("k", 7.0, 8.0)]
    spans = [_sp("collector.dispatch", 2.0 * s, 3.5 * s),
             _sp("collector.pack", 2.5 * s, 3.2 * s),       # mid 3.0: inner
             _sp("feeder.wait_seeds", 2.0 * s, 6.5 * s),    # mid 6.0
             _sp("drain.results", 0.0, 1.0 * s),            # mid 0.5
             _sp("worker.map", 8.0 * s, 10.0 * s),          # mid 9.0: none
             _sp("file", 0, 10 * s)]
    gaps = dict(P.idle_gaps_program(dev, spans, 0.0, 10.0))
    assert gaps == {"drain.results": pytest.approx(1.0),
                    "collector.pack": pytest.approx(2.0),
                    "feeder.wait_seeds": pytest.approx(2.0),
                    "none": pytest.approx(2.0)}
    assert P.idle_gaps_program(dev, [], 0.0, 10.0) == [
        ["none", pytest.approx(7.0)]]


def test_readers_on_a_traced_pipeline_run(tmp_path):
    """The program's PipeCounters of a traced -b 1 run on the CPU: every
    reader reads a number, the shares within 0-100 %, the three threads'
    CPU within the run's wall."""
    import time

    from linear_tpu_torch.map.mapper import Mapper, MapperConfig
    from linear_tpu_torch.parallel.pipeline import PipelineMapper

    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 40000).astype(np.uint8)
    fasta.write_genome(str(tmp_path / "g.fa"), "chr1", g)
    reads = [g[p: p + 2000] for p in rng.integers(0, 38000, 24)]
    fasta.write_reads(str(tmp_path / "r.fa"),
                      [f"r{i}" for i in range(24)], reads)
    m = Mapper([str(tmp_path / "g.fa")], MapperConfig(threads=2),
               device="cpu")
    with PipelineMapper(m, n_workers=2, csize_workers=2, trace=True) as pipe:
        m._ensure_dev_index()
        t0 = time.perf_counter()
        n = sum(br.n for br in pipe.run(str(tmp_path / "r.fa")))
        ctx = {"program": [pipe.counters], "workers": 2,
               "window_s": time.perf_counter() - t0}
    assert n == 24
    got = {k: f(ctx) for k, f in P.READERS.items()}
    assert all(v is not None for v in got.values()), got
    for k in ("pipeline.feeder_cpu_share", "pipeline.collector_cpu_share",
              "pipeline.drain_cpu_share", "pipeline.seed_wait_share",
              "workers.idle_share"):
        assert 0 <= got[k] <= 100, (k, got[k])
    assert got["pipeline.task_queue_ms"] > 0
    assert got["workers.gap_ms_per_read"] >= 0
    assert os.getpid() not in {sp.pid for sp in pipe.counters.spans
                               if sp.name == "worker.task"}


@pytest.mark.parametrize("name", sorted(P.READERS))
def test_metric_file_reads_the_program(name):
    """metrics/<name>.py of each program metric is lib/program's reader,
    and each has its per_layer entry, moving reads_per_s."""
    from lib import spec

    assert spec.reader(name)(_ctx()) == pytest.approx(P.READERS[name](_ctx()))
    assert spec.reader(name)({"window_s": 1.0, "workers": 8}) is None
    entry = {m["name"]: m for m in spec.benchmark()["per_layer"]}[name]
    assert entry["moves"] == "reads_per_s"
    assert entry["source"] in ("program_counter", "program_span")


def _seen_trace(monkeypatch):
    from linear_tpu_torch.parallel import pipeline as PL

    seen = []
    orig = PL.PipelineMapper.run

    def run(self, *a, **k):
        seen.append(self.trace)
        return orig(self, *a, **k)

    monkeypatch.setattr(PL.PipelineMapper, "run", run)
    return seen


def test_traced_run_turns_the_program_tracing_on(monkeypatch):
    """A traced harness run turns the program's tracing on from the
    window's start through the profiled pass (not the warm-up), puts the
    window's passes in ctx["program"], where every reader finds a number,
    and names the device's idle time by the program's spans."""
    from lib import cellrun, spec

    seen = _seen_trace(monkeypatch)
    res = cellrun.run(bench_tiny.cell(), 2**36 + 81, 0.1, trace=True,
                      device="cpu")
    assert seen == [False] + [True] * res["passes"]
    ctx = res["ctx"]
    assert len(ctx["program"]) == res["passes"] - 1
    for name in P.READERS:
        assert spec.reader(name)(ctx) is not None, name
    gaps = res["breakdown"]["idle_gaps_program"]
    assert gaps and sum(v for _, v in gaps) == pytest.approx(
        res["device"]["window_s"], rel=1e-6)


def test_untraced_run_never_turns_it_on(monkeypatch):
    from lib import cellrun

    seen = _seen_trace(monkeypatch)
    res = cellrun.run(bench_tiny.cell(), 2**36 + 82, 0.1, device="cpu")
    assert seen == [False] * (res["passes"] + 1) and "ctx" not in res
