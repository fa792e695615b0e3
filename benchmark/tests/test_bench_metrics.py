"""The metric readers, the trace reading and the /proc readers on
synthetic inputs, and the data-driven lookup of cells, mixes and
metrics."""
import json
import os
import shutil
from types import SimpleNamespace

import pytest

import bench_tiny
from lib import procstat, roofline, spec
from lib import trace as TR


def _ev(name, start, end, cuda=True):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_device_events_on_the_host_clock():
    evs = [_ev(TR.SYNC, 100.0, 101.0, cuda=False),
           _ev("seed_superchunk_kernel<256, 4>", 200.0, 260.0),
           _ev("Memcpy HtoD (Pinned -> Device)", 150.0, 170.0),
           _ev("aten::copy_", 140.0, 180.0, cuda=False)]
    dev = TR.device_events(evs, sync_perf_ns=5_000_000_000)
    # the marker at 100 us is perf_counter 5 s: +4,999,900 us
    assert [d[0][:4] for d in dev] == ["seed", "Memc"]
    assert dev[0][1] == pytest.approx(5.0001)
    assert dev[0][2] == pytest.approx(5.00016)
    assert TR.device_events(evs[1:], 0) == []


def test_union_busy_gaps_and_top_ops():
    dev = [("k", 1.0, 2.0), ("k", 1.5, 2.5), ("m", 4.0, 5.0), ("k", 9.0, 12.0)]
    assert TR.union([(s, e) for _, s, e in dev]) == [(1.0, 2.5), (4.0, 5.0),
                                                     (9.0, 12.0)]
    assert TR.busy_seconds(dev, 0.0, 10.0) == pytest.approx(3.5)
    assert TR.kernel_seconds(dev, "k") == (pytest.approx(5.0), 3)
    assert TR.top_ops(dev)[0] == ["k", pytest.approx(5.0)]
    spans = [("seed.collect", 1, int(2.6e9), int(3.9e9)),
             ("reads.parse", 2, int(5.5e9), int(8.0e9)),
             ("file", 3, 0, int(10e9))]
    gaps = dict(TR.idle_gaps(dev, spans, 0.0, 10.0))
    # gaps: [0,1] file, [2.5,4] collect, [5,9] parse
    assert gaps == {"file": pytest.approx(1.0),
                    "seed.collect": pytest.approx(1.5),
                    "reads.parse": pytest.approx(4.0)}


def test_proc_stat(tmp_path):
    line = ("4242 (python3 (x) y) S 1 2 3 4 5 6 7 8 9 10 "
            f"{3 * procstat.TICK} {2 * procstat.TICK} 0 0 20 0 9\n")
    (tmp_path / "4242").mkdir()
    (tmp_path / "4242" / "stat").write_text(line)
    assert procstat.cpu_seconds(4242, str(tmp_path)) == pytest.approx(5.0)
    assert procstat.total([4242, 4242], str(tmp_path)) == pytest.approx(10.0)
    assert procstat.cpu_seconds(os.getpid()) >= 0


def test_seed_bound():
    b = roofline.seed_bound([1000, 2000], 128, [100, 300])
    calls = (1000 - 56 + 14) // 15 + (2000 - 56 + 14) // 15
    nbytes = 250 + 500 + 16 + 2 * 129 * 8 + 8 * calls + 8 * (100 + 128)
    ops = 150 * calls + 20 * 228
    assert b["bound_s"] == pytest.approx(max(nbytes / 3.35e12, ops / 67e12))


CTX = {
    "setup": {"import_s": 6.0, "prepare_s": 2.0, "device_s": 1.5,
              "warmup_s": 0.5},
    "window_s": 20.0, "reads": 100000, "cores": 8, "eligible": 100000,
    "shipped_seeded": 95000, "main_cpu_s": 10.0, "workers_cpu_s": 120.0,
    "workers": 8,
    "superchunks": 100, "superchunk_span_s": 1.5,
    "device_events": [("seed_superchunk_kernel<256, 4>", 1.0, 1.0001),
                      ("Memcpy", 1.0002, 1.0003)],
    "launches": [([7000] * 1024, 128, [100] * 1024)],
    "trace_window": (0.5, 2.5),
}


def test_readers_on_a_context():
    want = {"setup.import_s": 6.0, "setup.prepare_s": 2.0, "setup.warmup_s": 0.5,
            "setup.device_s": 1.5, "pipeline.device_seeded_share": 95.0,
            "pipeline.main_cpu_share": 50.0,
            "seeding.host_ms_per_superchunk": 15.0,
            "workers.cpu_ms_per_read": 1.2, "workers.busy_share": 75.0,
            "device.idle_share": 100 * (1 - 0.0002 / 2.0)}
    for name, v in want.items():
        assert spec.reader(name)(CTX) == pytest.approx(v), name
    least = roofline.seed_bound([7000] * 1024, 128, [100] * 1024)["bound_s"]
    assert spec.reader("seed_superchunk_roofline")(CTX) == pytest.approx(
        100 * least / 1e-4)


def test_readers_find_nothing_to_read():
    empty = dict(CTX, eligible=0, superchunks=0, reads=0, device_events=[],
                 launches=[], workers=0)
    for name in ("pipeline.device_seeded_share",
                 "seeding.host_ms_per_superchunk", "workers.cpu_ms_per_read",
                 "workers.busy_share", "seed_superchunk_roofline",
                 "device.idle_share"):
        assert spec.reader(name)(empty) is None, name


def test_every_metric_has_a_reader_and_every_cell_its_files():
    b = spec.benchmark()
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in b["workloads"]:
        c = spec.cell(w["name"])
        assert set(c["limits"]) >= {"index_mismatch", "seed_mismatch_reads"}
        assert {m["name"] for m in c["end_to_end"]} == {"reads_per_s",
                                                        "setup_s"}


NEW_METRIC = '''
def read(ctx):
    return 42.0
'''


def test_new_files_are_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell with its limits and a metric by new files and new entries in
    BENCHMARK.json alone; the harness finds each by its name."""
    root = tmp_path / "repo"
    shutil.copytree(bench_tiny.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.benchmark()
    bd = root / "benchmark"
    cfg = json.loads((bd / "configs" / "ecoli_k12.json").read_text())
    cfg["name"] = "bsub"
    cfg["genome"]["length"] = 4215606
    (bd / "configs" / "bsub.json").write_text(json.dumps(cfg))
    tr = json.loads((bd / "traffic" / "clr.json").read_text())
    tr["length"]["median"] = 9000
    (bd / "traffic" / "clr9k.json").write_text(json.dumps(tr))
    (bd / "limits" / "bsub.clr9k.json").write_text(
        (bd / "limits" / "ecoli_k12.clr.json").read_text())
    (bd / "metrics" / "answer.py").write_text(NEW_METRIC)
    b["configs"].append({"name": "bsub", "source": "https://example.org",
                         "file": "benchmark/configs/bsub.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "bsub.clr9k", "config": "bsub",
                           "traffic": "clr9k", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "answer", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "test",
                           "moves": "reads_per_s",
                           "workloads": ["bsub.clr9k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    before = {p: p.read_bytes() for p in bd.rglob("*") if p.is_file()
              and p.name not in ("bsub.json", "clr9k.json",
                                 "bsub.clr9k.json", "answer.py")}
    c = spec.cell("bsub.clr9k", root=str(root))
    assert c["config"]["genome"]["length"] == 4215606
    assert c["traffic"]["length"]["median"] == 9000
    # a metric without a `workloads` list is every cell's, the new one's too
    assert [m["name"] for m in c["per_layer"]] == [
        m["name"] for m in b["per_layer"]]
    assert spec.reader("answer", str(bd))({}) == 42.0
    # the old cells are as they were, and no old file changed
    assert all(m["name"] != "answer"
               for m in spec.cell("ecoli_k12.clr", root=str(root))["per_layer"])
    assert all(p.read_bytes() == v for p, v in before.items())
