"""The port's pipeline tracing (PipelineMapper.trace, LINEAR_TPU_TRACE) on
the CPU: off, it records nothing and the pool's tasks, their results and
the SAM are what they were without it; on, the output is the same, every
task's feeder.put, drain.submit and worker.task spans line up, the spans
nest, the workers' spans and native phase times come back from the forked
processes, the thread CPU counters fit inside the run, and a CLI run
writes Chrome trace-event JSON. The corpus is test_torch_native_ready's
small_corpus: a 60 kb genome with an N-gap and 16 reads (one at the
200-base cut, one with N, a chimera)."""
import json
import os
import pickle
import subprocess
import sys
import time

import pytest

import test_torch_native_ready as NR
from linear_tpu_torch.map.mapper import Mapper, MapperConfig
from linear_tpu_torch.parallel import pipeline as PL
from linear_tpu_torch.parallel.pipeline import (WORKER_STAGES, PipeCounters,
                                                PipelineMapper)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 16
MAIN_SPANS = ("feeder.offsets", "feeder.wait_seeds", "feeder.put",
              "collector.read", "collector.pack", "collector.dispatch",
              "collector.collect", "drain.get", "drain.submit",
              "drain.results", "drain.join")
WORKER_SPANS = ("worker.task", "worker.parse", "worker.map")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trace"))
    _, reads, _ = NR.small_corpus(d, n_reads=N_READS)
    return {"dir": d, "g": os.path.join(d, "g.fa"),
            "r": os.path.join(d, "r.fa"),
            "seedable": sum(200 < len(r) <= 1 << 17 for r in reads)}


def _run(pipe, path, **kw):
    """One PipelineMapper.run, consumed: its SAM and cords, counters, the
    tasks the drain handed to the pool and their results, its wall ns."""
    tasks, ars = [], []
    submit = pipe.pool.apply_async

    def spy(fn, args, callback=None):
        ar = submit(fn, args, callback=callback)
        tasks.append(args[0])
        ars.append(ar)
        return ar

    pipe.pool.apply_async = spy
    try:
        t0 = time.perf_counter_ns()
        brs = list(pipe.run(path, **kw))
        wall = time.perf_counter_ns() - t0
    finally:
        del pipe.pool.apply_async
    return {"sam": "".join(br.sam for br in brs),
            "cords": [cs for br in brs for cs in br.cords_str],
            "c": pipe.counters, "tasks": tasks,
            "results": [ar.get() for ar in ars], "wall": wall,
            "pids": {p.pid for p in pipe.pool._pool}}


# (device, collect_cords): the card's path on its plain versions, with and
# without the block parse in the main process, and the host engines alone
CASES = [("cpu", False), ("cpu", True), ("host", False)]


@pytest.fixture(scope="module", params=CASES, ids=lambda p: f"{p[0]}-{p[1]}")
def runs(corpus, request):
    """An untraced run (which also leaves phase counts in the workers),
    then a traced one, in one pool."""
    device, cords = request.param
    m = Mapper([corpus["g"]], MapperConfig(threads=4), device=device)
    with PipelineMapper(m, n_workers=2, csize_workers=4, trace=False) as pipe:
        off = _run(pipe, corpus["r"], collect_cords=cords)
        pipe.trace = True
        on = _run(pipe, corpus["r"], collect_cords=cords)
    return {"m": m, "off": off, "on": on, "device": device, "cords": cords}


def _by_name(c, name):
    return [sp for sp in c.spans if sp.name == name]


def test_trace_default_follows_the_environment(corpus, monkeypatch):
    m = Mapper([corpus["g"]], MapperConfig(threads=4), device="host")
    for env, want in ((None, False), ("", False), ("0", False),
                      ("t.json", True)):
        if env is None:
            monkeypatch.delenv("LINEAR_TPU_TRACE", raising=False)
        else:
            monkeypatch.setenv("LINEAR_TPU_TRACE", env)
        with PipelineMapper(m, n_workers=1) as pipe:
            assert pipe.trace is want
            assert PL.trace_path() == (env if want else None)


def test_off_records_nothing(corpus, runs):
    """Tracing off: no span, no CPU or phase time, the counts of a run."""
    c = runs["off"]["c"]
    assert not c.trace and c.spans == [] and c.worker_ns == {}
    assert c.feeder_cpu_ns == c.collector_cpu_ns == c.drain_cpu_ns == 0
    assert c.fetched == c.computed == c.emitted == N_READS
    if runs["device"] == "cpu":
        assert c.shipped_seeded == c.seeded > 0
        assert c.seeded + c.host_n + c.host_overflow == corpus["seedable"]
    else:
        assert c.seeded == c.shipped_seeded == 0


def test_off_tasks_and_results_as_without_tracing(runs):
    """Tracing off: each task is the 7-tuple the pool has always taken,
    and its result, pickled, is byte for byte what _map_chunk returns for
    it in this process; traced, a task is that tuple and its id, and its
    result's first part pickles to the same bytes."""
    off, on = runs["off"], runs["on"]
    assert len(off["tasks"]) == len(on["tasks"]) > 1
    PL._init_worker(runs["m"])
    try:
        for k, (t_off, r_off, t_on, r_on) in enumerate(zip(
                off["tasks"], off["results"], on["tasks"], on["results"])):
            assert len(t_off) == 7
            assert pickle.dumps(t_on) == pickle.dumps(t_off + (k,))
            want = pickle.dumps(PL._map_chunk(t_off))
            assert pickle.dumps(r_off) == want
            assert len(r_on) == 3 and pickle.dumps(r_on[0]) == want
    finally:
        PL._init_worker(None)


def test_on_keeps_the_output(runs):
    off, on = runs["off"], runs["on"]
    assert on["sam"] == off["sam"] and on["sam"].count("\n") > N_READS // 2
    assert on["cords"] == off["cords"]
    c = on["c"]
    assert c.fetched == c.computed == c.emitted == N_READS


def test_every_task_put_submitted_and_mapped_in_order(runs):
    """One feeder.put, one drain.submit and one worker.task a task id,
    started in that order on the one clock."""
    c = runs["on"]["c"]
    n = len(runs["on"]["tasks"])
    got = {}
    for name in ("feeder.put", "drain.submit", "worker.task"):
        sps = _by_name(c, name)
        assert sorted(sp.task for sp in sps) == list(range(n)), name
        got[name] = {sp.task: sp for sp in sps}
    for k in range(n):
        put, sub, wt = (got[x][k] for x in ("feeder.put", "drain.submit",
                                            "worker.task"))
        assert put.t0 <= sub.t0 <= wt.t0 < wt.t1
    if runs["device"] == "cpu":
        assert sorted(sp.task for sp in
                      _by_name(c, "feeder.wait_seeds")) == list(range(n))


@pytest.mark.parametrize("name", MAIN_SPANS + WORKER_SPANS
                         + ("feeder.block",))
def test_span_recorded_where_its_stage_ran(runs, name):
    """Each stage's span is recorded, in the process and thread of its
    stage: feeder, collector, drain (the consumer's thread) in this
    process, worker.* in the pool's forked processes; collector and feeder
    spans only where the card seeds and blocks are parsed."""
    c = runs["on"]["c"]
    sps = _by_name(c, name)
    role = name.split(".")[0]
    if ((role == "collector" or name == "feeder.wait_seeds")
            and runs["device"] == "host") or (
            name == "feeder.block" and not runs["cords"]):
        assert sps == []
        return
    assert sps, name
    if role == "worker":
        assert {sp.pid for sp in sps} <= runs["on"]["pids"]
        assert os.getpid() not in {sp.pid for sp in sps}
    else:
        assert {sp.pid for sp in sps} == {os.getpid()}
        tids = {r: {sp.tid for sp in c.spans if sp.name.startswith(r)}
                for r in ("feeder", "collector", "drain")}
        assert len({sp.tid for sp in sps}) == 1 or role == "collector"
        others = set().union(*(v for r, v in tids.items() if r != role))
        assert not ({sp.tid for sp in sps} & others)


def test_parents_resolve_and_contain_their_children(runs):
    c = runs["on"]["c"]
    by_id = {sp.id: sp for sp in c.spans}
    assert len(by_id) == len(c.spans)
    nested = 0
    for sp in c.spans:
        assert sp.t0 <= sp.t1 and sp.cpu0 <= sp.cpu1
        if sp.parent == -1:
            continue
        p = by_id[sp.parent]
        assert (p.pid, p.tid) == (sp.pid, sp.tid)
        assert p.t0 <= sp.t0 and sp.t1 <= p.t1
        nested += 1
    # worker.parse and worker.map inside each worker.task
    assert nested == 2 * len(runs["on"]["tasks"])
    for sp in _by_name(c, "worker.map"):
        assert by_id[sp.parent].name == "worker.task"


def test_phase_deltas_are_the_tasks_own(runs):
    """The workers' native phase ns of each task sum to more than zero and
    fit inside that task's engine call: the untraced run before left its
    counts in the workers, and a traced task discards them."""
    on = runs["on"]
    c = on["c"]
    assert set(c.worker_ns) == set(WORKER_STAGES)
    assert sum(c.worker_ns[k] for k in WORKER_STAGES[:4]) > 0
    by_id = {sp.id: sp for sp in c.spans}
    tasks = _by_name(c, "worker.task")
    for k in WORKER_STAGES:
        assert sum(sp.args[k + "_ns"] for sp in tasks) == c.worker_ns[k]
    for sp in _by_name(c, "worker.map"):
        task = by_id[sp.parent]
        engine = sum(task.args[k + "_ns"] for k in WORKER_STAGES[:4])
        assert 0 < engine <= sp.t1 - sp.t0
    for _, w_spans, w_ns in on["results"]:
        (task,) = [sp for sp in w_spans if sp.name == "worker.task"]
        assert w_ns == {k: task.args[k + "_ns"] for k in WORKER_STAGES}
    if runs["device"] == "host":
        # no device seeds: the workers seed every read
        assert c.worker_ns["apx.host_seed"] > 0


@pytest.mark.parametrize("counter", ["feeder_cpu_ns", "collector_cpu_ns",
                                     "drain_cpu_ns"])
def test_thread_cpu_within_the_run(runs, counter):
    c = runs["on"]["c"]
    v = getattr(c, counter)
    if counter == "collector_cpu_ns" and runs["device"] == "host":
        assert v == 0
        return
    assert 0 < v <= runs["on"]["wall"]


def test_steps_and_adopt():
    """steps() spans each item's making and passes the items through, off
    and on; adopt() gives a worker's spans fresh ids, parents kept."""
    c = PipeCounters(trace=False, enabled=False)
    assert list(c.steps(iter([1, 2]), "x")) == [1, 2] and c.spans == []
    c.trace = True
    assert list(c.steps(iter([1, 2]), "x")) == [1, 2]
    assert [sp.name for sp in c.spans] == ["x"] * 3
    w = PipeCounters(trace=True, enabled=False)
    with w.span("worker.task", 5):
        with w.span("worker.map"):
            pass
    c.adopt(w.spans)
    inner, outer = c.spans[-2:]
    assert outer.id not in {0, 1, 2} and inner.parent == outer.id
    assert (outer.parent, outer.task) == (-1, 5)


def _cli(corpus, d, trace, bal):
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", LINEAR_TPU_DASH="0",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("LINEAR_TPU_TRACE", None)
    if trace:
        env["LINEAR_TPU_TRACE"] = os.path.join(d, "run.json")
    p = subprocess.run(
        [sys.executable, "-m", "linear_tpu_torch", "filter", corpus["r"],
         corpus["g"], "-t", "4", "--device", "cpu", "-b", str(bal), "-o",
         "out", "-ot", "3"], cwd=d, env=env, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = []
    for ext in ("sam", "apf"):
        with open(os.path.join(d, "out." + ext), "rb") as fh:
            out.append(fh.read())
    return out, p.stderr


@pytest.mark.parametrize("bal", [1, 0])
def test_cli_writes_chrome_trace(corpus, bal):
    """LINEAR_TPU_TRACE=<file> on a CLI run: the same SAM and APF, and the
    file is trace-event JSON with the run's spans (-b 0: the seeding spans
    of its serial loop), CLOCK_MONOTONIC microseconds, a thread name for
    each thread, and the run's counts."""
    d = os.path.join(corpus["dir"], f"cli{bal}")
    files_on, err = _cli(corpus, os.path.join(d, "on"), True, bal)
    files_off, _ = _cli(corpus, os.path.join(d, "off"), False, bal)
    assert files_on == files_off
    assert "--Trace written to" in err
    with open(os.path.join(d, "on", "run.json")) as fh:
        doc = json.load(fh)
    assert "CLOCK_MONOTONIC" in doc["otherData"]["clock"]
    (run,) = doc["otherData"]["runs"]
    assert run["run"] == corpus["r"] and run["fetched"] == N_READS
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == run["spans"] > 0
    assert all(e["dur"] >= 0 and e["ts"] > 0 for e in xs)
    names = {e["name"] for e in xs}
    want = {"collector.pack", "collector.dispatch", "collector.collect"}
    if bal:
        want |= set(MAIN_SPANS + WORKER_SPANS) | {"feeder.block"}
    assert names == want
    threads = {(e["pid"], e["tid"]) for e in doc["traceEvents"]
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert threads == {(e["pid"], e["tid"]) for e in xs}
