"""The comparison that decides `correct`, driven through a whole run on
the CPU (the kernels' plain versions, the look for a card skipped) at a
tiny size: a sound run is correct; the control and each fault this cell
can have, planted in the timed path underneath, make it not correct."""
import functools
import re
import time

import numpy as np
import pytest

import bench_tiny
from lib import cellrun


def _correct(res):
    return all(v <= lim for v, lim in res["checks"].values())


def _run(name="ecoli_k12.clr", control=False):
    return cellrun.run(bench_tiny.cell(name), 2**36 + 77, 0.1, device="cpu",
                       control=control)


def test_sound_run_is_correct():
    res = _run()
    assert _correct(res), res["checks"]
    assert res["attempted"] >= 2 * 24


def test_sound_run_exact_numbers_human():
    """The tiny chr21-like genome packs the full cell's repeat families
    into 1.5 Mb, so its few dozen reads say nothing of placement; the
    exact numbers still hold."""
    res = _run("human_chr21.clr")
    for k in ("index_mismatch", "seed_mismatch_reads",
              "digest_mismatch_passes"):
        assert res["checks"][k][0] == 0, (k, res["checks"])


def test_control_is_not_correct():
    res = _run(control=True)
    assert res["checks"]["seed_mismatch_reads"][0] > 0
    assert not _correct(res)


def _patch(monkeypatch, mod, attr, make):
    orig = getattr(mod, attr)
    new = functools.wraps(orig)(make(orig))
    monkeypatch.setattr(mod, attr, new)


def _shift_pos(sam: str) -> str:
    out = []
    for line in sam.split("\n"):
        f = line.split("\t")
        if len(f) > 3 and not line.startswith("@"):
            f[3] = str(int(f[3]) + 150_000)
        out.append("\t".join(f))
    return "\n".join(out)


def fault_index_entry(monkeypatch):
    """The device index: one hs entry altered after it is built."""
    from linear_tpu_torch.ops import devbuild as DB

    def make(orig):
        def f(*a, **k):
            idx = orig(*a, **k)
            idx.hs[len(idx.hs) // 2] += 1
            return idx
        return f
    _patch(monkeypatch, DB, "device_build_to_index", make)


def fault_seed_anchor(monkeypatch):
    """The device seeds: one anchor of every read altered as it lands."""
    from linear_tpu_torch.ops import seeding as SD

    def make(orig):
        def f(*a, **k):
            res, ov = orig(*a, **k)
            for x in res:
                if x is not None and len(x):
                    x[0] ^= np.uint64(1 << 21)
            return res, ov
        return f
    _patch(monkeypatch, SD, "collect_wire", make)


def fault_sam_pos(monkeypatch):
    """The SAM: every record's POS altered where the worker writes it."""
    from linear_tpu_torch.parallel import pipeline as PL

    def make(orig):
        def f(task):
            return [(a, b, _shift_pos(sam), bl) for a, b, sam, bl in orig(task)]
        return f
    _patch(monkeypatch, PL, "_map_chunk", make)


def fault_half_left_out(monkeypatch):
    """Half of each block's reads left out of the output."""
    from linear_tpu_torch.parallel import pipeline as PL

    def make(orig):
        def f(self, *a, **k):
            for br in orig(self, *a, **k):
                lines = br.sam.split("\n")
                keep = [ln for ln in lines
                        if not ln or int(re.findall(r"\d+", ln.split("\t")[0])[-1]) % 2]
                br.sam = "\n".join(keep)
                yield br
        return f
    _patch(monkeypatch, PL.PipelineMapper, "run", make)


def fault_stale_output(monkeypatch):
    """A step that returns its state unchanged: every read file's run
    yields the first file's results again."""
    from linear_tpu_torch.parallel import pipeline as PL

    def make(orig):
        first = []

        def f(self, *a, **k):
            if first:
                yield from first
                return
            for br in orig(self, *a, **k):
                first.append(br)
                yield br
        return f
    _patch(monkeypatch, PL.PipelineMapper, "run", make)


@pytest.mark.parametrize("fault", [fault_index_entry, fault_seed_anchor,
                                   fault_sam_pos, fault_half_left_out,
                                   fault_stale_output])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _run()
    assert not _correct(res), res["checks"]


def _flagged(**flags):
    c = bench_tiny.cell("ecoli_k12.clr")
    c["config"]["flags"].update(flags)
    return c


def test_serial_loop_when_bal_flag_is_0(monkeypatch):
    """A configuration with -b 0 maps by the CLI's serial loop of
    Mapper.map_block and forks no pipeline; its run is correct."""
    from linear_tpu_torch.map.mapper import Mapper
    from linear_tpu_torch.parallel import pipeline as PL

    def no_pipeline(*a, **k):
        raise AssertionError("-b 0 built a PipelineMapper")

    calls = []
    _patch(monkeypatch, PL.PipelineMapper, "__init__", lambda orig: no_pipeline)
    _patch(monkeypatch, Mapper, "map_block", lambda orig: (
        lambda self, *a, **k: calls.append(1) or orig(self, *a, **k)))
    res = cellrun.run(_flagged(bal_flag=0), 2**36 + 78, 0.1, device="cpu")
    assert calls and _correct(res), res["checks"]


def test_bam_output_is_written_and_digested(monkeypatch):
    """-ot 6 (SAM and BAM): each pass writes its BAM as the CLI does, and
    a BAM that differs from its file's first pass makes the run not
    correct."""
    from linear_tpu_torch.out import bam as BAM

    written = []
    _patch(monkeypatch, BAM, "write_bam", lambda orig: (
        lambda path, *a: written.append(path) or orig(path, *a)))
    res = cellrun.run(_flagged(output_type=6), 2**36 + 79, 0.1, device="cpu")
    assert _correct(res), res["checks"]
    assert len(written) == res["passes"] + 1  # the warm-up's too

    def make(orig):
        def f(path, header, ids, lens, lines):
            if len(written) > 2:
                lines = lines[1:]
            written.append(path)
            return orig(path, header, ids, lens, lines)
        return f
    _patch(monkeypatch, BAM, "write_bam", make)
    written.clear()
    # a window long enough to map each file more than once
    res = cellrun.run(_flagged(output_type=6), 2**36 + 79, 4.0, device="cpu")
    assert res["passes"] > 2
    assert res["checks"]["digest_mismatch_passes"][0] > 0


@pytest.mark.parametrize("flags", [{"bal_flag": 2}, {"output_type": 4},
                                   {"output_type": 16}, {"engine": "jax"},
                                   {"reform_ccs": 1}])
def test_flags_not_carried_out_are_refused(flags):
    with pytest.raises(ValueError):
        cellrun.run(_flagged(**flags), 1, 0.1, device="cpu")


def test_engine_is_the_configuration_s(monkeypatch):
    seen = []
    monkeypatch.setenv("LINEAR_TPU_ENGINE", "native")
    monkeypatch.setattr(cellrun, "_run", lambda *a: seen.append(
        cellrun.os.environ["LINEAR_TPU_ENGINE"]))
    cellrun.run(_flagged(engine="py"), 1, 0.1, device="cpu")
    cellrun.run(_flagged(), 1, 0.1, device="cpu")
    assert seen == ["py", "native"]
    assert cellrun.os.environ["LINEAR_TPU_ENGINE"] == "native"


class _Clock:
    """cellrun's `time`, with a perf_counter that moves a second a call,
    so that a window of s seconds holds a set number of passes."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t

    perf_counter_ns = staticmethod(time.perf_counter_ns)


@pytest.mark.parametrize("fault", [None, fault_half_left_out])
def test_each_pool_read_counts_once(monkeypatch, fault):
    """attempted and failed count each read of the pool once, in its
    file's first pass: a pool mapped in 2 passes and in 5 gives the same
    counts and share, with reads missing and without."""
    if fault:
        fault(monkeypatch)
    got = []
    for seconds in (1.0, 4.0):
        monkeypatch.setattr(cellrun, "time", _Clock())
        res = cellrun.run(bench_tiny.cell(), 2**36 + 80, seconds,
                          device="cpu")
        got.append((res["passes"], res["attempted"], res["failed"],
                    res["failed"] / res["attempted"]))
    assert [g[0] for g in got] == [2, 5]
    assert got[0][1:] == got[1][1:]
    assert got[0][1] == 2 * 24
    assert (got[0][2] > 0) == bool(fault)
