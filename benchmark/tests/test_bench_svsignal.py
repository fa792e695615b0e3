"""reference/svsignal.py on hand-written SAM lines, each SV type each way
it can show, and what is not counted; and through a whole run of a tiny
donor cell on the CPU: a sound run finds its SVs, and the SV signals
stripped from the SAM where the workers write it make `correct` false."""
import functools
import re

import numpy as np
import pytest

import bench_tiny
from gen import donor as DN
from lib import cellrun
from reference import svsignal as SVS

P = 10_000   # every SV's reference start
D0 = 50_000  # its donor start; reads span [D0 - 3000, D1 + 3000)


def _sv(kind, size):
    d1 = {"del": D0, "ins": D0 + size, "inv": D0 + size,
          "dup": D0 + 2 * size}[kind]
    return DN.SV(kind, P, size, D0, d1)


def _rec(name, flag, pos0, cigar):
    return f"{name}\t{flag}\tchr\t{pos0 + 1}\t60\t{cigar}\t*\t0\t0\t*\t*"


def _found(sv, lines, rev=False, n=3):
    """check() on n reads spanning sv: read r0 has `lines` (format
    {name}), the others one plain record far off."""
    names = [f"r{i}" for i in range(n)]
    sam = [ln.format(name="r0") for ln in lines]
    sam += [_rec(nm, 0, 100_000, "6000M") for nm in names[1:]]
    src = np.array([[sv.d0 - 3000, sv.d1 + 3000]] * n)
    res = SVS.check([sv], "\n".join(sam), names, src, np.full(n, rev))
    assert len(res) == 1 and res[0][1] == n
    return res[0][2]


DEL = _sv("del", 2000)
INS = _sv("ins", 1000)
INV = _sv("inv", 3000)
DUP = _sv("dup", 3000)


@pytest.mark.parametrize("sv,lines,want", [
    # a deletion: a D of at least half its size at the breakpoint ...
    (DEL, [_rec("{name}", 0, P - 3000, "3000M1900D3000M")], True),
    (DEL, [_rec("{name}", 16, P - 3150, "3150M1100D3000M")], True),
    (DEL, [_rec("{name}", 0, P - 3000, "3000M900D3000M")], False),
    (DEL, [_rec("{name}", 0, P - 2500, "3000M2000D3000M")], False),
    # ... or a split whose reference gap is its size
    (DEL, [_rec("{name}", 0, P - 3000, "3000M3000S"),
           _rec("{name}", 2048, P + 2000, "3000S3000M")], True),
    (DEL, [_rec("{name}", 0, P - 3000, "3000M3000S"),
           _rec("{name}", 2048, P + 3000, "3000S3000M")], False),
    (DEL, [_rec("{name}", 0, P - 3000, "3000M3000S"),
           _rec("{name}", 2048 | 16, P + 2000, "3000S3000M")], False),
    # an insertion: an I, or a clip, of at least half its size there
    (INS, [_rec("{name}", 0, P - 3000, "3000M1000I3000M")], True),
    (INS, [_rec("{name}", 0, P - 3000, "3000M400I3000M")], False),
    (INS, [_rec("{name}", 0, P, "4000S3000M")], True),
    (INS, [_rec("{name}", 2048, P - 3000, "3000M4000H")], True),
    (INS, [_rec("{name}", 0, P - 3000, "3000M4000S")], True),
    (INS, [_rec("{name}", 0, P + 500, "4000S3000M")], False),
    # an inversion: a record on the other strand inside the interval
    (INV, [_rec("{name}", 0, P - 3000, "3000M6000S"),
           _rec("{name}", 2048 | 16, P + 100, "3000S2800M3200S")], True),
    (INV, [_rec("{name}", 0, P - 3000, "3000M6000S"),
           _rec("{name}", 2048, P + 100, "3000S2800M3200S")], False),
    (INV, [_rec("{name}", 0, P - 3000, "9000M")], False),
    # a duplication: a split jumping back into the copied interval ...
    (DUP, [_rec("{name}", 0, P - 1000, "4000M5000S"),
           _rec("{name}", 2048, P, "4000S5000M")], True),
    (DUP, [_rec("{name}", 16, P - 1000, "4000M5000S"),
           _rec("{name}", 2048 | 16, P + 50, "4000S4950M")], True),
    (DUP, [_rec("{name}", 0, P - 1000, "4000M5000S"),
           _rec("{name}", 2048, P + 1500, "4000S5000M")], False),
    # ... or the copy aligned as an insertion at either end
    (DUP, [_rec("{name}", 0, P - 1000, "4000M3000I2000M")], True),
    (DUP, [_rec("{name}", 0, P - 1000, "1000M3000I2000M")], True),
    (DUP, [_rec("{name}", 0, P - 1000, "9000M")], False),
])
def test_shows(sv, lines, want):
    assert _found(sv, lines) is want


def test_strand_of_the_flanks_decides_the_inversion():
    lines = [_rec("{name}", 16, P - 3000, "3000M6000S"),
             _rec("{name}", 2048, P + 100, "3000S2800M3200S")]
    assert _found(INV, lines, rev=True)
    assert not _found(INV, lines, rev=False)


def test_secondary_and_unmapped_records_show_nothing():
    for flag in (256, 4):
        assert not _found(DEL, [_rec("{name}", flag, P - 3000,
                                     "3000M1900D3000M")])


def test_what_is_not_counted():
    """An SV spanned by fewer than three reads with a kilobase on both
    sides is not counted; with none counted, the share missed is 100."""
    sam = _rec("a", 0, P - 3000, "3000M1900D3000M")
    names = ["a", "b", "c"]
    short = np.array([[DEL.d0 - 3000, DEL.d1 + 3000]] * 2
                     + [[DEL.d0 - 900, DEL.d1 + 3000]])
    res = SVS.check([DEL], sam, names, short, np.zeros(3, bool))
    assert res == []
    assert SVS.missed_pct(res) == 100.0
    res = SVS.check([DEL], sam, names, short[[0, 1, 1]], np.zeros(3, bool))
    assert SVS.missed_pct(res) == 0.0


def test_tolerance():
    assert SVS.tol(50) == 100 and SVS.tol(5000) == 500


# ----------------------------------------------- a whole run on the CPU
DONOR = {"per_mb": 13.0,
         "size": {"law": "log-uniform", "min": 300, "max": 3000},
         "shares": {"del": 0.43, "ins": 0.47, "inv": 0.05, "dup": 0.05},
         "zygosity": "homozygous", "min_gap": 15000, "clear": 5000,
         "source": "a test's: sizes that 150 reads of a tiny genome span",
         "assumed": ["per_mb", "size.min", "size.max"]}


def _donor_cell():
    c = bench_tiny.cell("ecoli_k12.clr", reads=150)
    c["traffic"]["donor"] = dict(DONOR)
    c["limits"]["sv_signal_missed_pct"] = 50.0
    return c


def _strip_signals(sam: str) -> str:
    """Each read's primary record alone, its D and I taken out and its
    clips turned to matches: a read that shows no SV."""
    out = []
    for line in sam.split("\n"):
        f = line.split("\t")
        if len(f) < 6 or int(f[1]) & 0x900:
            continue
        ops = re.findall(r"(\d+)([MIDNSHP=X])", f[5])
        f[5] = f"{sum(int(n) for n, op in ops if op in 'MSI=X')}M"
        out.append("\t".join(f))
    return "\n".join(out) + ("\n" if out else "")


def _run(cell, seed=2**37 + 3):
    return cellrun.run(cell, seed, 0.1, device="cpu")


def test_sound_donor_run_finds_its_svs():
    res = _run(_donor_cell())
    v, lim = res["checks"]["sv_signal_missed_pct"]
    assert v <= lim, res["checks"]
    assert all(x <= y for x, y in res["checks"].values()), res["checks"]


def test_signals_stripped_are_not_correct(monkeypatch):
    from linear_tpu_torch.parallel import pipeline as PL

    orig = PL._map_chunk

    @functools.wraps(orig)
    def stripped(task):
        return [(a, b, _strip_signals(sam), bl)
                for a, b, sam, bl in orig(task)]

    monkeypatch.setattr(PL, "_map_chunk", stripped)
    res = _run(_donor_cell())
    v, lim = res["checks"]["sv_signal_missed_pct"]
    assert v > lim, res["checks"]


def test_a_donor_needs_sam_output():
    c = _donor_cell()
    c["config"]["flags"]["output_type"] = 1
    with pytest.raises(ValueError):
        _run(c)


def test_without_a_donor_no_sv_check():
    res = _run(bench_tiny.cell("ecoli_k12.clr"))
    assert "sv_signal_missed_pct" not in res["checks"]
