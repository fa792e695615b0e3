"""cords -> CIGAR -> SAM emission ("virtual alignment").

Re-derivation of the reference output layer:
  - cords2BamLink / cord2cigar_ rectangle decomposition (src/f_io.cpp:883,758)
  - BamAlignmentRecordLink + SA:Z / NM synthesis (src/align_util.cpp:301,452,642-808)
  - writeSam one-line linked-record streaming (src/f_io.cpp:313)
  - SAM header (src/mapper.cpp:288-324)

The emitted SAM matches the reference's pipeline-mode output (-b 1, the
default production path: p_calRecords src/mapper.cpp:404-473): mapQ is the
SeqAn default 255, SEQ/QUAL are '*' unless sequence_sam is requested, and
every record after the first of a read carries flag 2048 (supplementary).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..utils.cordscalar import M64, cy, cx, cid, strand, is_end, shift

BAM_FLAG_RVCMP = 16
BAM_FLAG_SUPPL = 2048
INF60 = (1 << 60) - 1  # FIOParms default thd_DI / thd_X (src/f_io.cpp:16)


@dataclass
class Cigar:
    op: str
    count: int


@dataclass
class Score:
    s1: int = 0
    s2: int = 0
    s3: int = 0


@dataclass
class BamLinkRecord:
    """BamAlignmentRecordLink (include/align_util.h:31-57), host flavor."""

    rID: int = -1
    beginPos: int = -1
    flag: int = 0
    mapQ: int = 255
    cigar: List[Cigar] = field(default_factory=list)
    next_id: int = -1
    available: bool = True
    genome_id: str = ""
    qName: str = ""
    nm_i: int = 0
    saz_cigar: Optional[List[Cigar]] = None
    score: Score = field(default_factory=Score)

    def is_chain_end(self) -> bool:
        return self.next_id < 0


def append_cigar_shrink(cigars: List[Cigar], op: str, count: int) -> None:
    """appendCigarShrink (src/f_io.cpp:659)."""
    if cigars and cigars[-1].op == op:
        cigars[-1].count += count
    else:
        cigars.append(Cigar(op, count))


def if_create_new(c1_str: int, c1_end: int, c2_str: int, c2_end: int, thd_large_X: int) -> bool:
    """ifCreateNew_ (src/f_io.cpp:674)."""
    x11, y11 = cx(c1_str), cy(c1_str)
    x12, y12 = cx(c1_end), cy(c1_end)
    x21, y21 = cx(c2_str), cy(c2_str)
    return bool(
        is_end(c1_str)
        or x11 > x21
        or y11 > y21
        or (x21 - x12 > thd_large_X and y21 - y12 > thd_large_X)
        or strand(c1_str ^ c2_str)
    )


def _rectangle_pair(cord1: int, cord2: int, f_m: int) -> Tuple[Cigar, Cigar]:
    """createRectangleCigarPair (src/f_io.cpp:697)."""
    dx = (cx(cord2) - cx(cord1)) & ((1 << 64) - 1)
    dy = (cy(cord2) - cy(cord1)) & ((1 << 64) - 1)
    op1 = '=' if not f_m else 'X'
    if dx >= dy:
        return Cigar(op1, dy), Cigar('D', dx - dy)
    return Cigar(op1, dx), Cigar('I', dy - dx)


def _score_pair(c1: Cigar, c2: Cigar, score: Score, thd_variant_indel_min_len: int = 100) -> None:
    """socreCigarPair (src/f_io.cpp:723)."""
    if c1.op in ('=', 'X') and c2.op in ('I', 'D'):
        if c1.op == '=':
            score.s1 += c1.count
            score.s3 += c1.count
        else:
            score.s2 += c1.count
        score.s2 += c2.count if c2.count < thd_variant_indel_min_len else 0
        if c2.op == 'I':
            score.s3 += c2.count


def cord2cigar(
    cigar_str: int,
    cord1_str: int,
    cord1_end: int,
    cord2_str: int,
    cigar: List[Cigar],
    score: Score,
    thd_DI: int,
    thd_X: int,
) -> int:
    """cord2cigar_ (src/f_io.cpp:758). Returns the next cigar start cord,
    or -1 on a diagonal mismatch error."""
    import math

    x0, y0 = cx(cigar_str), cy(cigar_str)
    x11, y11 = cx(cord1_str), cy(cord1_str)
    x12, y12 = cx(cord1_end), cy(cord1_end)
    x21, y21 = cx(cord2_str), cy(cord2_str)
    if x0 - y0 != x11 - y11:
        return -1
    if x12 >= x21 and y12 >= y21:
        c1, c2 = _rectangle_pair(cord1_str, cord2_str, 0)
        if c1.count:
            append_cigar_shrink(cigar, c1.op, c1.count)
        if c2.count:
            append_cigar_shrink(cigar, c2.op, c2.count)
    elif x12 < x21 and y12 < y21:
        c1, c2 = _rectangle_pair(cord1_str, cord1_end, 0)
        if c1.count:
            append_cigar_shrink(cigar, c1.op, c1.count)
        if c2.count:
            append_cigar_shrink(cigar, c2.op, c2.count)
        DI = (x21 - x12) - (y21 - y12)
        X = min(x21 - x12, y21 - y12)
        if abs(DI) > thd_DI and X > thd_X:
            split_n = min(int(math.ceil(float(abs(DI)) / thd_DI)), X)
            split_DI = thd_DI
            split_X = X // split_n
            split_cord_str = cord1_end
            c1, c2 = _rectangle_pair(cord1_end, cord2_str, 1)
            for _ in range(split_n - 1):
                split_cord_end = (
                    shift(split_cord_str, split_X, split_X + split_DI)
                    if DI < 0
                    else shift(split_cord_str, split_X + split_DI, split_X)
                )
                c1, c2 = _rectangle_pair(split_cord_str, split_cord_end, 0)
                if c1.count:
                    append_cigar_shrink(cigar, c1.op, c1.count)
                if c2.count:
                    append_cigar_shrink(cigar, c2.op, c2.count)
                split_cord_str = split_cord_end
            c1, c2 = _rectangle_pair(split_cord_str, cord2_str, 1)
            if c1.count:
                append_cigar_shrink(cigar, c1.op, c1.count)
            if c2.count:
                append_cigar_shrink(cigar, c2.op, c2.count)
        else:
            c1, c2 = _rectangle_pair(cord1_end, cord2_str, 1)
            if c1.count:
                append_cigar_shrink(cigar, c1.op, c1.count)
            if c2.count:
                append_cigar_shrink(cigar, c2.op, c2.count)
    else:
        c1, c2 = _rectangle_pair(cord1_str, cord2_str, 0)
        if c1.count:
            append_cigar_shrink(cigar, c1.op, c1.count)
        if c2.count:
            append_cigar_shrink(cigar, c2.op, c2.count)
    _score_pair(c1, c2, score)
    return cord2_str


def cords2bamlink(
    cords_str: List[int],
    cords_end: List[int],
    read_len: int,
    thd_large_X: int = 8000,
    thd_DI: int = INF60,
    thd_X: int = INF60,
) -> List[BamLinkRecord]:
    """cords2BamLink (src/f_io.cpp:883) for one read."""
    records: List[BamLinkRecord] = []
    f_new = True
    flag = 0
    cigar_str = 0
    bam_records_ptrs: List[int] = []
    cords_block_end_ptrs: List[int] = []
    n = len(cords_str)
    for i in range(1, n):
        if f_new:
            if i != 1:
                bam_records_ptrs.append(len(records) - 1)
                cords_block_end_ptrs.append(i - 1)
            f_new = False
            rec = BamLinkRecord(
                rID=cid(cords_str[i]),
                beginPos=cx(cords_str[i]),
                flag=flag | (BAM_FLAG_RVCMP if strand(cords_str[i]) else 0),
            )
            r_begin = cy(cords_str[i])
            if r_begin != 0:
                rec.cigar.append(Cigar('S', r_begin))
            records.append(rec)
            cigar_str = cords_str[i]
            flag = 0
        if i == n - 1 or if_create_new(
            cords_str[i], cords_end[i], cords_str[i + 1], cords_end[i + 1], thd_large_X
        ):
            cord1_str = cords_str[i]
            cord1_end = cords_end[i]
            cord2_str = cords_end[i]
            f_new = True
            flag = BAM_FLAG_SUPPL
        else:
            cord1_str = cords_str[i]
            cord1_end = cords_end[i]
            cord2_str = cords_str[i + 1]
        cigar_str = cord2cigar(
            cigar_str, cord1_str, cord1_end, cord2_str,
            records[-1].cigar, records[-1].score, thd_DI, thd_X,
        )
        if cigar_str == -1:
            break
        if i == n - 1:
            bam_records_ptrs.append(len(records) - 1)
            cords_block_end_ptrs.append(n - 1)
    for ptr, cep in zip(bam_records_ptrs, cords_block_end_ptrs):
        clipped_end_len = read_len - cy(cords_end[cep])
        if clipped_end_len > 0:
            records[ptr].cigar.append(Cigar('S', clipped_end_len))
    return records


# ------------------------------------------------------------ SA:Z / heads

def heads_of(records: List[BamLinkRecord]) -> List[int]:
    """updateHeadsTable (src/align_util.cpp:568): heads = first records of
    complete lines."""
    visited = [False] * len(records)
    heads: List[int] = []
    for i in range(len(records)):
        if visited[i]:
            continue
        it = i
        f_complete = False
        while True:
            visited[it] = True
            if not records[it].available:
                break
            if records[it].is_chain_end():
                f_complete = True
                break
            it = records[it].next_id
        if f_complete:
            heads.append(i)
    return heads


def _saz_cigar(cigar: List[Cigar]) -> Tuple[List[Cigar], int]:
    """createSAZTagCigar (src/align_util.cpp:452) with f_remove=0. Returns
    (S/M/I-or-D/S simplified cigar with zeros kept, nm_i). The reference's
    trailing-S detection is dead code (compares against the element length),
    so the trailing S always stays 0."""
    cm = 0
    ci = 0
    nm = 0
    lead_s = 0
    for i, c in enumerate(cigar):
        if i == 0 and c.op == 'S':
            lead_s = c.count
        elif c.op == '=':
            cm += c.count
        elif c.op == 'X':
            cm += c.count
            nm += c.count
        elif c.op == 'I':
            ci -= c.count
            nm += c.count
        elif c.op == 'D':
            ci += c.count
            nm += c.count
    mid = Cigar('I', -ci) if ci < 0 else Cigar('D', ci)
    return [Cigar('S', lead_s), Cigar('M', cm), mid, Cigar('S', 0)], nm


def _saz_one_chimeric(records: List[BamLinkRecord], it: int) -> str:
    """createSAZTagOneChimeric + createSAZTagOneLine inner part
    (src/align_util.cpp:642-712).

    Reference quirk replicated: each record's saz_cigar is computed once and
    cached; if every record of the chain was already cached (this head was
    serialized into an earlier head's SA tag), nm_i is RESET to 0
    (src/align_util.cpp:649-676 nm_i_sum == neg_infi path)."""
    merged: List[Cigar] = []
    nm_sum = 0
    any_computed = False
    head = records[it]
    j = it
    while True:
        if records[j].saz_cigar is None:
            sc, nm = _saz_cigar(records[j].cigar)
            records[j].saz_cigar = sc
            nm_sum += nm
            any_computed = True
        else:
            sc = records[j].saz_cigar
        for k, c in enumerate(sc):
            if k >= len(merged):
                merged.append(Cigar(c.op, c.count))
            else:
                merged[k].count += c.count
        if records[j].is_chain_end():
            break
        j = records[j].next_id
    head.nm_i = nm_sum if any_computed else 0
    cig_txt = "".join(f"{c.count}{c.op}" for c in merged)
    std = '-' if head.flag & 16 else '+'
    return f"{head.genome_id},{head.beginPos + 1},{std},{cig_txt},{head.mapQ},{head.nm_i};"


def fill_bam_records(
    records: List[BamLinkRecord],
    genome_ids: List[str],
    read_id: str,
) -> None:
    """fillBamRecordLinkRecords (src/align_util.cpp:745) without seq
    synthesis (f_print_seq=0 default)."""
    heads = heads_of(records)
    for it in heads:
        records[it].genome_id = genome_ids[records[it].rID]
        records[it].qName = read_id
    for it in heads:
        saz = "".join(_saz_one_chimeric(records, j) for j in heads if j != it)
        records[it].saz_tag = saz  # type: ignore[attr-defined]


def sam_lines(records: List[BamLinkRecord]) -> List[str]:
    """writeSam (src/f_io.cpp:313) for every head line."""
    out: List[str] = []
    for it in heads_of(records):
        rec = records[it]
        cig_parts: List[str] = []
        j = it
        while True:
            cig_parts.extend(f"{c.count}{c.op}" for c in records[j].cigar)
            if records[j].is_chain_end():
                break
            j = records[j].next_id
        cig = "".join(cig_parts) or "*"
        seq = getattr(rec, "seq", "") or "*"
        fields = [
            rec.qName,
            str(rec.flag),
            rec.genome_id,
            str(rec.beginPos + 1),
            str(rec.mapQ),
            cig,
            "*",
            "0",
            "0",
            seq,
            "*",
        ]
        saz = getattr(rec, "saz_tag", "")
        if saz:
            fields.append(f"SA:Z:{saz}")
        out.append("\t".join(fields))
    return out


def sam_header(
    genome_ids: List[str],
    genome_lens: List[int],
    read_group: str,
    sample_name: str,
    cmd_line: str,
) -> str:
    """setMapperBamHeaders + SeqAn writeHeader (src/mapper.cpp:288-321)."""
    lines = [f"@SQ\tSN:{gid}\tLN:{ln}" for gid, ln in zip(genome_ids, genome_lens)]
    lines.append(f"@RG\tID:{read_group}\tSM:{sample_name}")
    lines.append(f"@PG\tID:M1-3\tPN:Linear\tCL:{cmd_line}")
    return "\n".join(lines) + "\n"


def reform_ccs_bams(records: List[BamLinkRecord], thd_rcb_xy: int = 15) -> None:
    """reformCCSBams (src/f_io.cpp:1166): fold small I/D (tracked drift
    |xy| < thd) into '=' for CCS cigar compression. NOTE: in the reference
    this is only reachable from dead code (print_cords_sam, commented out at
    src/f_io.cpp:1244-1279) — the -r flag is accepted but inert there; here
    it is functional."""
    visited = [False] * len(records)
    for i in range(len(records)):
        if visited[i]:
            continue
        it = i
        xy = 0
        while True:
            visited[it] = True
            cig = records[it].cigar
            out: List[Cigar] = []
            for c in cig:
                new_count = c.count
                comp_count = new_count
                comp_op = c.op
                if c.op == 'I':
                    if abs(xy + new_count) < thd_rcb_xy:
                        xy += new_count
                        comp_op = '='
                        comp_count = new_count
                elif c.op == 'D':
                    if abs(xy - new_count) < thd_rcb_xy:
                        xy -= new_count
                        comp_op = '='
                        comp_count = 0
                if out and out[-1].op == comp_op:
                    out[-1].count += comp_count
                elif comp_count != 0:
                    out.append(Cigar(comp_op, comp_count))
            records[it].cigar = out
            if records[it].is_chain_end():
                break
            it = records[it].next_id


def synth_seq(records: List[BamLinkRecord], genomes: List["np.ndarray"],
              read: "np.ndarray", rc: "np.ndarray", f_is_align: int = 0) -> None:
    """cigar2SamSeq over each head line (src/align_util.cpp:1434,
    fillBamRecordLinkRecords :745-788): synthesize the SEQ field when
    sequence_sam is enabled. The runtime default is f_is_align =
    options.aln_flag = 0 (src/mapper.cpp:282): '='/'M' emit GENOME bases,
    'X' emits the read base where it differs from the genome else 'N',
    'I'/'S' emit read bases, 'D' advances the genome, 'H' the read.
    (The f_is_align=1 branch belongs to the -a align path, dead in the
    reference CLI.)"""
    bases = "ACGTN"
    for it in heads_of(records):
        rec = records[it]
        genome = genomes[rec.rID]
        src2 = rc if rec.flag & 16 else read
        i1 = rec.beginPos
        i2 = 0
        parts: List[str] = []
        j = it
        while True:
            for c in records[j].cigar:
                if c.op == 'D':
                    i1 += c.count
                elif c.op == 'I' or c.op == 'S':
                    seg = src2[i2: i2 + c.count]
                    parts.append("".join(bases[b] for b in seg))
                    i2 += c.count
                elif c.op in ('M', '='):
                    if f_is_align:
                        seg = src2[i2: i2 + c.count]
                    else:
                        seg = genome[i1: i1 + c.count]
                    parts.append("".join(bases[b] for b in seg))
                    i1 += c.count
                    i2 += c.count
                elif c.op == 'X':
                    if f_is_align:
                        parts.append("".join(bases[b] for b in src2[i2: i2 + c.count]))
                    else:
                        for k in range(c.count):
                            g = genome[i1 + k]
                            r = src2[i2 + k]
                            parts.append(bases[r] if g != r else 'N')
                    i1 += c.count
                    i2 += c.count
                elif c.op == 'H':
                    i2 += c.count
            if records[j].is_chain_end():
                break
            j = records[j].next_id
        rec.seq = "".join(parts)  # type: ignore[attr-defined]


def sam_header_pbsv(genome_ids: List[str], genome_lens: List[int],
                    read_group: str, sample_name: str, cmd_line: str) -> str:
    """bam_header2 (src/mapper.cpp:308-312): the pbsv variant writes the RG
    ID tag with a leading space (setTagValue(\" ID\", ...) quirk)."""
    lines = [f"@SQ\tSN:{gid}\tLN:{ln}" for gid, ln in zip(genome_ids, genome_lens)]
    lines.append(f"@RG\t ID:{read_group}\tSM:{sample_name}")
    lines.append(f"@PG\tID:M1-3\tPN:Linear\tCL:{cmd_line}")
    return "\n".join(lines) + "\n"
