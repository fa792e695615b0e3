"""Binary BAM output: BGZF container + BAM record encoding.

Mirrors printAlignBam (src/f_io.cpp:580) which converts linked records to
single-record lines (convert2SeqanCompatibleFormat, src/align_util.cpp:813)
and writes them with SeqAn's BAM writer. Standard BAM spec encoding; the
pbsv variant differs only in the header text (bam_header2 quirk, see
bamlink.sam_header_pbsv).
"""
from __future__ import annotations

import struct
import zlib
from typing import List

from .bamlink import BamLinkRecord, heads_of

_CIGAR_OP = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}
_SEQ_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def bgzf_block(data: bytes) -> bytes:
    """One BGZF block (gzip member with BC extra field)."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25 + 1
    header = (
        b"\x1f\x8b\x08\x04" + b"\x00" * 6 +
        struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize - 1)
    )
    return header + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def bgzf_compress(data: bytes, block: int = 60000) -> bytes:
    out = []
    for i in range(0, max(len(data), 1), block):
        out.append(bgzf_block(data[i:i + block]))
    return b"".join(out)


def encode_bam_header(header_text: str, ref_names: List[str], ref_lens: List[int]) -> bytes:
    """Reference quirk: printAlignBamHeader (src/f_io.cpp:509-523) writes
    through a BamFileOut whose context comes from an unrelated, EMPTY
    BamFileIn — so n_ref is 0 and no reference dictionary is emitted even
    though records carry rIDs.  Mirrored for byte-identity (the @SQ lines in
    the text header carry the contig info downstream tools use)."""
    del ref_names, ref_lens
    parts = [b"BAM\x01", struct.pack("<i", len(header_text)), header_text.encode()]
    parts.append(struct.pack("<i", 0))
    return b"".join(parts)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def encode_record(qname: str, flag: int, ref_id: int, pos: int, mapq: int,
                  cigar: list, seq: str, tags: bytes) -> bytes:
    name = qname.encode() + b"\x00"
    cig = b"".join(struct.pack("<I", (c.count << 4) | _CIGAR_OP[c.op]) for c in cigar)
    ref_len = sum(c.count for c in cigar if c.op in "MDN=X")
    end = pos + max(ref_len, 1)
    sq = b""
    l_seq = 0
    if seq and seq != "*":
        l_seq = len(seq)
        codes = [_SEQ_NT16.get(ch, 15) for ch in seq]
        if len(codes) % 2:
            codes.append(0)
        sq = bytes((codes[i] << 4) | codes[i + 1] for i in range(0, len(codes), 2))
    qual = b"\xff" * l_seq
    body = struct.pack(
        "<iiBBHHHiiii",
        ref_id, pos, len(name), mapq, _reg2bin(pos, end), len(cigar),
        flag, l_seq, -1, -1, 0,
    ) + name + cig + sq + qual + tags
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, header_text: str, ref_names: List[str], ref_lens: List[int],
              record_lines: List[dict]) -> None:
    """record_lines: dicts with qname/flag/ref_id/pos/mapq/cigar/seq/saz."""
    payload = [encode_bam_header(header_text, ref_names, ref_lens)]
    for r in record_lines:
        tags = b""
        if r.get("saz"):
            tags = b"SAZ" + r["saz"].encode() + b"\x00"
        payload.append(encode_record(
            r["qname"], r["flag"], r["ref_id"], r["pos"], r.get("mapq", 255),
            r["cigar"], r.get("seq", ""), tags,
        ))
    with open(path, "wb") as fh:
        fh.write(bgzf_compress(b"".join(payload)))
        fh.write(BGZF_EOF)


def records_to_bam_lines(records: List[BamLinkRecord]) -> List[dict]:
    """Flatten head lines (concatenating linked cigars as
    convert2SeqanCompatibleFormat does) into writable dicts."""
    out = []
    for it in heads_of(records):
        rec = records[it]
        cig = []
        j = it
        while True:
            cig.extend(records[j].cigar)
            if records[j].is_chain_end():
                break
            j = records[j].next_id
        out.append({
            "qname": rec.qName,
            "flag": rec.flag,
            "ref_id": rec.rID,
            "pos": rec.beginPos,
            "mapq": rec.mapQ,
            "cigar": cig,
            "seq": getattr(rec, "seq", ""),
            "saz": getattr(rec, "saz_tag", ""),
        })
    return out
