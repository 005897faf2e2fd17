"""VCF 4.2 emission for DEL/INS calls (replaces bgzip'd pbsv output,
`x_hqx2callsv.sh:110-122`)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lesv_tpu_torch.io.fasta import decode_seq
from lesv_tpu_torch.io.seqstore import SeqStore


@dataclass
class VcfCall:
    subject_id: int
    pos: int          # 0-based position of the base before the event
    kind: str         # "DEL" | "INS"
    length: int
    ref: str
    alt: str
    support: int
    depth: int
    genotype: str     # "0/1" | "1/1"


def vcf_header(sstore: SeqStore, sample: str = "lesv_tpu") -> str:
    lines = [
        "##fileformat=VCFv4.2",
        "##source=lesv_tpu",
    ]
    for sid in range(sstore.num_seqs):
        lines.append(
            f"##contig=<ID={sstore.name_of(sid)},length={sstore.seq_size(sid)}>")
    lines += [
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">',
        '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="SV length">',
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End position">',
        '##INFO=<ID=SUPPORT,Number=1,Type=Integer,Description="Supporting reads">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allele depths">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + sample,
    ]
    return "\n".join(lines) + "\n"


def vcf_line(call: VcfCall, sstore: SeqStore, idx: int) -> str:
    chrom = sstore.name_of(call.subject_id)
    svlen = call.length if call.kind == "INS" else -call.length
    end = call.pos + 1 + (call.length if call.kind == "DEL" else 0)
    info = (f"SVTYPE={call.kind};SVLEN={svlen};END={end};"
            f"SUPPORT={call.support}")
    ad = f"{max(call.depth - call.support, 0)},{call.support}"
    return "\t".join([
        chrom, str(call.pos + 1), f"lesv_tpu.{call.kind}.{idx}",
        call.ref, call.alt, "60", "PASS", info, f"GT:AD",
        f"{call.genotype}:{ad}",
    ]) + "\n"


def write_vcf(path: str, calls: list[VcfCall], sstore: SeqStore,
              sample: str = "lesv_tpu") -> None:
    calls = sorted(calls, key=lambda c: (c.subject_id, c.pos))
    with open(path, "w") as fh:
        fh.write(vcf_header(sstore, sample))
        for i, c in enumerate(calls):
            fh.write(vcf_line(c, sstore, i))
