"""SAM v1.6 emission for remapped consensus reads.

Mirrors the reference SAM output (`app/cns_sv_read_group/map_results.c`):
one @RG per chromosome, reads named by their corrected-read header, CIGAR
with M/I/D and soft clips.
"""

from __future__ import annotations

import numpy as np

from lesv_tpu_torch.io.fasta import decode_seq
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops.align_np import OP_D, OP_I, OP_M
from lesv_tpu_torch.ops.cigar import op_runs


def sam_header(sstore: SeqStore, sample: str = "lesv_tpu") -> str:
    lines = ["@HD\tVN:1.6\tSO:unknown"]
    for sid in range(sstore.num_seqs):
        lines.append(f"@SQ\tSN:{sstore.name_of(sid)}\tLN:{sstore.seq_size(sid)}")
    for sid in range(sstore.num_seqs):
        lines.append(
            f"@RG\tID:rg{sid}\tSM:{sample}\tPL:ONT\tDS:READTYPE=SUBREAD")
    lines.append("@PG\tID:lesv_tpu\tPN:lesv_tpu\tVN:0.1.0")
    return "\n".join(lines) + "\n"


def cigar_string(ops: np.ndarray, soft_left: int = 0, soft_right: int = 0) -> str:
    parts = []
    if soft_left:
        parts.append(f"{soft_left}S")
    opv, lens = op_runs(ops)
    sym = {OP_M: "M", OP_I: "I", OP_D: "D"}
    for o, l in zip(opv, lens):
        parts.append(f"{int(l)}{sym[int(o)]}")
    if soft_right:
        parts.append(f"{soft_right}S")
    return "".join(parts) if parts else "*"


def sam_record(
    name: str,
    rev: bool,
    sid_name: str,
    pos0: int,
    mapq: int,
    ops: np.ndarray,
    seq: np.ndarray,
    rg: str,
    tags: dict | None = None,
) -> str:
    """One alignment line; ``seq`` is the aligned (sub)sequence, already in
    the orientation written to the file; pos0 is 0-based."""
    flag = 16 if rev else 0
    cig = cigar_string(ops)
    fields = [
        name, str(flag), sid_name, str(pos0 + 1), str(mapq), cig,
        "*", "0", "0", decode_seq(seq), "*", f"RG:Z:{rg}",
    ]
    if tags:
        for k, v in tags.items():
            t = "i" if isinstance(v, (int, np.integer)) else "Z"
            fields.append(f"{k}:{t}:{v}")
    return "\t".join(fields) + "\n"
