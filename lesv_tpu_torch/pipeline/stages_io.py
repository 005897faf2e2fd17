"""Stage artifact serialization for the checkpointed driver.

The reference communicates between its 8 binaries through files in the
project directory with `.done` markers enabling resume (`lesv.sh:78-233`,
`hbn_job_control.c:30-48`).  Here each stage's output is one compact
npz/JSON artifact + a `.done` marker; a completed stage is loaded instead
of recomputed.
"""

from __future__ import annotations

import json
import os

import numpy as np

from lesv_tpu_torch.pipeline.cns import CorrectedRead
from lesv_tpu_torch.pipeline.mapper import M4
from lesv_tpu_torch.pipeline.remap import RemapResult
from lesv_tpu_torch.pipeline.signatures import SvSignature
from lesv_tpu_torch.pipeline.sv_reads import SvRead


def done_path(out_dir: str, stage: str) -> str:
    return os.path.join(out_dir, f"{stage}.done")


def is_done(out_dir: str, stage: str) -> bool:
    return os.path.exists(done_path(out_dir, stage))


def mark_done(out_dir: str, stage: str) -> None:
    with open(done_path(out_dir, stage), "w") as fh:
        fh.write("ok\n")


def _read_npz(path: str) -> dict[str, np.ndarray]:
    """Every array of a checkpoint, decompressed once (indexing an open
    ``NpzFile`` per record decompresses the whole array each time)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---- M4 ----

def save_m4s(path: str, m4s: list[M4]) -> None:
    n = len(m4s)
    cols = {k: np.zeros(n, np.int64) for k in
            ("qid", "qdir", "qoff", "qend", "qsize", "sid", "soff", "send",
             "ssize", "score", "dist")}
    ident = np.zeros(n, np.float64)
    ops_flat = []
    ops_len = np.zeros(n, np.int64)
    for i, m in enumerate(m4s):
        for k in cols:
            cols[k][i] = getattr(m, k)
        ident[i] = m.ident_perc
        o = m.ops if m.ops is not None else np.empty(0, np.uint8)
        ops_flat.append(o)
        ops_len[i] = len(o)
    np.savez_compressed(
        path, ident_perc=ident, ops_len=ops_len,
        ops=np.concatenate(ops_flat) if ops_flat else np.empty(0, np.uint8),
        **cols)


def load_m4s(path: str) -> list[M4]:
    z = _read_npz(path)
    n = len(z["qid"])
    out = []
    off = 0
    ops = z["ops"]
    for i in range(n):
        L = int(z["ops_len"][i])
        out.append(M4(
            qid=int(z["qid"][i]), qdir=int(z["qdir"][i]),
            qoff=int(z["qoff"][i]), qend=int(z["qend"][i]),
            qsize=int(z["qsize"][i]), sid=int(z["sid"][i]),
            soff=int(z["soff"][i]), send=int(z["send"][i]),
            ssize=int(z["ssize"][i]), ident_perc=float(z["ident_perc"][i]),
            score=int(z["score"][i]), dist=int(z["dist"][i]),
            ops=ops[off : off + L].copy() if L else None,
        ))
        off += L
    return out


def format_m4_text(m4s: list[M4], qnames, snames) -> str:
    """Reference 12-column text M4 (`corelib/m4_record.h` DUMP_M4_RECORD):
    qid sid ident score qdir qoff qend qsize sdir soff send ssize."""
    lines = []
    for m in m4s:
        lines.append("\t".join(map(str, [
            qnames(m.qid), snames(m.sid), f"{m.ident_perc:.2f}", m.score,
            m.qdir, m.qoff, m.qend, m.qsize,
            0, m.soff, m.send, m.ssize])))
    return "\n".join(lines) + ("\n" if lines else "")


def format_paf(m4s: list[M4], qnames, snames) -> str:
    """PAF output (reference mapper `-outfmt paf` equivalent).

    Query coordinates are converted to forward-strand (PAF convention);
    strand column carries the mapping orientation."""
    lines = []
    for m in m4s:
        if m.qdir == 0:
            qs, qe = m.qoff, m.qend
        else:
            qs, qe = m.qsize - m.qend, m.qsize - m.qoff
        if m.ops is not None:
            alen = len(m.ops)
            nmatch = int(round(m.ident_perc / 100.0 * alen))
        else:
            alen = max(m.qend - m.qoff, m.send - m.soff)
            nmatch = int(round(m.ident_perc / 100.0 * alen))
        lines.append("\t".join(map(str, [
            qnames(m.qid), m.qsize, qs, qe,
            "+" if m.qdir == 0 else "-",
            snames(m.sid), m.ssize, m.soff, m.send,
            nmatch, alen, 60])))
    return "\n".join(lines) + ("\n" if lines else "")


def format_mapper_sam(m4s: list[M4], qstore, sstore) -> str:
    """SAM output for mapper results (reference `-outfmt sam` /
    `mecat_results.c`): soft-clipped alignment per M4."""
    from lesv_tpu_torch.io.fasta import revcomp
    from lesv_tpu_torch.io.sam import cigar_string, sam_header

    out = [sam_header(sstore)]
    for m in m4s:
        if m.ops is None:
            continue
        read = qstore.get(m.qid, rc=(m.qdir == 1))
        flag = 16 if m.qdir == 1 else 0
        cig = cigar_string(m.ops, soft_left=m.qoff,
                           soft_right=m.qsize - m.qend)
        from lesv_tpu_torch.io.fasta import decode_seq

        out.append("\t".join([
            qstore.name_of(m.qid), str(flag), sstore.name_of(m.sid),
            str(m.soff + 1), "60", cig, "*", "0", "0",
            decode_seq(read), "*",
            f"NM:i:{m.dist}", f"RG:Z:rg{m.sid}"]) + "\n")
    return "".join(out)


# ---- SvRead ----

_SVR_FIELDS = ("query_id", "qdir", "qoff", "qend", "qsize",
               "subject_id", "soff", "send", "dist")


def save_sv_reads(path: str, svrs: list[SvRead]) -> None:
    cols = {k: np.array([getattr(r, k) for r in svrs], np.int64)
            for k in _SVR_FIELDS}
    np.savez_compressed(path, **cols)


def load_sv_reads(path: str) -> list[SvRead]:
    z = _read_npz(path)
    n = len(z["query_id"])
    return [SvRead(**{k: int(z[k][i]) for k in _SVR_FIELDS})
            for i in range(n)]


# ---- SvSignature ----

_SIG_INT_FIELDS = ("qid", "qdir", "qfrom", "qto", "sfrom", "sto",
                   "subject_id", "length", "aln_qb", "aln_qe", "aln_sb",
                   "aln_se")


def save_signatures(path: str, sigs: list[SvSignature]) -> None:
    cols = {k: np.array([getattr(s, k) for s in sigs], np.int64)
            for k in _SIG_INT_FIELDS}
    kind = np.array([1 if s.kind == "INS" else 0 for s in sigs], np.int8)
    np.savez_compressed(path, kind=kind, **cols)


def load_signatures(path: str) -> list[SvSignature]:
    z = _read_npz(path)
    n = len(z["qid"])
    out = []
    for i in range(n):
        kw = {k: int(z[k][i]) for k in _SIG_INT_FIELDS}
        out.append(SvSignature(kind="INS" if z["kind"][i] else "DEL", **kw))
    return out


# ---- corrected reads ----

def save_corrected(path: str, crs: list[CorrectedRead]) -> None:
    meta = []
    seq_flat = []
    for c in crs:
        meta.append(dict(
            global_id=c.global_id, name=c.name, cns_from=c.cns_from,
            cns_to=c.cns_to, fsqdir=c.fsqdir, subject_id=c.subject_id,
            fsfrom=c.fsfrom, fsto=c.fsto, group_id=c.group_id,
            kind=c.kind, seq_len=len(c.seq)))
        seq_flat.append(c.seq)
    np.savez_compressed(
        path,
        seqs=np.concatenate(seq_flat) if seq_flat else np.empty(0, np.uint8),
        meta=json.dumps(meta))


def load_corrected(path: str) -> list[CorrectedRead]:
    z = _read_npz(path)
    meta = json.loads(str(z["meta"]))
    seqs = z["seqs"]
    out = []
    off = 0
    for m in meta:
        L = m.pop("seq_len")
        out.append(CorrectedRead(seq=seqs[off : off + L].copy(), **m))
        off += L
    return out


# ---- remap results ----

def save_remapped(path: str, rs: list[RemapResult]) -> None:
    meta = []
    ops_flat = []
    seq_flat = []
    for r in rs:
        meta.append(dict(
            name=r.name, global_id=r.global_id, rev=bool(r.rev),
            subject_id=r.subject_id, pos=r.pos, end=r.end,
            ident_perc=r.ident_perc, eff_ident_perc=r.eff_ident_perc,
            group_id=r.group_id, kind=r.kind,
            ops_len=len(r.ops), seq_len=len(r.seq)))
        ops_flat.append(r.ops)
        seq_flat.append(r.seq)
    np.savez_compressed(
        path,
        ops=np.concatenate(ops_flat) if ops_flat else np.empty(0, np.uint8),
        seqs=np.concatenate(seq_flat) if seq_flat else np.empty(0, np.uint8),
        meta=json.dumps(meta))


def load_remapped(path: str) -> list[RemapResult]:
    z = _read_npz(path)
    meta = json.loads(str(z["meta"]))
    ops, seqs = z["ops"], z["seqs"]
    out = []
    oo = so = 0
    for m in meta:
        ol = m.pop("ops_len")
        sl = m.pop("seq_len")
        out.append(RemapResult(
            ops=ops[oo : oo + ol].copy(), seq=seqs[so : so + sl].copy(), **m))
        oo += ol
        so += sl
    return out
