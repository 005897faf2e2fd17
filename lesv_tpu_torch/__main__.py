"""lesv_tpu_torch command-line interface.

  python -m lesv_tpu_torch run cfg [--device cuda]   # full pipeline -> VCF
  python -m lesv_tpu_torch map ref.fa reads.fa [-o out.m4]
                               [--outfmt m4|paf|sam] [--device cuda]

The same pipeline and mapper as ``python -m lesv_tpu run`` / ``map``, on a
torch device; config files use the same key=value format.  The default
device is ``cuda``; without a GPU a command fails unless ``--device cpu``
is given explicitly.
"""

from __future__ import annotations

import argparse
import sys


def resolve_device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("lesv_tpu_torch: CUDA is not available; pass "
                         "--device cpu to run on the CPU")
    return dev


def parse_cfg(path: str) -> dict[str, str]:
    out: dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_datasize(s: str) -> int:
    """Reference datasize strings: '2g', '500m', '8k' or plain ints
    (NStr::StringToUInt8_DataSize semantics for the suffixes used in the
    published configs, README.md:138,164)."""
    s = s.strip().lower()
    mult = {"k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12}
    if s and s[-1] in mult:
        return int(float(s[:-1]) * mult[s[-1]])
    return int(s)


def build_config(kv: dict[str, str]):
    from lesv_tpu_torch.config import LesvConfig

    cfg = LesvConfig()
    if kv.get("MAX_SUBSEQ_SIZE"):
        cfg.split.max_subseq_size = int(kv["MAX_SUBSEQ_SIZE"])
    if kv.get("SUBSEQ_OVLP_SIZE"):
        cfg.split.overlap_size = int(kv["SUBSEQ_OVLP_SIZE"])
    if kv.get("MIN_LAST_SUBSEQ_SIZE"):
        cfg.split.min_last_subseq_size = int(kv["MIN_LAST_SUBSEQ_SIZE"])
    if kv.get("SVR_MIN_SEQ_SIZE"):
        cfg.sv_read.min_seq_size = int(kv["SVR_MIN_SEQ_SIZE"])
    if kv.get("SVR_MIN_SVE_PERC_IDENTITY"):
        cfg.sv_read.min_ident_perc = float(kv["SVR_MIN_SVE_PERC_IDENTITY"])
    if kv.get("SVR_MAX_OVERHANG"):
        cfg.sv_read.max_overhang = int(kv["SVR_MAX_OVERHANG"])
    if kv.get("SVSIG_MIN_INDEL_SIZE"):
        cfg.sv_sig.min_indel_size = int(kv["SVSIG_MIN_INDEL_SIZE"])
    # MAP_OPTIONS: reference-style flags, e.g. "-kmer_size 19 -kmer_window 20"
    opts = kv.get("MAP_OPTIONS", "").strip("\"'").split()
    flag_map = {
        # flag surface mirrors `app/map/cmdline_args.cpp:15-89`
        "-kmer_size": ("index", "kmer_size", int),
        "-kmer_window": ("index", "kmer_window", int),
        "-max_kmer_occ": ("index", "max_kmer_occ", int),
        "-max_target_seqs": ("map", "max_target_seqs", int),
        "-max_hsps": ("map", "max_hsps", int),
        "-qcov_hsp_res": ("map", "qcov_hsp_res", int),
        "-perc_identity": ("map", "perc_identity", float),
        "-min_query_size": ("map", "min_query_size", int),
        "-query_batch_size": ("map", "query_batch_size", parse_datasize),
        "-max_query_vol_res": ("map", "max_query_vol_res", parse_datasize),
        "-max_subject_vol_res": ("map", "max_subject_vol_res",
                                 parse_datasize),
        "-memsc_kmer_size": ("memsc", "kmer_size", int),
        "-memsc_kmer_window": ("memsc", "kmer_window", int),
        "-memsc_mem_score": ("memsc", "mem_score", int),
        "-memsc_mem_size": ("memsc", "mem_size", int),
        "-num_threads": (None, "num_threads", int),
    }
    # boolean flags (no value operand)
    bool_map = {
        "-skip_memsc": ("memsc", "skip_memsc"),
    }
    # accepted but meaningless here (no separate db-build step to keep,
    # multi-node sharding is `parallel.dist`, outfmt fixed by the stage)
    noop_value = {"-grid", "-outfmt", "-db_dir", "-block_size",
                  "-min_ddfs"}
    noop_bool = {"-keep_db", "-cigar", "-md", "-skip_overhang"}
    i = 0
    while i < len(opts):
        f = opts[i]
        if f in flag_map and i + 1 < len(opts):
            sect, attr, typ = flag_map[f]
            tgt = getattr(cfg, sect) if sect else cfg
            setattr(tgt, attr, typ(opts[i + 1]))
            i += 2
        elif f in bool_map:
            sect, attr = bool_map[f]
            setattr(getattr(cfg, sect), attr, True)
            i += 1
        elif f in noop_bool:
            i += 1
        elif f in noop_value and i + 1 < len(opts):
            i += 2
        else:
            print(f"lesv_tpu_torch: warning: unknown MAP_OPTIONS flag {f!r} "
                  "ignored", file=sys.stderr)
            i += 1
    return cfg


def load_trf_bed(path: str, name_to_sid) -> dict[int, list[tuple[int, int]]]:
    """TRF bed file -> {sid: [(start, end)]} (reference TrfArrayBuild)."""
    out: dict[int, list[tuple[int, int]]] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 3:
                continue
            try:
                sid = name_to_sid(parts[0])
            except KeyError:
                continue
            out.setdefault(sid, []).append((int(parts[1]), int(parts[2])))
    return out


def cmd_run(args):
    from lesv_tpu_torch.io.fasta import read_fastx
    from lesv_tpu_torch.pipeline.driver import run_pipeline

    device = resolve_device(args.device)
    kv = parse_cfg(args.cfg)
    project = kv.get("PROJECT") or "lesv_tpu_torch_project"
    cfg = build_config(kv)
    ref = list(read_fastx(kv["REFERENCE"]))
    reads = list(read_fastx(kv["RAW_READS"]))
    trf = None
    if kv.get("TRF_FILE"):
        names = {n: i for i, (n, _) in enumerate(ref)}
        trf = load_trf_bed(kv["TRF_FILE"], names.__getitem__)
    res = run_pipeline(ref, reads, cfg, trf_intervals=trf,
                       out_dir=project, resume=True, device=device)
    print(f"{len(res.calls)} SV calls -> {project}/calls.vcf")
    for k, v in res.stats.items():
        print(f"  {k}: {v}")


def cmd_map(args):
    from lesv_tpu_torch.config import LesvConfig
    from lesv_tpu_torch.index.kmer_index import KmerIndex
    from lesv_tpu_torch.io.fasta import read_fastx
    from lesv_tpu_torch.io.seqstore import SeqStore, split_subreads
    from lesv_tpu_torch.pipeline.stages_io import (
        format_m4_text,
        format_mapper_sam,
        format_paf,
    )
    from lesv_tpu_torch.pipeline.mapper import map_all

    device = resolve_device(args.device)
    cfg = LesvConfig()
    sstore = SeqStore.from_records(read_fastx(args.reference))
    index = KmerIndex.build(sstore, cfg.index)
    reads = list(split_subreads(read_fastx(args.reads), cfg.split))
    m4s, qstore = map_all(reads, sstore, index, cfg, device=device)
    if args.outfmt == "m4":
        text = format_m4_text(m4s, qstore.name_of, sstore.name_of)
    elif args.outfmt == "paf":
        text = format_paf(m4s, qstore.name_of, sstore.name_of)
    else:
        text = format_mapper_sam(m4s, qstore, sstore)
    if args.out == "-":
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as fh:
            fh.write(text)
        print(f"{len(m4s)} records -> {args.out}", file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(prog="lesv_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="run the full SV-calling pipeline")
    pr.add_argument("cfg")
    pr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu is explicit)")
    pr.set_defaults(fn=cmd_run)
    pm = sub.add_parser("map", help="map reads, emit M4/PAF/SAM")
    pm.add_argument("reference")
    pm.add_argument("reads")
    pm.add_argument("-o", "--out", default="-")
    pm.add_argument("--outfmt", choices=["m4", "paf", "sam"], default="m4")
    pm.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu is explicit)")
    pm.set_defaults(fn=cmd_map)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
