"""lesv_tpu_torch command-line interface (the ``map`` stage).

  python -m lesv_tpu_torch map ref.fa reads.fa [-o out.m4]
                               [--outfmt m4|paf|sam] [--device cuda]

The same mapper as ``python -m lesv_tpu map``, on a torch device.  The
default device is ``cuda``; without a GPU the command fails unless
``--device cpu`` is given explicitly.
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


def cmd_map(args):
    from lesv_tpu.config import LesvConfig
    from lesv_tpu.index.kmer_index import KmerIndex
    from lesv_tpu.io.fasta import read_fastx
    from lesv_tpu.io.seqstore import SeqStore, split_subreads
    from lesv_tpu.pipeline.stages_io import (
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
