"""Scale shakeout of lesv_tpu_torch: simulate a genome with planted SVs,
run the full pipeline on a torch device, report stage timings +
precision/recall vs the planted truth.

The port's counterpart of ``tools/scale_run.py``: the same flags, world
and JSON, on ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions).  The JSON adds ``device``, the card's ``nvidia-smi`` name and
power limit (``card``), the routing switch ``LESV_TORCH_HOST_SMALL``
(``auto`` where unset), peak device memory allocated and reserved, kernel
launches per kernel with the wide-design fill launches (``fill_block``,
W > 2,048), and the fills that went to the card and to the host
(``align_batch.FILL_STATS``).

  python3 tools/torch_scale_run.py --genome 1000000 --coverage 15 \\
      --out build/scale_run
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np  # noqa: E402

from lesv_tpu_torch.config import LesvConfig  # noqa: E402
from lesv_tpu_torch.pipeline.driver import run_pipeline  # noqa: E402
from lesv_tpu_torch.sim import (plant_svs, random_genome,  # noqa: E402
                                simulate_reads)
from torch_f1_eval import kernel_report  # noqa: E402
from torch_genome_scale import card_line  # noqa: E402


def evaluate(calls, truth, refdist=1000, len_ratio=0.7):
    """truvari-style matching: DEL/INS within refdist and size similarity."""
    matched = set()
    tp = 0
    for sv in truth.svs:
        best = None
        for i, c in enumerate(calls):
            if i in matched or c.kind != sv.kind:
                continue
            if abs(c.pos - sv.ref_pos) > refdist:
                continue
            if min(c.length, sv.length) < len_ratio * max(c.length, sv.length):
                continue
            if best is None or abs(c.pos - sv.ref_pos) < abs(calls[best].pos - sv.ref_pos):
                best = i
        if best is not None:
            matched.add(best)
            tp += 1
    fn = len(truth.svs) - tp
    fp = len(calls) - len(matched)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return dict(tp=tp, fp=fp, fn=fn, precision=prec, recall=rec, f1=f1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=1_000_000)
    ap.add_argument("--coverage", type=float, default=15.0)
    ap.add_argument("--n-del", type=int, default=8)
    ap.add_argument("--n-ins", type=int, default=8)
    ap.add_argument("--err", type=float, default=0.1)
    ap.add_argument("--mean-len", type=int, default=12_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.ops import align_batch

    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("torch_scale_run: CUDA is not available "
                         "(--device cpu runs the plain versions)")
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    genome = random_genome(rng, args.genome)
    donor, truth = plant_svs(rng, genome, n_del=args.n_del, n_ins=args.n_ins,
                             min_len=50, max_len=2_000,
                             margin=20_000, min_gap=30_000)
    reads = simulate_reads(rng, donor, coverage=args.coverage,
                           mean_len=args.mean_len, min_len=3_000,
                           err=args.err)
    total_bases = sum(len(r) for _, r in reads)
    print(f"sim: genome={args.genome} reads={len(reads)} "
          f"bases={total_bases/1e6:.1f}Mb ({time.time()-t0:.1f}s)",
          file=sys.stderr)

    _ext.reset_launches()
    align_batch.reset_fill_stats()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_pipeline([("chr1", genome)], reads, LesvConfig(),
                       out_dir=args.out, resume=bool(args.out),
                       device=args.device)
    wall = time.time() - t0
    ev = evaluate(res.calls, truth)

    out = {
        "stats": res.stats,
        "timings": {k: round(v, 2) for k, v in res.timings.items()},
        "wall_s": round(wall, 1),
        "bases_per_sec": round(total_bases / wall),
        "peak_rss_gb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
        "eval": ev,
        "truth": [(s.kind, s.ref_pos, s.length) for s in truth.svs],
        "calls": [(c.kind, c.pos, c.length, c.support) for c in res.calls],
        "device": args.device,
        "card": card_line(args.device),
        "host_small": os.environ.get("LESV_TORCH_HOST_SMALL", "auto"),
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if on_card else None),
        "max_memory_reserved": (torch.cuda.max_memory_reserved()
                                if on_card else None),
        **kernel_report(),
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
