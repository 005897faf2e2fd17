"""Warm-run span profile of the bench e2e workload, on lesv_tpu_torch.

The port's counterpart of ``tools/profile_e2e.py``: the same dataset
(``bench.py``'s e2e world: 300 kb, 3 DEL + 3 INS, coverage 8, mean read
8 kb, 10% error, generator seed 5) through ``run_pipeline`` on
``--device`` (default ``cuda``; ``cpu`` runs the plain versions)
``--runs`` times, then the profiling span table of the last run sorted
by total time.  Run 0 pays what a first call pays: on a card, the nvcc
build of the kernels (where ``build/kernels`` holds none yet) and the
native host library's build; lesv_tpu's run 0 warms its jit cache.  So
each run is reported on its own: ``runs`` in the JSON lists every run's
wall seconds, bases/s, stage timings, kernel launches and peak device
memory, and the rest of the JSON is the last run's, as lesv_tpu writes
it, with the card's ``nvidia-smi`` name and power limit.

Usage: python3 tools/torch_profile_e2e.py [--out build/profile_e2e.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "profile_e2e.json"))
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.config import LesvConfig
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.pipeline.driver import run_pipeline
    from lesv_tpu_torch.sim import plant_svs, random_genome, simulate_reads
    from lesv_tpu_torch.utils import profiling
    from torch_f1_eval import kernel_report
    from torch_genome_scale import card_line

    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("torch_profile_e2e: CUDA is not available "
                         "(--device cpu runs the plain versions)")
    rng = np.random.default_rng(5)
    genome = random_genome(rng, 300_000)
    donor, truth = plant_svs(rng, genome, n_del=3, n_ins=3, min_len=50,
                             max_len=2_000, margin=20_000, min_gap=30_000)
    reads = simulate_reads(rng, donor, coverage=8, mean_len=8_000,
                           min_len=3_000, err=0.1)
    total_bases = sum(len(r) for _, r in reads)
    cfg = LesvConfig()
    card = card_line(args.device)
    rep, runs = None, []
    for it in range(args.runs):
        profiling.reset()
        _ext.reset_launches()
        align_batch.reset_fill_stats()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = run_pipeline([("chr1", genome)], reads, cfg,
                           device=args.device)
        wall = time.time() - t0
        spans = profiling.report()
        rep = {
            "run": it,
            "wall_s": round(wall, 2),
            "bases_per_sec": round(total_bases / wall),
            "timings": {k: round(v, 2) for k, v in res.timings.items()},
            "spans": dict(sorted(
                spans.items(),
                key=lambda kv: -kv[1]["total_s"])),
        }
        runs.append(dict(
            run=it, wall_s=wall, bases_per_sec=total_bases / wall,
            timings=res.timings, calls=len(res.calls),
            max_memory_allocated=(torch.cuda.max_memory_allocated()
                                  if on_card else None),
            **kernel_report()))
        print(f"# run{it}: wall={wall:.1f}s "
              f"timings={rep['timings']}", file=sys.stderr)
    rep |= dict(device=args.device, card=card, reads=len(reads),
                read_bases=total_bases, runs=runs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rep, fh, indent=1)
    if card:
        print(card)
    for k, v in list(rep["spans"].items())[:25]:
        print(f"{k:40s} n={v['count']:5d} total={v['total_s']:8.2f}s")
    return rep


if __name__ == "__main__":
    main()
