"""``run`` of lesv_tpu_torch on one CUDA card with the chain outputs of
read and pair chaining fetched sliced (the default) or in full, in turns.

    python3 tools/torch_paths_ab.py [--genome 8000000] [--svs 10]
        [--coverage 10] [--turns 2]

The world is the size of ``chip_smoke.py``'s phase run: a simulated
reference of ``--genome`` bases with ``--svs`` DEL and ``--svs`` INS
planted, reads at ``--coverage`` (mean 12 kb, 10% error), from a generator
of its own (seed 0).  Two arms run ``run_pipeline`` at the defaults but
one thing:
- S: the defaults (``chain_torch.chain_lanes_sliced``: the chain at the
  live slots, then one sliced, narrowed readback; v and valid rebuilt on
  the host);
- A: ``chip_smoke.full_fetch`` (the same chain, its six outputs fetched at
  full width, as before the sliced fetch).
Each turn runs both, the order reversed on every other turn (S, A, A, S),
each into a directory of its own under ``build/paths_ab``.  Every arm must
write the ``calls.vcf``, ``remapped.sam`` and stage ``.npz`` files of the
first; each prints one JSON line (wall and per-stage seconds, bases/s,
launches per kernel, peak device memory), and the last line is the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome", type=int, default=8_000_000)
    ap.add_argument("--svs", type=int, default=10)
    ap.add_argument("--coverage", type=float, default=10.0)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_paths_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.config import LesvConfig
    from lesv_tpu_torch.pipeline import driver
    from lesv_tpu_torch.sim import plant_svs, random_genome, simulate_reads

    rng = np.random.default_rng(0)
    genome = random_genome(rng, args.genome)
    donor, _ = plant_svs(rng, genome, n_del=args.svs, n_ins=args.svs)
    reads = simulate_reads(rng, donor, coverage=args.coverage,
                           mean_len=12_000, err=0.1)
    ref = [("chrSim", genome)]
    cfg = LesvConfig()
    bases = sum(len(r) for _, r in reads)
    work = os.path.join(REPO, "build", "paths_ab")
    shutil.rmtree(work, ignore_errors=True)
    _ext.build()

    def arm_context(arm: str):
        return cs.full_fetch() if arm == "A" else contextlib.nullcontext()

    def run(arm: str, turn: int):
        out_dir = os.path.join(work, f"{arm}_{turn}")
        _ext.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with arm_context(arm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = driver.run_pipeline(ref, reads, cfg, out_dir=out_dir,
                                      resume=True, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return out_dir, dict(
            arm=arm, turn=turn, reads=len(reads), read_bases=bases,
            wall_s=wall, bases_per_s=bases / wall, stage_s=res.timings,
            calls=len(res.calls), launches=dict(_ext.LAUNCHES),
            peak_device_bytes=torch.cuda.max_memory_allocated())

    first = None
    for turn in range(args.turns):
        arms = ("S", "A") if turn % 2 == 0 else ("A", "S")
        for arm in arms:
            out_dir, row = run(arm, turn)
            if first is None:
                first = out_dir
            differ = [n for n in ("calls.vcf", "remapped.sam")
                      if cs._read(first, n) != cs._read(out_dir, n)]
            differ += [n for n in cs.STAGE_FILES if not cs._npz_equal(
                os.path.join(first, n), os.path.join(out_dir, n))]
            print(json.dumps(dict(row, differ_from_first=differ)),
                  flush=True)
            if differ:
                raise AssertionError(f"arm {arm} differs from the first in "
                                     f"{differ}")
            if out_dir != first:
                shutil.rmtree(out_dir)
    shutil.rmtree(work, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
