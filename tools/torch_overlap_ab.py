"""The map stage of lesv_tpu_torch on one CUDA card at several worker
counts, in turns.

    python3 tools/torch_overlap_ab.py [--reads 2048] [--turns 2]
        [--arms 1x1,8x2,4x2,2x2,8x1]

An arm ``DxM`` maps with ``D`` dispatch workers (``align_pairs`` and
``batch_pair_chains``) and ``M`` map batches in flight (``map_all``);
``1x1`` is the serial arm, ``8x2`` the default on a card.  The world is the
one of ``chip_smoke.py``'s phase overlap: a 64 Mb simulated reference with
20 DEL and 20 INS planted, its k-mer index, and ``--reads`` reads (mean 12
kb, 10% error; 2,048 are four production batches).  Each turn runs every
arm once, the order reversed on every other turn (A, B, B, A).  Every arm
must give the M4 records, launches per kernel and fill launches per shape
of the first; each prints one JSON line (wall seconds, bases/s, peak
device memory), and the last line is the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=2_048)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--arms", default="1x1,8x2,4x2,2x2,8x1")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_overlap_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.config import LesvConfig
    from lesv_tpu_torch.index.kmer_index import KmerIndex
    from lesv_tpu_torch.io.seqstore import SeqStore
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.pipeline import mapper
    from lesv_tpu_torch.sim import plant_svs, random_genome, simulate_reads

    arms = [tuple(int(x) for x in a.split("x")) for a in args.arms.split(",")]
    rng = np.random.default_rng(0)
    genome = random_genome(rng, 64_000_000)
    donor, _ = plant_svs(rng, genome, n_del=20, n_ins=20)
    reads = simulate_reads(np.random.default_rng(7), donor, coverage=0.45,
                           mean_len=12_000, err=0.1)[: args.reads]
    store = SeqStore.from_records([("chrSim", genome)])
    cfg = LesvConfig()
    index = KmerIndex.build(store, cfg.index)
    bases = sum(len(r) for _, r in reads)
    _ext.build()
    defaults = align_batch._n_dispatch_workers, mapper._map_overlap_depth

    def run(D: int, M: int):
        align_batch._n_dispatch_workers = lambda device: D
        mapper._map_overlap_depth = lambda device: M
        try:
            _ext.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m4s, _ = mapper.map_all(reads, store, index, cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            align_batch._n_dispatch_workers, mapper._map_overlap_depth = \
                defaults
        key = [(m.qid, m.qdir, m.sid, m.qoff, m.qend, m.soff, m.send,
                m.score, m.dist, m.ops.tobytes()) for m in m4s]
        return wall, key, (dict(_ext.LAUNCHES), dict(_ext.FILL_SHAPES))

    run(*arms[0])                      # warm-up: builds, caches, clocks
    first = None
    for turn in range(args.turns):
        for D, M in (arms if turn % 2 == 0 else arms[::-1]):
            wall, key, counts = run(D, M)
            if first is None:
                first = (key, counts)
            same = key == first[0] and counts == first[1]
            print(json.dumps(dict(
                arm=f"{D}x{M}", turn=turn, reads=len(reads),
                read_bases=bases, wall_s=wall, bases_per_s=bases / wall,
                peak_device_bytes=torch.cuda.max_memory_allocated(),
                equal_to_first=same)), flush=True)
            if not same:
                raise AssertionError(f"arm {D}x{M} differs from the first")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
