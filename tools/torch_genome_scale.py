"""Genome-scale map of lesv_tpu_torch: a simulated human-sized reference
through the subject-volume loop on one card.

    python3 tools/torch_genome_scale.py --gbases 3.0 --chroms 24 \\
        --vol-res 1000000000 --reads 400 --out build/gscale

The port's counterpart of ``tools/genome_scale.py``, with its flags and
its world: ``--chroms`` random chromosomes of ``--gbases`` billion bases
in all (generator seed 0), written to the on-disk 2-bit store under
``<out>/store`` and reopened memory-mapped; ``--reads`` fragments of
``--read-len`` bases at ``--err`` error, each named ``r{i}_s{sid}_{a}``
after its chromosome and start; then ``map_all_volumes`` over subject
volumes of at most ``--vol-res`` bases on ``--device`` (default
``cuda``; ``cpu`` runs the plain versions), checkpointed per (volume,
batch) under ``<out>/parts``.  A second call on the same ``--out`` reuses
the store (and the generator state saved beside it, so the reads are the
same) and resumes from the parts that exist; ``parts_mapped`` lists the
parts it wrote and ``m4_digest`` lets two calls' M4 sets be compared.

Prints one JSON object (also written to ``<out>/genome_scale.json``):
``tools/genome_scale.py``'s fields (``sim_s``, ``rss_after_sim_gb``,
``volumes``, ``map_s``, ``m4s``, ``reads_mapped``, ``reads_total``,
``m4s_on_source_chrom``, ``peak_rss_gb``), and ``per_volume`` (index
build, upload and map seconds, the device index's bytes, the volume's
kernel launches, device bytes still allocated after it), ``launches``
per kernel, peak device
memory allocated and reserved, the card's ``nvidia-smi`` name and power
limit, the routing switch ``LESV_TORCH_HOST_SMALL`` (``auto`` where unset:
small fills go to the host engine on a card; ``0`` keeps them on the
card), and ``best_on_source``: reads whose best-scoring M4 lies on the
source chromosome and overlaps the source interval ``[a, a + len)``.
Exits 1 when a read is unmapped or its best M4 is off its source
interval.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def rss_gb() -> float:
    """Peak resident set of this process so far, GB (Linux: KiB units)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def m4_key(m) -> tuple:
    return (m.qid, m.qdir, m.sid, m.qoff, m.qend, m.soff, m.send, m.score)


def m4_digest(m4s) -> str:
    """SHA-256 of the M4 set: sorted keys and op strings."""
    h = hashlib.sha256()
    for m in sorted(m4s, key=lambda m: (m4_key(m), m.ops.tobytes())):
        h.update(repr(m4_key(m)).encode())
        h.update(m.ops.tobytes())
    return h.hexdigest()


def card_line(device: str) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, None on the
    CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def simulate_store(store_dir: str, gbases: float, chroms: int, rng):
    """Write ``chroms`` random chromosomes of ``gbases`` billion bases in
    all to ``store_dir`` (where no store is yet), and the generator's
    state after them beside it; then set ``rng`` to that state."""
    from lesv_tpu_torch.io.seqstore import SeqStore

    state_path = os.path.join(store_dir, "rng_state.json")
    if not os.path.exists(state_path):
        per_chrom = int(gbases * 1e9) // chroms
        recs = [(f"chr{c + 1}", rng.integers(0, 4, per_chrom, dtype=np.uint8))
                for c in range(chroms)]
        store = SeqStore.from_records(recs)
        store.write(store_dir)
        del store, recs
        with open(state_path, "w") as fh:
            json.dump(rng.bit_generator.state, fh)
    with open(state_path) as fh:
        rng.bit_generator.state = json.load(fh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gbases", type=float, default=3.0)
    ap.add_argument("--chroms", type=int, default=24)
    ap.add_argument("--vol-res", type=int, default=1_000_000_000)
    ap.add_argument("--reads", type=int, default=400)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--err", type=float, default=0.08)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "gscale"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from lesv_tpu_torch import _ext, native
    from lesv_tpu_torch.config import LesvConfig
    from lesv_tpu_torch.io.seqstore import SeqStore
    from lesv_tpu_torch.pipeline.mapper import map_all_volumes, subject_volumes
    from lesv_tpu_torch.sim import mutate_read

    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch_genome_scale: CUDA is not available", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    store_dir = os.path.join(args.out, "store")
    parts_dir = os.path.join(args.out, "parts")
    rng = np.random.default_rng(0)
    report: dict = {"gbases": args.gbases, "chroms": args.chroms,
                    "vol_res": args.vol_res, "device": args.device,
                    "card": card_line(args.device),
                    "host_small": os.environ.get("LESV_TORCH_HOST_SMALL",
                                                 "auto")}
    # the kernels, the host library and the card's context before any
    # clock starts
    t0 = time.time()
    if on_card:
        _ext.build()
        torch.zeros(1, device=args.device)
    native._load()
    report["build_s"] = time.time() - t0

    t0 = time.time()
    simulate_store(store_dir, args.gbases, args.chroms, rng)
    report["sim_s"] = time.time() - t0
    report["rss_after_sim_gb"] = rss_gb()

    store = SeqStore.open(store_dir, mmap=True)
    cfg = LesvConfig()
    cfg.map.max_subject_vol_res = args.vol_res
    report["volumes"] = len(subject_volumes(store, args.vol_res))

    reads, src = [], []
    for i in range(args.reads):
        sid = int(rng.integers(0, store.num_seqs))
        ssz = store.seq_size(sid)
        a = int(rng.integers(0, max(1, ssz - args.read_len)))
        frag = store.get(sid, a, min(a + args.read_len, ssz))
        reads.append((f"r{i}_s{sid}_{a}", mutate_read(rng, frag, args.err)))
        src.append((sid, a, a + len(frag)))

    parts_before = (set(os.listdir(parts_dir)) if os.path.isdir(parts_dir)
                    else set())
    _ext.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    per_volume: list = []
    t0 = time.time()
    m4s, _ = map_all_volumes(reads, store, cfg, ckpt_dir=parts_dir,
                             device=args.device, volume_stats=per_volume)
    report["map_s"] = time.time() - t0
    report["m4s"] = len(m4s)
    report["reads_mapped"] = len({m.qid for m in m4s})
    report["reads_total"] = len(reads)
    report["m4s_on_source_chrom"] = sum(m.sid == src[m.qid][0] for m in m4s)
    best: dict = {}
    for m in m4s:
        if m.qid not in best or m.score > best[m.qid].score:
            best[m.qid] = m
    on_source = [q for q, m in best.items()
                 if m.sid == src[q][0] and m.soff < src[q][2]
                 and m.send > src[q][1]]
    report["best_on_source"] = len(on_source)
    report["peak_rss_gb"] = rss_gb()
    report["per_volume"] = per_volume
    report["launches"] = dict(_ext.LAUNCHES)
    report["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                      if on_card else None)
    report["max_memory_reserved"] = (torch.cuda.max_memory_reserved()
                                     if on_card else None)
    report["parts_mapped"] = sorted(set(os.listdir(parts_dir))
                                    - parts_before)
    report["m4_digest"] = m4_digest(m4s)
    off = sorted(set(range(len(reads))) - set(on_source))
    report["reads_off_source"] = [reads[q][0] for q in off][:20]
    with open(os.path.join(args.out, "genome_scale.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report, indent=2))
    return 1 if off else 0


if __name__ == "__main__":
    sys.exit(main())
