"""Tiny configurations and cells of the benchmark's drivers, sized for the
port's plain path on the CPU."""

from __future__ import annotations

import time

EVIDENCE_CONFIG = {
    "reference": {"chromosomes": [["c1", 200000], ["c2", 150000]]},
    "reads": {"mean_len": 6000, "n50": 9000, "min_len": 1000, "error": 0.1,
              "max_subseq_size": 50000, "min_last_subseq_size": 20000},
    "svs": {"n": 14, "min_len": 60, "max_len": 3000, "het_frac": 0.5,
            "cluster_frac": 0.1, "margin": 10000, "min_gap": 8000},
}
EVIDENCE_CELL = {
    "config": "tiny", "driver": "evidence", "chips": 1, "chunk_reads": 14,
    "chunks": 1, "warmup_reads": 1, "flank": 1000,
    "limits": {"m4_bad": 0, "score_gap": 1000, "misplaced": 0.05,
               "sv_missed": 0.5},
}
# reads long enough that a record's score passes int16
LONG_CONFIG = dict(EVIDENCE_CONFIG, reads=dict(EVIDENCE_CONFIG["reads"],
                                               mean_len=36000, n50=38000,
                                               min_len=34000))
LONG_CELL = dict(EVIDENCE_CELL, chunk_reads=2)

CNS_CONFIG = {
    "reference": {"chromosomes": [["c21", 120000]]},
    "reads": {"mean_len": 4500, "n50": 6000, "min_len": 1000, "error": 0.1,
              "max_subseq_size": 50000, "min_last_subseq_size": 20000},
    "svs": {"min_len": 300, "max_len": 3000},
}
CNS_CELL = {
    "config": "tiny", "driver": "cns", "chips": 1, "loci": 2,
    "region": 12000, "reads_per_locus": 40, "flank": 1000,
    "limits": {"cns_bad": 0, "kmer_miss": 0.3, "loci_missed": 0,
               "loci_ungrouped": 0, "groups_off": 0},
}
MANIFEST = {"end_to_end": [], "per_layer": []}


def run(cell: dict, config: dict, seed: int, seconds: float = 0.1) -> dict:
    """One run of a tiny cell on the CPU, past the harness' look for a
    card."""
    from benchmark import harness

    return harness.run("tiny", seed, seconds, False, time.perf_counter(),
                       ["cpu"], cell=cell, config=config, man=MANIFEST)
