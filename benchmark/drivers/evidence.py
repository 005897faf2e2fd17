"""The evidence path, lesv's stages 2 to 5 (qx2map, qx2m4x, qx2svr,
qx2svsig), timed chunk by chunk on the port's own entry points:
``mapper.map_all`` -> ``sv_reads.select_sv_reads`` ->
``signatures.extract_signatures``.

Cell keys: ``chunk_reads`` (raw reads a chunk), ``chunks`` (chunks made in
set-up, more than a window runs), ``warmup_reads``, ``flank`` (bases on
each side of an SV that make a read hold it whole).  The share of a
chunk's reads that cross an SV of their haplotype follows from the
configuration (:func:`sv_read_share`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import gen, reference
from benchmark.trace import annotate
from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.index.kmer_index import KmerIndex
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops.seeding_torch import device_index_of
from lesv_tpu_torch.pipeline.mapper import map_all
from lesv_tpu_torch.pipeline.signatures import extract_signatures
from lesv_tpu_torch.pipeline.sv_reads import select_sv_reads


class Subject:
    """The benchmark's own reference bases, by chromosome."""

    def __init__(self, genome: np.ndarray, starts: np.ndarray):
        self.genome, self.starts = genome, starts

    def __call__(self, sid: int, a: int, b: int) -> np.ndarray:
        return self.genome[self.starts[sid] + a: self.starts[sid] + b]

    def size(self, sid: int) -> int:
        return int(self.starts[sid + 1] - self.starts[sid])


@dataclass
class State:
    device: str
    cfg: LesvConfig
    subject: Subject
    truth: gen.Truth
    chunks: list
    limits: dict
    parts: dict = field(default_factory=dict)   # set-up seconds by step
    sstore: SeqStore | None = None
    index: KmerIndex | None = None
    # per chunk: (reads, (m4s, the mapper's identities), svrs, sigs)
    done: list = field(default_factory=list)


def costs(cfg: LesvConfig) -> dict:
    a = cfg.align
    return dict(match=a.match, mismatch=a.mismatch, gap_open1=a.gap_open1,
                gap_ext1=a.gap_ext1, gap_open2=a.gap_open2,
                gap_ext2=a.gap_ext2)


def make_world(config: dict, seed: int, device):
    """(genome, chromosome starts, chromosome sizes) of a configuration."""
    ref = config["reference"]
    sizes = [int(n) for _, n in ref["chromosomes"]]
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    genome = gen.genome(seed, int(starts[-1]), device)
    return genome, starts, sizes


def index_world(config: dict, genome, starts, sizes, cfg: LesvConfig):
    """The port's sequence store and k-mer index of the reference."""
    names = [n for n, _ in config["reference"]["chromosomes"]]
    sstore = SeqStore.from_records(
        (names[c], genome[starts[c]: starts[c + 1]])
        for c in range(len(sizes)))
    return sstore, KmerIndex.build(sstore, cfg.index)


def sv_read_share(config: dict) -> float:
    """Share of reads that cross an SV of their haplotype: the SVs per
    haplotype base (a het SV is on one of two, a hom SV on both) times the
    mean read length plus half the spectrum's mean length (the INS half
    lengthens the haplotype)."""
    sv, rd = config["svs"], config["reads"]
    total = sum(int(n) for _, n in config["reference"]["chromosomes"])
    haps = sv["het_frac"] + 2.0 * (1.0 - sv["het_frac"])
    per_base = sv["n"] * haps / 2.0 / total
    lo, hi = sv["min_len"], sv["max_len"]
    mean_sv = (hi - lo) / math.log(hi / lo)
    return per_base * (rd["mean_len"] + 0.5 * mean_sv)


def draw(config: dict, cell: dict, seed: int, tag: int, n: int, genome,
         starts, truth) -> list:
    rd = config["reads"]
    lengths = gen.lognormal_lengths(n, rd["mean_len"], rd["n50"],
                                    rd["min_len"])
    return gen.draw_reads(seed, tag, genome, starts, truth, lengths,
                          rd["error"], rd["max_subseq_size"],
                          rd["min_last_subseq_size"], cell["flank"],
                          sv_reads=round(n * sv_read_share(config)))


def setup(cell: dict, config: dict, seed: int, devices: list) -> State:
    device = devices[0] if len(devices) == 1 else "cuda"
    t = [time.perf_counter()]
    genome, starts, sizes = make_world(config, seed, devices[0])
    t.append(time.perf_counter())
    sv = config["svs"]
    truth = gen.plant_spectrum(seed, sizes, sv["n"], sv["min_len"],
                               sv["max_len"], sv["het_frac"],
                               sv["cluster_frac"], sv["margin"],
                               sv["min_gap"])
    chunks = [draw(config, cell, seed, k, cell["chunk_reads"], genome,
                   starts, truth) for k in range(cell["chunks"])]
    warm = draw(config, cell, seed, 1000, cell["warmup_reads"], genome,
                starts, truth)
    t.append(time.perf_counter())
    cfg = LesvConfig()
    st = State(device, cfg, Subject(genome, starts), truth, chunks,
               cell["limits"])
    st.sstore, st.index = index_world(config, genome, starts, sizes, cfg)
    t.append(time.perf_counter())
    if cfg.map.engine == "device":
        device_index_of(st.index, device)
    t.append(time.perf_counter())
    run_chunk(st, warm)
    t.append(time.perf_counter())
    st.parts = dict(zip(("genome", "reads", "store_and_index", "upload",
                         "warmup"), np.diff(t).tolist()))
    return st


def run_chunk(st: State, reads: list):
    recs = [(f"r{i}", r.codes) for i, r in enumerate(reads)]
    with annotate("map_all"):
        m4s, qstore = map_all(recs, st.sstore, st.index, st.cfg,
                              device=st.device)
    t_map = time.perf_counter()
    # select_sv_reads rewrites ident_perc of the records it keeps with their
    # effective identity: the check reads the mapper's own
    ident = [m.ident_perc for m in m4s]
    with annotate("select_sv_reads"):
        svrs = select_sv_reads(m4s, qstore, st.sstore, st.cfg, None,
                               device=st.device)
    with annotate("extract_signatures"):
        sigs = extract_signatures(svrs, qstore, st.sstore, st.cfg, None,
                                  device=st.device)
    return (m4s, ident), svrs, sigs, t_map


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(st: State, seconds: float, ctx: dict) -> None:
    """Whole chunks until ``seconds`` have passed; every chunk counts, over
    all the time it took."""
    elapsed = map_s = 0.0
    bases = 0
    for reads in st.chunks:
        _sync(st.device)
        t0 = time.perf_counter()
        m4s, svrs, sigs, t_map = run_chunk(st, reads)
        _sync(st.device)
        t1 = time.perf_counter()
        st.done.append((reads, m4s, svrs, sigs))
        elapsed += t1 - t0
        map_s += t_map - t0
        bases += sum(len(r.codes) for r in reads)
        if elapsed >= seconds:
            break
    ctx.update(evidence_bases=bases, window_s=elapsed, map_s=map_s,
               svsig_s=elapsed - map_s, chunks=len(st.done),
               attempted=sum(len(d[0]) for d in st.done))


def release(st: State) -> None:
    from lesv_tpu_torch.ops.seeding_torch import release_device_index

    if st.index is not None:
        release_device_index(st.index)
    st.index = st.sstore = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(st: State) -> dict:
    """The numbers ``correct`` compares, over every chunk of the window."""
    c = costs(st.cfg)
    n_reads = bad = widest = mis = held = missed = n_sigs = off = 0
    bad_reads = 0
    for reads, (m4s, ident), _, sigs in st.done:
        codes = [r.codes for r in reads]
        b, w, qids = reference.check_m4s(m4s, ident, codes, st.subject, c)
        bad += b
        bad_reads += len(qids)
        widest = max(widest, w)
        mis += reference.misplaced(m4s, reads)
        h, m = reference.sv_missed(sigs, reads, st.truth)
        held += h
        missed += m
        n_sigs += len(sigs)
        off += reference.sigs_off_truth(sigs, st.truth)
        n_reads += len(reads)
    return dict(m4_bad=bad, score_gap=widest,
                misplaced=mis / max(1, n_reads),
                sv_missed=missed / max(1, held),
                _sig_off=off / max(1, n_sigs),
                _bad_reads=bad_reads, _held=held, _sigs=n_sigs)


def check(st: State, ctx: dict) -> dict:
    r = readings(st)
    ctx["failed"] = r["_bad_reads"]
    ctx["info"] = dict(sv_reads_held=r["_held"], signatures=r["_sigs"],
                       signatures_off_truth=r["_sig_off"],
                       chunks=ctx["chunks"], bases=ctx["evidence_bases"],
                       window_s=ctx["window_s"], map_s=ctx["map_s"],
                       setup_parts=st.parts)
    return {k: dict(value=v, limit=st.limits[k])
            for k, v in r.items() if not k.startswith("_")}
