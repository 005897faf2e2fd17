"""Group consensus (lesv's qx2csvrg), timed on the port's
``cns.cns_groups``.

Set-up plants ``loci`` SVs that stand for the configuration's spectrum
(:func:`benchmark.gen.spectrum_loci`) at positions from the seed, draws
``reads_per_locus`` reads from a stretch of ``region`` bases around each
(lengths from the configuration's fit, clipped to the stretch, at the
same places and haplotypes around the locus for every seed), and takes
them through the port's ``map_all``, ``select_sv_reads``,
``extract_signatures`` and ``group_signatures``.  The window calls
``cns_groups`` once over every group of the sample, as the pipeline does,
and again while ``--seconds`` have not passed; the checks judge every
call's output.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import gen, reference
from benchmark.drivers.evidence import _sync, index_world, make_world
from benchmark.trace import annotate
from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.pipeline.cns import cns_groups
from lesv_tpu_torch.pipeline.grouping import group_signatures
from lesv_tpu_torch.pipeline.mapper import map_all
from lesv_tpu_torch.pipeline.signatures import extract_signatures
from lesv_tpu_torch.pipeline.sv_reads import select_sv_reads

KMER_QUANTILE = 0.9


@dataclass
class State:
    device: str
    cfg: LesvConfig
    genome: np.ndarray
    truth: gen.Truth
    reads: list
    limits: dict
    region: int
    seed: int
    qstore: object = None
    groups: list = field(default_factory=list)
    locus_of: dict = field(default_factory=dict)   # group_id -> locus
    bases: int = 0          # bases of the reads the groups hold
    outs: list = field(default_factory=list)       # each call's output
    call_s: list = field(default_factory=list)     # each call's seconds


def _locus(truth: gen.Truth, group) -> gen.SV:
    mid = statistics.median(s.sfrom for s in group.sigs)
    return min(truth.svs, key=lambda sv: abs(sv.pos - mid))


def setup(cell: dict, config: dict, seed: int, devices: list) -> State:
    device = devices[0]
    genome, starts, sizes = make_world(config, seed, device)
    region = cell["region"]
    sv = config["svs"]
    loci = gen.spectrum_loci(cell["loci"], sv["min_len"], sv["max_len"])
    truth = gen.plant_loci(seed, sizes[0], loci, 2 * region, region)
    rd = config["reads"]
    lengths = gen.lognormal_lengths(cell["reads_per_locus"], rd["mean_len"],
                                    rd["n50"], rd["min_len"], region)
    reads = []
    for locus in sorted(truth.svs, key=lambda s: s.ins_tag):
        span = locus.length if locus.kind == "DEL" else 0
        lo = locus.pos - region // 2
        reads += gen.draw_reads(seed, 100 + locus.ins_tag, genome, starts,
                                truth, lengths, rd["error"],
                                rd["max_subseq_size"],
                                rd["min_last_subseq_size"], cell["flank"],
                                region=(0, lo, lo + region + span),
                                hap0=locus.haps[0])
    cfg = LesvConfig()
    st = State(device, cfg, genome, truth, reads, cell["limits"], region,
               seed)
    sstore, index = index_world(config, genome, starts, sizes, cfg)
    recs = [(f"r{i}", r.codes) for i, r in enumerate(reads)]
    m4s, st.qstore = map_all(recs, sstore, index, cfg, device=device)
    svrs = select_sv_reads(m4s, st.qstore, sstore, cfg, None, device=device)
    sigs = extract_signatures(svrs, st.qstore, sstore, cfg, None,
                              device=device)
    st.groups = group_signatures(sigs, cfg)
    from lesv_tpu_torch.ops.seeding_torch import release_device_index

    release_device_index(index)
    del index, sstore
    st.locus_of = {g.group_id: _locus(truth, g) for g in st.groups}
    qids = {s.qid for g in st.groups for s in g.sigs}
    st.bases = sum(len(reads[q].codes) for q in qids)
    # set-up's map, selection and signatures have built every kernel (a
    # kernel builds once for all shapes); one call over the smallest group
    # loads what consensus alone uses before the window
    if st.groups:
        small = min(st.groups, key=lambda g: len(g.sigs))
        cns_groups([small], st.qstore, cfg, device=device)
    _sync(device)
    return st


def window(st: State, seconds: float, ctx: dict) -> None:
    """Calls over every group until ``seconds`` have passed; every call
    counts whole."""
    elapsed = 0.0
    while elapsed < seconds:
        _sync(st.device)
        t0 = time.perf_counter()
        with annotate("cns_groups"):
            out = cns_groups(st.groups, st.qstore, st.cfg, device=st.device)
        _sync(st.device)
        st.call_s.append(time.perf_counter() - t0)
        elapsed += st.call_s[-1]
        st.outs.append(out)
    n = len(st.outs)
    ctx.update(cns_bases=st.bases * n, window_s=elapsed, calls=n,
               attempted=len(st.groups) * n)


def release(st: State) -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def donor(st: State, sv: gen.SV) -> list[np.ndarray]:
    """Both haplotypes over the locus' stretch and a region either side."""
    sv_ids = {id(s): k for k, s in enumerate(st.truth.svs)}
    size = len(st.genome)
    lo = max(0, sv.pos - st.region)
    need = 2 * st.region + sv.length
    return [gen.hap_stretch(st.genome, size, st.truth, 0, h, lo, need,
                            st.seed, sv_ids)[0] for h in (0, 1)]


def readings(st: State) -> dict:
    codes = [r.codes for r in st.reads]
    grouped = {st.locus_of[g.group_id].ins_tag for g in st.groups}
    off = sum(1 for g in st.groups
              if reference.sigs_off_truth(g.sigs, st.truth) * 2
              > len(g.sigs))
    bad = missed = 0
    miss = []
    cache: dict = {}
    for out in st.outs:
        bad += reference.check_corrected(out, st.groups, codes,
                                         st.cfg.cns.min_size)
        with_cns = set()
        for r in out:
            sv = st.locus_of.get(r.group_id)
            if sv is None:
                miss.append(1.0)
                continue
            with_cns.add(sv.ins_tag)
            if sv.ins_tag not in cache:
                cache[sv.ins_tag] = donor(st, sv)
            miss.append(reference.kmer_miss(r.seq[r.cns_from: r.cns_to],
                                            cache[sv.ins_tag]))
        missed += len(grouped - with_cns)
    return dict(cns_bad=bad,
                kmer_miss=float(np.quantile(miss, KMER_QUANTILE))
                if miss else 1.0,
                loci_missed=missed,
                loci_ungrouped=len(st.truth.svs) - len(grouped),
                groups_off=off,
                _n=len(miss), _kmer_median=float(np.median(miss))
                if miss else 1.0, _kmer_max=max(miss, default=1.0))


def check(st: State, ctx: dict) -> dict:
    r = readings(st)
    ctx["failed"] = r["cns_bad"]
    ctx["info"] = dict(corrected=r["_n"], calls=len(st.outs),
                       call_s=st.call_s,
                       group_sigs=[len(g.sigs) for g in st.groups],
                       groups=len(st.groups),
                       loci=[(sv.kind, sv.length, sv.genotype)
                             for sv in st.truth.svs],
                       kmer_miss_median=r["_kmer_median"],
                       kmer_miss_max=r["_kmer_max"],
                       call_bases=st.bases, bases=ctx["cns_bases"],
                       window_s=ctx["window_s"])
    return {k: dict(value=v, limit=st.limits[k])
            for k, v in r.items() if not k.startswith("_")}
