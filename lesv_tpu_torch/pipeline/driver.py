"""End-to-end pipeline driver (replaces `scripts/lesv.sh run cfg`).

Runs: subread split -> index -> map -> SV-read selection -> signatures ->
grouping -> group consensus -> remap -> native calling -> VCF, with
per-stage wall-clock timing (the reference's hbn_timing_begin/end) and
optional SAM/VCF artifacts.

Counterpart of :mod:`lesv_tpu.pipeline.driver`: the same stages, `.done`
markers and resume, on the torch ``device`` given to :func:`run_pipeline`.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np

from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.index.kmer_index import KmerIndex
from lesv_tpu_torch.io.sam import sam_header, sam_record
from lesv_tpu_torch.io.seqstore import SeqStore, split_subreads
from lesv_tpu_torch.io.vcf import VcfCall, write_vcf
from lesv_tpu_torch.ops.align_batch import set_num_threads
from lesv_tpu_torch.pipeline import stages_io as sio
from lesv_tpu_torch.pipeline.caller import call_svs
from lesv_tpu_torch.pipeline.cns import cns_groups
from lesv_tpu_torch.pipeline.grouping import group_signatures
from lesv_tpu_torch.pipeline.mapper import map_all, map_all_volumes
from lesv_tpu_torch.pipeline.remap import remap_all
from lesv_tpu_torch.pipeline.signatures import extract_signatures
from lesv_tpu_torch.pipeline.sv_reads import TrfMask, select_sv_reads
from lesv_tpu_torch.utils import profiling
from lesv_tpu_torch.utils.logging import log


@dataclass
class PipelineResult:
    calls: list[VcfCall]
    timings: dict[str, float] = field(default_factory=dict)
    stats: dict[str, int] = field(default_factory=dict)


def _with_device_trace(fn):
    """Wrap in the torch profiler when LESV_TORCH_PROFILE is set."""
    import functools

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with profiling.device_trace():
            return fn(*a, **kw)

    return wrapped


@_with_device_trace
def run_pipeline(
    ref_records,
    read_records,
    cfg: LesvConfig | None = None,
    trf_intervals: dict[int, list[tuple[int, int]]] | None = None,
    out_dir: str | None = None,
    resume: bool = False,
    device="cuda",
) -> PipelineResult:
    """Reads to calls on the torch ``device`` (a CUDA device unless the
    caller asks for the CPU)."""
    cfg = cfg or LesvConfig()
    if cfg.num_threads:
        set_num_threads(cfg.num_threads)   # -num_threads -> host pools
    timings: dict[str, float] = {}
    stats: dict[str, int] = {}
    ckpt = out_dir if (out_dir and resume) else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    @contextlib.contextmanager
    def timed(name):
        """A stage: its span ``stage/<name>`` (the parent of every span
        inside it) and its seconds in ``timings``."""
        t0 = time.time()
        try:
            with profiling.trace("stage/" + name):
                yield
        finally:
            timings[name] = time.time() - t0
            log(f"[{name}] {timings[name]:.2f}s")

    def stage(name, compute, save=None, load=None):
        """Run or resume one checkpointed stage (reference .done markers,
        `lesv.sh:103-113`)."""
        if ckpt and load and sio.is_done(ckpt, name):
            log(f"[{name}] already done, loading checkpoint")
            return load(os.path.join(ckpt, name + ".npz"))
        with timed(name):
            result = compute()
        if ckpt and save:
            save(os.path.join(ckpt, name + ".npz"), result)
            sio.mark_done(ckpt, name)
        return result

    with timed("build_ref"):
        sstore = SeqStore.from_records(ref_records)
        # single-volume references get their index once here; larger
        # references build one index per subject volume inside map
        # (out-of-core loop, `app/map/main.c:40-70`)
        multi_vol = sstore.total_res > cfg.map.max_subject_vol_res
        index = None if multi_vol else KmerIndex.build(sstore, cfg.index)
    trf = TrfMask(sstore, trf_intervals) if trf_intervals else None

    with timed("split"):
        reads = list(split_subreads(read_records, cfg.split))
    stats["reads"] = len(reads)
    qstore = SeqStore.from_records(reads)

    def _map():
        # per-batch checkpoints: a crash mid-map resumes after the last
        # completed batch (reference per-volume merge, app/map/main.c:43-58)
        parts = os.path.join(ckpt, "map_parts") if ckpt else None
        if index is None:
            m4s, _ = map_all_volumes(reads, sstore, cfg, ckpt_dir=parts,
                                     device=device)
        else:
            m4s, _ = map_all(reads, sstore, index, cfg, ckpt_dir=parts,
                             device=device)
        return m4s

    m4s = stage("map", _map, sio.save_m4s, sio.load_m4s)
    stats["m4s"] = len(m4s)

    svrs = stage("sv_reads",
                 lambda: select_sv_reads(m4s, qstore, sstore, cfg, trf,
                                         device=device),
                 sio.save_sv_reads, sio.load_sv_reads)
    stats["sv_reads"] = len(svrs)

    sigs = stage("signatures",
                 lambda: extract_signatures(svrs, qstore, sstore, cfg, trf,
                                            device=device),
                 sio.save_signatures, sio.load_signatures)
    stats["signatures"] = len(sigs)

    with timed("grouping"):
        groups = group_signatures(sigs, cfg)
    stats["groups"] = len(groups)

    def _cns():
        return cns_groups(groups, qstore, cfg, device=device)

    corrected = stage("consensus", _cns, sio.save_corrected, sio.load_corrected)
    stats["corrected_reads"] = len(corrected)

    remapped = stage("remap",
                     lambda: remap_all(corrected, sstore, cfg,
                                       device=device),
                     sio.save_remapped, sio.load_remapped)
    stats["remapped"] = len(remapped)

    with timed("call"):
        # true local depth: one span per mapped read (best M4)
        best_span: dict[int, tuple[int, int, int, int]] = {}
        for m in m4s:
            cur = best_span.get(m.qid)
            if cur is None or m.score > cur[0]:
                best_span[m.qid] = (m.score, m.sid, m.soff, m.send)
        raw_spans = [(sid, so, se)
                     for _, sid, so, se in best_span.values()]
        calls = call_svs(remapped, sstore, cfg, raw_spans=raw_spans)
    stats["calls"] = len(calls)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "remapped.sam"), "w") as fh:
            fh.write(sam_header(sstore))
            for r in remapped:
                fh.write(sam_record(
                    r.name, r.rev, sstore.name_of(r.subject_id), r.pos, 60,
                    r.ops, r.seq, f"rg{r.subject_id}",
                    tags={"gi": r.group_id}))
        write_vcf(os.path.join(out_dir, "calls.vcf"), calls, sstore)
        profiling.dump_json(os.path.join(out_dir, "profile.json"))

    return PipelineResult(calls=calls, timings=timings, stats=stats)
