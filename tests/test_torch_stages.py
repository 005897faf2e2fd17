"""The port's ``run`` pipeline, stage by stage, against lesv_tpu's.

One module fixture builds a 60 kb world with one planted DEL and one
planted INS, runs ``lesv_tpu.pipeline.driver.run_pipeline`` once and the
port's ``run_pipeline(device="cpu")`` once, each into its own ``out_dir``
with checkpoints.  The first group of tests holds every stage's records
equal field by field, ``remapped.sam`` and ``calls.vcf`` byte-identical,
and a resumed run equal to the first.  The second group feeds each port
stage the JAX package's checkpoint of the stage before it, read through
the port's ``stages_io.load_*``, so that a divergence names its stage.

No tolerance: every field is an integer, a string or an op/sequence
array compared exactly; floats (identity percentages) come from the same
host arithmetic and are compared after ``round(x, 9)``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lesv_tpu.config import LesvConfig as JaxConfig
from lesv_tpu.pipeline import driver as jax_driver
from lesv_tpu.pipeline import grouping as jax_grouping
from lesv_tpu.pipeline import stages_io as jax_sio
from lesv_tpu.sim import plant_svs, random_genome, simulate_reads
from lesv_tpu_torch import convert
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops import align_batch
from lesv_tpu_torch.pipeline import caller, cns, driver, grouping, remap
from lesv_tpu_torch.pipeline import signatures, sv_reads
from lesv_tpu_torch.pipeline import stages_io as sio
from lesv_tpu_torch.utils import profiling

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)

STAGES = {          # checkpoint name -> (lesv_tpu loader, port loader)
    "map": (jax_sio.load_m4s, sio.load_m4s),
    "sv_reads": (jax_sio.load_sv_reads, sio.load_sv_reads),
    "signatures": (jax_sio.load_signatures, sio.load_signatures),
    "consensus": (jax_sio.load_corrected, sio.load_corrected),
    "remap": (jax_sio.load_remapped, sio.load_remapped),
}


def _plain(v):
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.tolist())
    if isinstance(v, (float, np.floating)):
        return round(float(v), 9)
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if dataclasses.is_dataclass(v):
        return _fields(v)
    return v


def _fields(rec) -> dict:
    """A record of either package as plain data (no class identity)."""
    return {f.name: _plain(getattr(rec, f.name))
            for f in dataclasses.fields(rec)}


def assert_same_records(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _fields(g) == _fields(w), f"record {i}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(6)
    genome = random_genome(rng, 60_000)
    donor, truth = plant_svs(rng, genome, n_del=1, n_ins=1, min_len=80,
                             max_len=400, margin=15_000, min_gap=15_000)
    # short reads keep the row loops of the plain fills short; coverage 8
    # is what both SVs need to be called at this read length
    reads = simulate_reads(rng, donor, coverage=8.0, mean_len=3_000,
                           min_len=2_000, err=0.08)
    ref = [("chr1", genome)]
    jcfg = JaxConfig()
    jcfg.cns.min_size = 1_000       # short synthetic reads
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    root = tmp_path_factory.mktemp("stages")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    jres = jax_driver.run_pipeline(ref, reads, jcfg, out_dir=jdir,
                                   resume=True)
    # profile.json and the counters then hold this one run
    profiling.reset()
    align_batch.reset_fill_stats()
    tres = driver.run_pipeline(ref, reads, cfg, out_dir=tdir, resume=True,
                               device="cpu")
    with open(os.path.join(tdir, "profile.json")) as fh:
        prof = json.load(fh)
    return dict(profile=prof, ref=ref, reads=reads, truth=truth, jcfg=jcfg, cfg=cfg,
                jdir=jdir, tdir=tdir, jres=jres, tres=tres,
                fill_stats=dict(align_batch.FILL_STATS),
                sstore=SeqStore.from_records(ref),
                qstore=SeqStore.from_records(reads))


def _load(world, stage, which):
    jload, tload = STAGES[stage]
    if which == "jax":
        return jload(os.path.join(world["jdir"], stage + ".npz"))
    return tload(os.path.join(world["tdir"], stage + ".npz"))


# -- group 1: the two whole runs, stage by stage ---------------------------

@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_records_equal(world, stage):
    want = _load(world, stage, "jax")
    got = _load(world, stage, "torch")
    assert len(want) > 0
    assert_same_records(got, want)
    assert world["tres"].stats == world["jres"].stats


def test_grouping_equal(world):
    want = jax_grouping.group_signatures(_load(world, "signatures", "jax"),
                                         world["jcfg"])
    got = grouping.group_signatures(_load(world, "signatures", "torch"),
                                    world["cfg"])
    assert len(want) == 2
    assert_same_records(got, want)


def test_calls_and_files_identical(world):
    """Both planted SVs are called, and the SAM and VCF files are
    byte-identical."""
    assert_same_records(world["tres"].calls, world["jres"].calls)
    for sv in world["truth"].svs:
        assert [c for c in world["tres"].calls
                if c.kind == sv.kind and abs(c.pos - sv.ref_pos) <= 50
                and abs(c.length - sv.length) <= 0.1 * sv.length], sv
    for name in ("remapped.sam", "calls.vcf"):
        with open(os.path.join(world["tdir"], name), "rb") as fh:
            got = fh.read()
        with open(os.path.join(world["jdir"], name), "rb") as fh:
            assert got == fh.read(), name
        assert len(got) > 0
    assert os.path.exists(os.path.join(world["tdir"], "profile.json"))


# every stage's span holds the spans of its stage on the caller thread;
# (parent, children) pairs of profile.json
NESTED = [
    ("stage/sv_reads", ["svr/select"]),
    ("svr/select", ["svr/realign"]),
    ("stage/signatures", ["svsig/extract"]),
    ("svsig/extract", ["svsig/align", "svsig/repair"]),
    ("stage/consensus", ["cns/overlap_cands", "cns/mem_anchors",
                         "cns/align_wave", "cns/admission", "cns/finish"]),
]


def test_profile_json_nests_stage_spans(world):
    """``profile.json`` of the run: every stage a span, each new span of
    SV-read selection, signatures and consensus inside its parent (child
    totals at most the parent's, self time at most the total), and the
    whole-span NW's counters consistent."""
    prof = world["profile"]
    for name in ("build_ref", "split", "map", "sv_reads", "signatures",
                 "grouping", "consensus", "remap", "call"):
        assert prof["stage/" + name]["count"] == 1, name
    for name in ("svr/select", "svsig/extract", "svsig/align",
                 "svsig/repair", "cns/overlap_cands", "cns/finish"):
        assert prof[name]["count"] >= 1, name
    assert prof["cns/overlap_cands"]["count"] == 2      # one a round
    slack = 2e-4                # report() rounds to 1e-4
    for parent, kids in NESTED:
        got = [prof[k]["total_s"] for k in kids if k in prof]
        assert sum(got) <= prof[parent]["total_s"] + slack, parent
    for name, v in prof.items():
        assert set(v) == {"count", "total_s", "mean_s", "self_s"}
        assert 0 <= v["self_s"] <= v["total_s"] + slack, name
    st = world["fill_stats"]
    assert 0 <= st["fallback_kept"] <= st["fallback_fills"]
    assert (st["fallback_cells"] > 0) == (st["fallback_fills"] > 0)


def test_resume_from_port_checkpoints(world, monkeypatch):
    """A second run over the port's out_dir loads every stage from its
    checkpoint (no stage computes) and writes the same VCF."""
    with open(os.path.join(world["tdir"], "calls.vcf"), "rb") as fh:
        first = fh.read()

    def boom(*a, **kw):
        raise AssertionError("a checkpointed stage ran again")

    for name in ("map_all", "select_sv_reads", "extract_signatures",
                 "cns_groups", "remap_all"):
        monkeypatch.setattr(driver, name, boom)
    res = driver.run_pipeline(world["ref"], world["reads"], world["cfg"],
                              out_dir=world["tdir"], resume=True,
                              device="cpu")
    assert_same_records(res.calls, world["tres"].calls)
    with open(os.path.join(world["tdir"], "calls.vcf"), "rb") as fh:
        assert fh.read() == first


def test_port_resumes_from_jax_checkpoints(world, monkeypatch):
    """The ``.npz`` files are the state that crosses: the port resumes
    from the JAX package's out_dir without computing a stage."""
    def boom(*a, **kw):
        raise AssertionError("a checkpointed stage ran again")

    for name in ("map_all", "select_sv_reads", "extract_signatures",
                 "cns_groups", "remap_all"):
        monkeypatch.setattr(driver, name, boom)
    res = driver.run_pipeline(world["ref"], world["reads"], world["cfg"],
                              out_dir=world["jdir"], resume=True,
                              device="cpu")
    assert_same_records(res.calls, world["jres"].calls)


# -- group 2: each port stage on the JAX package's previous checkpoint -----

def test_sv_reads_stage_from_jax_map(world):
    m4s = sio.load_m4s(os.path.join(world["jdir"], "map.npz"))
    got = sv_reads.select_sv_reads(m4s, world["qstore"], world["sstore"],
                                   world["cfg"], device="cpu")
    assert_same_records(got, _load(world, "sv_reads", "jax"))


def test_signatures_stage_from_jax_sv_reads(world):
    svrs = sio.load_sv_reads(os.path.join(world["jdir"], "sv_reads.npz"))
    got = signatures.extract_signatures(svrs, world["qstore"],
                                        world["sstore"], world["cfg"],
                                        device="cpu")
    assert_same_records(got, _load(world, "signatures", "jax"))


def test_consensus_stage_from_jax_signatures(world):
    sigs = sio.load_signatures(os.path.join(world["jdir"],
                                            "signatures.npz"))
    groups = grouping.group_signatures(sigs, world["cfg"])
    got = cns.cns_groups(groups, world["qstore"], world["cfg"],
                         device="cpu")
    assert_same_records(got, _load(world, "consensus", "jax"))


def test_remap_stage_from_jax_consensus(world):
    crs = sio.load_corrected(os.path.join(world["jdir"], "consensus.npz"))
    got = remap.remap_all(crs, world["sstore"], world["cfg"], device="cpu")
    assert_same_records(got, _load(world, "remap", "jax"))


def test_call_stage_from_jax_remap(world):
    remapped = sio.load_remapped(os.path.join(world["jdir"], "remap.npz"))
    m4s = sio.load_m4s(os.path.join(world["jdir"], "map.npz"))
    best: dict = {}
    for m in m4s:
        cur = best.get(m.qid)
        if cur is None or m.score > cur[0]:
            best[m.qid] = (m.score, m.sid, m.soff, m.send)
    spans = [(sid, so, se) for _, sid, so, se in best.values()]
    got = caller.call_svs(remapped, world["sstore"], world["cfg"],
                          raw_spans=spans)
    assert_same_records(got, world["jres"].calls)
