"""TRF masking on a repeat-rich world: the port's ``run`` against
lesv_tpu's, stage by stage, with the port's overlap forced on.

The world is built with ``sim.repeat_genome`` (tandem arrays, a segmental
duplication, an N run) at half the size of tests/test_torch_stages.py's (30
kb against 60 kb, 3 kb reads), with one DEL and one INS planted outside the
repeats.  Both
packages' ``run_pipeline`` get the tandem arrays as ``trf_intervals`` and
the same ``batch_reads``, small enough for three map batches.  The port runs
on the CPU with 4 dispatch workers and 2 map batches in flight (by
monkeypatch), so its stages go through the pooled ``align_pairs``,
``batch_pair_chains`` and ``map_all``.  Every stage's records must be equal
field by field, and ``remapped.sam`` and ``calls.vcf`` byte-identical.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lesv_tpu.config import LesvConfig as JaxConfig
from lesv_tpu.pipeline import driver as jax_driver
from lesv_tpu.pipeline import stages_io as jax_sio
from lesv_tpu.sim import repeat_genome, simulate_reads
from lesv_tpu_torch import convert
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops import align_batch
from lesv_tpu_torch.pipeline import driver, mapper
from lesv_tpu_torch.pipeline import stages_io as sio
from lesv_tpu_torch.pipeline.sv_reads import TrfMask

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
BATCH_READS = 16


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
    return {f.name: _plain(getattr(rec, f.name))
            for f in dataclasses.fields(rec)}


def _repeat_world(rng):
    """(genome, TRF intervals, reads): a 30 kb repeat-rich genome (two
    tandem arrays of 1.5 to 2.5 kb, one duplication, one N run), one 300 bp
    DEL and one 250 bp INS at least 2.5 kb from every array and N run,
    reads of 2 to 3 kb at coverage 5 (N stretches read as random bases, as
    sequencers call them)."""
    genome, trf = repeat_genome(rng, 30_000, n_tandem=2,
                                array_range=(1_500, 2_500), n_dups=1,
                                dup_range=(1_500, 2_500), n_runs=1)

    def clear(p, margin=2_500):
        return (all(not a - margin < p < b + margin for a, b in trf)
                and not (genome[max(0, p - margin) : p + margin] >= 4).any())

    sites: list[int] = []
    while len(sites) < 2:
        p = int(rng.integers(5_000, 25_000))
        if clear(p) and all(abs(p - q) > 7_000 for q in sites):
            sites.append(p)
    del_pos, ins_pos = sorted(sites)
    donor = np.concatenate([genome[:del_pos], genome[del_pos + 300 : ins_pos],
                            rng.integers(0, 4, 250).astype(np.uint8),
                            genome[ins_pos:]])
    reads = simulate_reads(rng, donor, coverage=5.0, mean_len=3_000,
                           min_len=2_000, err=0.08)
    reads = [(n, np.where(r >= 4, rng.integers(0, 4, len(r)), r)
              .astype(np.uint8)) for n, r in reads]
    return genome, trf, reads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(23)
    genome, trf, reads = _repeat_world(rng)
    ref = [("chr1", genome)]
    jcfg = JaxConfig()
    jcfg.cns.min_size = 1_000       # short synthetic reads
    jcfg.map.batch_reads = BATCH_READS
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    root = tmp_path_factory.mktemp("trf")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    jres = jax_driver.run_pipeline(ref, reads, jcfg, trf_intervals={0: trf},
                                   out_dir=jdir, resume=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(align_batch, "_n_dispatch_workers", lambda dev: 4)
        mp.setattr(mapper, "_map_overlap_depth", lambda dev: 2)
        tres = driver.run_pipeline(ref, reads, cfg, trf_intervals={0: trf},
                                   out_dir=tdir, resume=True, device="cpu")
    return dict(ref=ref, reads=reads, trf=trf, jdir=jdir, tdir=tdir,
                jres=jres, tres=tres, cfg=cfg)


@pytest.mark.parametrize("stage", list(STAGES))
def test_trf_stage_records_equal(world, stage):
    jload, tload = STAGES[stage]
    want = jload(os.path.join(world["jdir"], stage + ".npz"))
    got = tload(os.path.join(world["tdir"], stage + ".npz"))
    assert len(want) > 0
    assert [_fields(g) for g in got] == [_fields(w) for w in want]
    assert world["tres"].stats == world["jres"].stats


def test_trf_files_identical_and_mask_reached(world):
    """The SAM and VCF bytes are equal, the map ran in three batches, and
    the mask was reached: map records fall in a tandem array."""
    for name in ("remapped.sam", "calls.vcf"):
        with open(os.path.join(world["tdir"], name), "rb") as fh:
            got = fh.read()
        with open(os.path.join(world["jdir"], name), "rb") as fh:
            assert got == fh.read(), name
    assert [_fields(c) for c in world["tres"].calls] == \
        [_fields(c) for c in world["jres"].calls]
    assert len(world["reads"]) > 2 * BATCH_READS
    m4s = sio.load_m4s(os.path.join(world["tdir"], "map.npz"))
    mask = TrfMask(SeqStore.from_records(world["ref"]), {0: world["trf"]})
    assert sum(mask.fall_in(m.sid, m.soff, m.send) for m in m4s) >= 3
