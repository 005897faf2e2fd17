"""The pinned case of ``chip_smoke.py``'s phase accuracy through both F1
tools, ``tools/f1_eval.py`` (lesv_tpu) and ``tools/torch_f1_eval.py`` (the
port, on the CPU): ``run_case`` of both, with ``eval``, calls, the stage
records and the bytes of ``calls.vcf`` and ``remapped.sam`` equal to each
other and to the constants in ``chip_smoke.py`` (which the card is held
to); then ``sweep`` of both over those stage files.

Every comparison is exact equality.  A file of its own, so that it runs
on another worker than tests/test_torch_tools.py.
"""

import argparse
import dataclasses
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (constants only; the card is not touched)
import f1_eval  # noqa: E402
import torch_f1_eval  # noqa: E402
from lesv_tpu.config import LesvConfig as JaxConfig  # noqa: E402
from lesv_tpu.pipeline import stages_io as jax_sio  # noqa: E402
from lesv_tpu_torch.config import LesvConfig  # noqa: E402
from lesv_tpu_torch.pipeline import stages_io as sio  # noqa: E402

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)


# -- the pinned case ---------------------------------------------------------

def _pinned_args(out: str) -> argparse.Namespace:
    return argparse.Namespace(**chip_smoke.PINNED_ARGS, out=out,
                              seeds=[chip_smoke.PINNED_SEED], device="cpu")


@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    root = tmp_path_factory.mktemp("pinned")
    jargs = _pinned_args(str(root / "jax"))
    targs = _pinned_args(str(root / "torch"))
    seed = chip_smoke.PINNED_SEED
    jrep = f1_eval.run_case(seed, jargs, JaxConfig())
    trep = torch_f1_eval.run_case(seed, targs, LesvConfig())
    return dict(jargs=jargs, targs=targs, jrep=jrep, trep=trep,
                jdir=os.path.join(jargs.out, f"seed{seed}"),
                tdir=os.path.join(targs.out, f"seed{seed}"))


def test_pinned_case_holds_each_kind_of_sv():
    args = _pinned_args("unused")
    genome, trf, reads, truth = torch_f1_eval.build_case(
        chip_smoke.PINNED_SEED, args)
    svs = truth.svs
    assert {s.kind for s in svs} == {"DEL", "INS"}
    assert {s.genotype for s in svs} == {"0/1", "1/1"}
    in_trf = [s for s in svs if s.in_trf]
    assert in_trf and all(any(a <= s.ref_pos < b for a, b in trf)
                          for s in in_trf)


def test_pinned_eval_and_calls_equal_lesv_tpu_and_chip_smoke(pinned):
    jrep, trep = pinned["jrep"], pinned["trep"]
    same = ("seed", "reads", "bases", "truth_n", "truth_het", "truth_trf",
            "calls", "eval")
    assert {k: trep[k] for k in same} == {k: jrep[k] for k in same}
    assert trep["eval"] == chip_smoke.PINNED_EVAL
    assert trep["call_keys"] == chip_smoke.PINNED_CALLS
    assert trep["calls_digest"] == chip_smoke.PINNED_CALLS_DIGEST
    assert trep["timings"].keys() == jrep["timings"].keys()
    # the records of the run, on the CPU: no launch
    assert not any(trep["launches"].values()) and trep["card"] is None


def test_pinned_vcf_and_sam_bytes_equal_lesv_tpu_and_chip_smoke(pinned):
    for name in ("calls.vcf", "remapped.sam"):
        with open(os.path.join(pinned["tdir"], name), "rb") as fh:
            got = fh.read()
        with open(os.path.join(pinned["jdir"], name), "rb") as fh:
            assert got == fh.read(), name
        if name == "calls.vcf":
            assert len(got) == chip_smoke.PINNED_VCF_BYTES
            assert hashlib.sha256(got).hexdigest() == \
                chip_smoke.PINNED_VCF_SHA256


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
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    return v


STAGES = {          # checkpoint name -> (lesv_tpu loader, port loader)
    "map": (jax_sio.load_m4s, sio.load_m4s),
    "sv_reads": (jax_sio.load_sv_reads, sio.load_sv_reads),
    "signatures": (jax_sio.load_signatures, sio.load_signatures),
    "consensus": (jax_sio.load_corrected, sio.load_corrected),
    "remap": (jax_sio.load_remapped, sio.load_remapped),
}


@pytest.mark.parametrize("stage", list(STAGES))
def test_pinned_stage_records_equal(pinned, stage):
    jload, tload = STAGES[stage]
    want = jload(os.path.join(pinned["jdir"], stage + ".npz"))
    got = tload(os.path.join(pinned["tdir"], stage + ".npz"))
    assert len(want) > 0
    assert _plain(list(got)) == _plain(list(want))


def test_sweep_rows_equal_lesv_tpu(pinned):
    """``sweep`` of both tools over their own stage files, and the port's
    ``recall_cached`` over lesv_tpu's files (the formats agree)."""
    want = f1_eval.sweep(pinned["jargs"])
    got = torch_f1_eval.sweep(pinned["targs"])
    assert len(got["rows"]) == 192
    assert got == want
    seed = chip_smoke.PINNED_SEED
    cross = torch_f1_eval.recall_cached(seed, pinned["jargs"], LesvConfig())
    assert cross == (pinned["trep"]["eval"], pinned["trep"]["calls"])
