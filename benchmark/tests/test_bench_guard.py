"""The JAX guard, compared by whole top-level module names, and the exits
without a result: no card, or a checkout that holds only the benchmark."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT


@pytest.mark.parametrize("name,flagged", [
    ("lesv_tpu_torch", False), ("lesv_tpu_torch.pipeline.cns", False),
    ("lesv_tpu", True), ("lesv_tpu.ops.align_jax", True), ("jax", True),
    ("jaxlib.xla_client", True), ("flax.linen", True), ("jaxtyping", False),
    ("benchmark", False),
])
def test_guard_compares_whole_top_level_names(monkeypatch, name, flagged):
    monkeypatch.setitem(sys.modules, name, object())
    tops = {n.split(".", 1)[0] for n in list(sys.modules)}
    before = sorted(tops & set(harness.FORBIDDEN))
    got = harness.forbidden_loaded()
    assert (name.split(".", 1)[0] in got) == flagged
    assert set(before) <= set(got)


def test_harness_loads_no_jax():
    """Everything run.py can load, in a fresh process: no JAX, no
    lesv_tpu."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, trace, control, reference\n"
            "from benchmark.drivers import evidence, cns\n"
            "for m in harness.manifest()['end_to_end'] + "
            "harness.manifest()['per_layer']: harness.reader(m['name'])\n"
            "print(harness.forbidden_loaded())" % ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, check=True)
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "evidence.chr21", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, check=False)
    assert r.returncode != 0 and r.stdout == ""


def test_run_outside_a_checkout_of_the_program_fails(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "evidence.chr21", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, check=False)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
def test_one_run_on_the_card():
    """A short run of the cheapest cell on a card: a result line with every
    key, correct."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "evidence.chr21", "--seed", "2200009999",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       check=True)
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
