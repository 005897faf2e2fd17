"""lesv_tpu_torch never imports jax: map a tiny simulated genome through
the port's CLI on the CPU in a fresh interpreter (tests/conftest.py
imports jax into every test process, so this needs a subprocess)."""

import os
import subprocess
import sys

import numpy as np

from lesv_tpu.io.fasta import write_fasta
from lesv_tpu.sim import mutate_read, random_genome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import lesv_tpu_torch
from lesv_tpu_torch.__main__ import main
main(["map", sys.argv[1], sys.argv[2], "-o", sys.argv[3], "--device", "cpu"])
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("NO_JAX")
"""


def test_map_cli_runs_without_jax(tmp_path):
    rng = np.random.default_rng(1)
    genome = random_genome(rng, 40_000)
    ref = str(tmp_path / "ref.fa")
    reads = str(tmp_path / "reads.fa")
    out = str(tmp_path / "out.m4")
    write_fasta(ref, [("chr1", genome)])
    write_fasta(reads, [
        ("r0", mutate_read(rng, genome[2_000:9_000], err=0.08)),
        ("r1", mutate_read(rng, genome[20_000:26_000], err=0.08)),
    ])
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("JAX_PLATFORMS", "JAX_PLATFORM_NAME"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", PROBE, ref, reads, out],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX" in r.stdout
    with open(out) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()]
    assert {row[0] for row in rows} == {"r0", "r1"}
    assert all(row[1] == "chr1" for row in rows)
