"""lesv_tpu_torch imports neither jax nor anything of lesv_tpu: a tiny
simulated world goes through the port's CLI (``map``, and ``run`` from
reads to a VCF) and through ``parallel.dist.distributed_call`` on the CPU
in a fresh interpreter (tests/conftest.py imports jax into every test
process, so this needs a subprocess), and no source file of the port
(``parallel/`` included) or ``chip_smoke.py`` names lesv_tpu in an import.
Also: no function of the port defaults its ``device`` to the CPU."""

import ast
import glob
import importlib
import inspect
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import torch

from lesv_tpu.io.fasta import write_fasta
from lesv_tpu.sim import mutate_read, plant_svs, random_genome, simulate_reads

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = """
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "lesv_tpu" or m.startswith("lesv_tpu."))
assert not bad, bad
print("NO_JAX")
"""

PROBE = """
import sys
import lesv_tpu_torch
from lesv_tpu_torch.__main__ import main
main(["map", sys.argv[1], sys.argv[2], "-o", sys.argv[3], "--device", "cpu"])
""" + CHECK

PROBE_RUN = """
import sys
from lesv_tpu_torch.__main__ import main
main(["run", sys.argv[1], "--device", "cpu"])
""" + CHECK


PROBE_DIST = """
import sys
from lesv_tpu_torch.io.fasta import read_fastx
from lesv_tpu_torch.parallel import mesh
from lesv_tpu_torch.parallel.dist import LocalExchange, distributed_call
calls = distributed_call(list(read_fastx(sys.argv[1])),
                         list(read_fastx(sys.argv[2])),
                         exchange=LocalExchange(), device="cpu")
print("CALLS", [(c.kind, c.pos, c.length) for c in calls])
""" + CHECK


def _probe_env():
    env = dict(os.environ, PYTHONPATH=REPO, LESV_TORCH_QUIET="1",
               OMP_NUM_THREADS="1")
    for k in ("JAX_PLATFORMS", "JAX_PLATFORM_NAME"):
        env.pop(k, None)
    return env


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
    r = subprocess.run([sys.executable, "-c", PROBE, ref, reads, out],
                       capture_output=True, text=True, timeout=300,
                       env=_probe_env(), cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX" in r.stdout
    with open(out) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()]
    assert {row[0] for row in rows} == {"r0", "r1"}
    assert all(row[1] == "chr1" for row in rows)


def test_run_cli_runs_without_jax_or_lesv_tpu(tmp_path):
    """``run cfg --device cpu``: reads to a VCF through every stage, with
    neither jax nor any lesv_tpu module loaded at the end."""
    rng = np.random.default_rng(11)
    genome = random_genome(rng, 24_000)
    donor, truth = plant_svs(rng, genome, n_del=1, n_ins=0, min_len=150,
                             max_len=300, margin=9_000, min_gap=1_000)
    reads = simulate_reads(rng, donor, coverage=5.0, mean_len=4_500,
                           min_len=3_500, err=0.06)
    ref_fa = str(tmp_path / "ref.fa")
    reads_fa = str(tmp_path / "reads.fa")
    write_fasta(ref_fa, [("chr1", genome)])
    write_fasta(reads_fa, reads)
    cfg = tmp_path / "run.cfg"
    cfg.write_text(f"PROJECT={tmp_path / 'proj'}\nRAW_READS={reads_fa}\n"
                   f"REFERENCE={ref_fa}\nTRF_FILE=\n"
                   "SVR_MIN_SEQ_SIZE=3000\n")
    r = subprocess.run([sys.executable, "-c", PROBE_RUN, str(cfg)],
                       capture_output=True, text=True, timeout=600,
                       env=_probe_env(), cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX" in r.stdout and "SV calls" in r.stdout
    proj = tmp_path / "proj"
    for name in ("calls.vcf", "remapped.sam", "profile.json", "map.done",
                 "remap.done"):
        assert (proj / name).exists(), name
    vcf = (proj / "calls.vcf").read_text().splitlines()
    assert vcf[0].startswith("##fileformat=VCF")
    (sv,) = truth.svs
    rows = [ln.split("\t") for ln in vcf if not ln.startswith("#")]
    assert any(row[0] == "chr1" and abs(int(row[1]) - sv.ref_pos) <= 50
               and "SVTYPE=DEL" in row[7] for row in rows), rows


def test_distributed_call_runs_without_jax_or_lesv_tpu(tmp_path):
    rng = np.random.default_rng(11)
    genome = random_genome(rng, 24_000)
    donor, truth = plant_svs(rng, genome, n_del=1, n_ins=0, min_len=150,
                             max_len=300, margin=9_000, min_gap=1_000)
    reads = simulate_reads(rng, donor, coverage=5.0, mean_len=4_500,
                           min_len=3_500, err=0.06)
    ref_fa = str(tmp_path / "ref.fa")
    reads_fa = str(tmp_path / "reads.fa")
    write_fasta(ref_fa, [("chr1", genome)])
    write_fasta(reads_fa, reads)
    r = subprocess.run([sys.executable, "-c", PROBE_DIST, ref_fa, reads_fa],
                       capture_output=True, text=True, timeout=600,
                       env=_probe_env(), cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX" in r.stdout
    (line,) = [ln for ln in r.stdout.splitlines() if ln.startswith("CALLS")]
    (sv,) = truth.svs
    assert any(k == "DEL" and abs(pos - sv.ref_pos) <= 50
               for k, pos, _ in ast.literal_eval(line[len("CALLS "):])), line


def test_no_device_parameter_defaults_to_the_cpu():
    """Every entry point runs on the card unless the caller asks for the
    CPU: no function or method of the port has a ``device`` parameter
    whose default is ``"cpu"`` or ``None``."""
    import lesv_tpu_torch

    seen, bad = 0, []
    for info in pkgutil.walk_packages(lesv_tpu_torch.__path__,
                                      "lesv_tpu_torch."):
        mod = importlib.import_module(info.name)
        funcs = []
        for _, obj in inspect.getmembers(mod):
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                funcs.append(obj)
            elif inspect.isclass(obj):
                funcs += [f for _, f in inspect.getmembers(
                    obj, inspect.isfunction)]
        for fn in funcs:
            par = inspect.signature(fn).parameters.get("device")
            if par is None:
                continue
            seen += 1
            if par.default is None or str(par.default) == "cpu":
                bad.append(f"{mod.__name__}.{fn.__qualname__}")
    assert seen >= 20, seen
    assert not bad, bad


def test_no_source_file_imports_lesv_tpu():
    files = glob.glob(os.path.join(REPO, "lesv_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30
    assert any(os.sep + "parallel" + os.sep in f for f in files)
    pat = re.compile(r"\b(?:import|from)\s+lesv_tpu\b(?!_)")
    bad = []
    for path in files:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                if pat.search(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{n}: "
                               f"{line.strip()}")
    assert not bad, bad
