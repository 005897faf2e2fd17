"""The port's tools against lesv_tpu's: ``tools/torch_f1_eval.py`` against
``tools/f1_eval.py`` and ``tools/torch_scale_run.py`` against
``tools/scale_run.py``, on the same inputs made from numpy seeds.

- ``evaluate`` of both pairs of tools on a few hundred seeded call/truth
  sets (ties in distance, a call that could match two SVs, size ratios at
  0.7, empty lists);
- ``build_case`` at a small size, with and without the TRF bed;
- ``_check_sim_config`` refusing mismatched artifacts alike;
- ``main`` of both scale tools on a tiny genome;
- ``tools/torch_records.py``'s comparisons, and its removal of what an
  earlier run left.

The pinned case of ``chip_smoke.py``'s phase accuracy runs through both
tools in tests/test_torch_tools_pinned.py.  Every comparison is exact
equality: the outputs are integers, strings and floats computed by the
same expressions from equal integers.
"""
import argparse
import json
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
import scale_run  # noqa: E402
import torch_f1_eval  # noqa: E402
import torch_scale_run  # noqa: E402
from lesv_tpu import sim as jax_sim  # noqa: E402
from lesv_tpu.io.vcf import VcfCall as JaxCall  # noqa: E402
from lesv_tpu_torch import sim  # noqa: E402
from lesv_tpu_torch.io.vcf import VcfCall  # noqa: E402

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)

TOOLS = {"f1": (f1_eval, torch_f1_eval), "scale": (scale_run, torch_scale_run)}


# -- evaluate ---------------------------------------------------------------

def _sv_sets(rng, kind: str):
    """Call/truth sets as plain tuples: truth (kind, pos, length, genotype,
    in_trf), calls (kind, pos, length, genotype)."""
    sets = []
    for _ in range(300 if kind == "random" else 100):
        truth, calls = [], []
        if kind == "random":
            for _ in range(int(rng.integers(0, 9))):
                truth.append((str(rng.choice(["DEL", "INS"])),
                              int(rng.integers(0, 6_000)),
                              int(rng.integers(40, 3_000)),
                              str(rng.choice(["0/1", "1/1"])),
                              bool(rng.random() < 0.3)))
            for _ in range(int(rng.integers(0, 9))):
                calls.append((str(rng.choice(["DEL", "INS"])),
                              int(rng.integers(0, 6_000)),
                              int(rng.integers(40, 3_000)),
                              str(rng.choice(["0/1", "1/1"]))))
        elif kind == "ties":
            # calls at equal distances on both sides of each SV, and at
            # exactly refdist and refdist + 1
            for j in range(int(rng.integers(1, 5))):
                p, L = 2_000 * j + 500, int(rng.integers(100, 500))
                truth.append(("DEL", p, L, "0/1", j % 2 == 0))
                d = int(rng.choice([0, 7, 1_000, 1_001]))
                calls += [("DEL", p - d, L, "1/1"), ("DEL", p + d, L, "0/1")]
            order = rng.permutation(len(calls))
            calls = [calls[i] for i in order]
        elif kind == "ratio":
            # lengths at the 0.7 size ratio, just inside and just outside
            for j in range(int(rng.integers(1, 5))):
                L = int(rng.choice([100, 1_000, 70, 143]))
                truth.append(("INS", 3_000 * j, L, "1/1", False))
                cl = int(rng.choice([round(0.7 * L), round(0.7 * L) - 1,
                                     int(L / 0.7), int(L / 0.7) + 1]))
                calls.append(("INS", 3_000 * j + int(rng.integers(-5, 5)),
                              max(cl, 1), "1/1"))
        elif kind == "shared":
            # one call within reach of two SVs of its kind: the first SV
            # takes it, the second matches what is left
            for j in range(int(rng.integers(1, 4))):
                base = 5_000 * j
                a, b = base, base + int(rng.integers(100, 900))
                truth += [("DEL", a, 300, "0/1", False),
                          ("DEL", b, 310, "1/1", True)]
                calls.append(("DEL", (a + b) // 2, 305, "0/1"))
                if rng.random() < 0.5:
                    calls.append(("DEL", b + int(rng.integers(-50, 50)),
                                  290, "1/1"))
        else:  # empty: no calls, no truth, or neither
            n_t, n_c = [(0, 0), (0, 3), (3, 0)][len(sets) % 3]
            truth = [("INS", 1_000 * i, 200, "0/1", False)
                     for i in range(n_t)]
            calls = [("INS", 1_000 * i, 200, "0/1") for i in range(n_c)]
        sets.append((truth, calls))
    return sets


def _objects(truth, calls, sim_mod, call_cls):
    """(calls, truth) as one package's ``VcfCall`` and ``Truth``."""
    svs = [sim_mod.PlantedSV(k, p, L, None, g, t) for k, p, L, g, t in truth]
    cs = [call_cls(0, p, k, L, "N", "N", 3, 10, g) for k, p, L, g in calls]
    return cs, sim_mod.Truth(svs=svs)


@pytest.mark.parametrize("kind", ["random", "ties", "ratio", "shared",
                                  "empty"])
@pytest.mark.parametrize("tool", list(TOOLS))
def test_evaluate_equals_lesv_tpu(tool, kind):
    ref_tool, port_tool = TOOLS[tool]
    rng = np.random.default_rng(["random", "ties", "ratio", "shared",
                                 "empty"].index(kind))
    matched = 0
    for truth, calls in _sv_sets(rng, kind):
        want = ref_tool.evaluate(*_objects(truth, calls, jax_sim, JaxCall))
        got = port_tool.evaluate(*_objects(truth, calls, sim, VcfCall))
        assert got == want, (truth, calls)
        matched += want["tp"]
    assert matched > 0 or kind == "empty"


# -- build_case and _check_sim_config ----------------------------------------

def _args(out: str, **kw) -> argparse.Namespace:
    sim_args = dict(genome=40_000, coverage=2.0, err=0.08, mean_len=4_000,
                    n_sv=3, min_len=40, max_len=1_500, het_frac=0.5,
                    trf=True, trf_frac=0.5, cluster_frac=0.2)
    sim_args.update(kw)
    return argparse.Namespace(**sim_args, out=out, seeds=[0], device="cpu")


def _sv_fields(sv) -> tuple:
    return (sv.kind, sv.ref_pos, sv.length,
            None if sv.seq is None else sv.seq.tobytes(), sv.genotype,
            sv.in_trf)


@pytest.mark.parametrize("trf", [True, False])
def test_build_case_equals_lesv_tpu(tmp_path, trf):
    args = _args(str(tmp_path), trf=trf, genome=50_000)
    for seed in (0, 3):
        jg, jtrf, jreads, jtruth = f1_eval.build_case(seed, args)
        tg, ttrf, treads, ttruth = torch_f1_eval.build_case(seed, args)
        assert tg.dtype == jg.dtype and np.array_equal(tg, jg)
        assert ttrf == jtrf and (len(jtrf) >= 2) == trf
        assert [n for n, _ in treads] == [n for n, _ in jreads]
        assert all(n.startswith(f"h{i % 2}_")
                   for i, (n, _) in enumerate(treads))
        assert all(a.tobytes() == b.tobytes()
                   for (_, a), (_, b) in zip(treads, jreads))
        assert [_sv_fields(s) for s in ttruth.svs] == \
            [_sv_fields(s) for s in jtruth.svs]
        assert len(jtruth.svs) > 0
    # the cache is per tool and per argument set
    assert torch_f1_eval.build_case(0, args) is not \
        f1_eval.build_case(0, args)
    assert torch_f1_eval.build_case(0, args) is \
        torch_f1_eval.build_case(0, _args(str(tmp_path), trf=trf,
                                          genome=50_000))


@pytest.mark.parametrize("writer", ["lesv_tpu", "port"])
def test_check_sim_config_refuses_alike(tmp_path, writer):
    """Both tools refuse to sweep a directory without a sim config, accept
    the config either tool wrote for the same arguments, and refuse it for
    other arguments, with the same message."""
    tools = (f1_eval, torch_f1_eval)
    out = str(tmp_path / "seed0")
    args = _args(str(tmp_path))
    msgs = []
    for tool in tools:
        with pytest.raises(SystemExit) as e:
            tool._check_sim_config(out, 0, args, must_exist=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    (f1_eval if writer == "lesv_tpu" else torch_f1_eval)._check_sim_config(
        out, 0, args)
    for other in (_args(str(tmp_path), genome=41_000),
                  _args(str(tmp_path), trf=False),
                  _args(str(tmp_path / "elsewhere"))):
        msgs = []
        for tool in tools:
            tool._check_sim_config(out, 0, args)
            tool._check_sim_config(out, 0, args, must_exist=True)
            with pytest.raises(SystemExit) as e:
                tool._check_sim_config(out, 0, other)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "different sim args" in msgs[0]


# -- the scale tools ---------------------------------------------------------

SCALE_ARGV = ["--genome", "45000", "--coverage", "4", "--n-del", "1",
              "--n-ins", "0", "--mean-len", "4000", "--err", "0.08",
              "--seed", "2"]
SCALE_HOST_FIELDS = ("timings", "wall_s", "bases_per_sec", "peak_rss_gb")


def test_scale_run_main_equals_lesv_tpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["scale_run.py", *SCALE_ARGV, "--out",
                                      str(tmp_path / "jax")])
    scale_run.main()
    want = json.loads(capsys.readouterr().out)
    got = torch_scale_run.main([*SCALE_ARGV, "--out", str(tmp_path / "torch"),
                                "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(got))
    assert got["timings"].keys() == want["timings"].keys()
    extra = set(got) - set(want)
    assert extra == {"device", "card", "host_small", "max_memory_allocated",
                     "max_memory_reserved", "launches",
                     "fill_block_launches", "fills"}
    strip = lambda d: {k: v for k, v in d.items()
                       if k not in SCALE_HOST_FIELDS and k not in extra}
    assert strip(printed) == strip(want)
    assert want["stats"]["reads"] > 0 and want["truth"]


# -- the records script ------------------------------------------------------

def test_records_script_compares_each_field():
    """``tools/torch_records.py`` passes a record's own figures, names a
    changed field, and gives ``tools/torch_f1_eval.py`` the record's
    configuration."""
    import torch_records as tr

    for name in ("ACCURACY_r05.json", "ACCURACY_r05_long.json"):
        rec = tr.load(name)
        got = {"per_seed": [dict(seed=p["seed"], eval=dict(p["ours"]["eval"]),
                                 calls=p["ours"]["calls"])
                            for p in rec["per_seed"]],
               "f1_mean": rec["our_f1_mean"]}
        assert tr.compare_eval(got, rec) == []
        got["per_seed"][1]["eval"]["fp"] += 1
        got["per_seed"][2]["calls"] -= 1
        assert len(tr.compare_eval(got, rec)) == 2
        # seed 0 alone: no mean to compare
        assert tr.compare_eval(dict(per_seed=got["per_seed"][:1],
                                    f1_mean=0.0), rec) == []
        argv = tr.f1_argv(rec["config"], rec["config"]["seeds"])
        parsed = vars(_f1_parser_args(argv))
        assert {k: parsed[k] for k in rec["config"]} == rec["config"]
    rec = tr.load("SWEEP_r05.json")
    got = json.loads(json.dumps(rec))
    assert tr.compare_sweep(got, rec) == []
    got["defaults"]["rank"] += 1
    assert tr.compare_sweep(got, rec) == ["defaults"]
    rec = tr.load("SCALE_r05.json")
    got = json.loads(json.dumps(rec))
    assert tr.compare_scale(got, rec) == []
    got["stats"]["calls"] = 99
    assert tr.compare_scale(got, rec) == ["stats.calls: 99 against 100"]


@pytest.mark.parametrize("item", ["accuracy", "sweep", "scale"])
def test_records_script_never_compares_a_leftover_output(tmp_path,
                                                         monkeypatch, item):
    """A rerun of ``tools/torch_records.py`` removes what an earlier run
    left before its tool starts: neither a stage directory (the f1 tool
    resumes from it) nor a JSON equal to the record can stand in for a
    tool that computed nothing."""
    import torch_records as tr

    base = tmp_path / item
    (base / "seed0").mkdir(parents=True)
    (base / "seed0" / "map.npz").write_bytes(b"left by an earlier run")
    if item == "accuracy":
        rec = tr.load("ACCURACY_r05.json")
        stale = {"per_seed": [dict(seed=p["seed"], eval=p["ours"]["eval"],
                                   calls=p["ours"]["calls"])
                              for p in rec["per_seed"]],
                 "f1_mean": rec["our_f1_mean"]}
        assert tr.compare_eval(stale, rec) == []
        left = tmp_path / "accuracy.json"
    elif item == "sweep":
        stale = tr.load("SWEEP_r05.json")
        assert tr.compare_sweep(stale, stale) == []
        left = tmp_path / "sweep.json"
    else:
        stale = tr.load("SCALE_r05.json")
        assert tr.compare_scale(stale, stale) == []
        left = tmp_path / "scale.out"
    left.write_text(json.dumps(stale))
    seen = []

    def tool(name, argv, out, env=None):   # computes and writes nothing
        seen.append((os.path.exists(base), os.path.exists(left)))
        return 0.0, 0

    monkeypatch.setattr(tr, "run_tool", tool)
    assert tr.main(["--only", item, "--device", "cpu",
                    "--out", str(tmp_path)]) == 1
    assert seen and all(s == (False, False) for s in seen)
    assert not base.exists()


def _f1_parser_args(argv):
    """``tools/torch_f1_eval.py``'s arguments for ``argv``, parsed by its
    own parser (``main`` up to the parse)."""
    captured = {}

    class Stop(Exception):
        pass

    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        captured["args"] = parse(self, args)
        raise Stop

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", grab)
    try:
        torch_f1_eval.main(argv)
    except Stop:
        pass
    finally:
        mp.undo()
    return captured["args"]


def test_chip_smoke_first_half_keeps_the_reads_of_its_reference():
    """Phase dist's world (``chip_smoke.first_half``): each kept read is
    a stretch of the cut reference with the kept SVs applied, about half
    the reads stay, and the cut lies at least 50 kb from every SV."""
    from lesv_tpu_torch.sim import _apply_svs, plant_svs, random_genome
    from lesv_tpu_torch.sim import simulate_reads

    rng = np.random.default_rng(3)
    genome = random_genome(rng, 1_000_000)
    donor, truth = plant_svs(rng, genome, n_del=2, n_ins=2)
    reads = simulate_reads(rng, donor, coverage=2.0, mean_len=12_000,
                           err=0.1)
    ref, kept_truth, kept = chip_smoke.first_half(genome, donor, truth,
                                                  reads)
    cut = len(ref)
    assert np.array_equal(ref, genome[:cut])
    assert kept_truth.svs == [sv for sv in truth.svs if sv.ref_pos < cut]
    assert all(abs(sv.ref_pos - cut) >= 50_000 for sv in truth.svs)
    half_donor = _apply_svs(ref, kept_truth.svs)
    for name, _ in kept:
        a, b = (int(x) for x in name.rsplit("_", 2)[1:])
        assert b <= len(half_donor)
        assert np.array_equal(donor[a:b], half_donor[a:b])
    assert 0.3 * len(reads) < len(kept) < 0.7 * len(reads)
