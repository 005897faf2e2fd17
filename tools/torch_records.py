"""lesv_tpu's accuracy and scale records, rerun by the port's tools.

    python3 tools/torch_records.py [--only accuracy long sweep scale
        profile accuracy_host_small0] [--out build/records] [--json-out build/records/records.json]

Each item runs one of the port's tools in a process of its own at the
configuration of a record in the repo's root, on ``--device`` (default
``cuda``), and compares what it prints with the record:

- ``accuracy``: ``tools/torch_f1_eval.py`` at ``ACCURACY_r05.json``'s
  configuration, its seeds; each seed's ``eval`` and call count against
  the record's "ours", and the F1 mean against ``our_f1_mean``;
- ``accuracy_host_small0``: the same, seed 0 only, with
  ``LESV_TORCH_HOST_SMALL=0`` (every fill on the card);
- ``long``: the same at ``ACCURACY_r05_long.json``'s (mean read 19 kb);
- ``sweep``: ``tools/torch_f1_eval.py`` at ``SWEEP_r05.json``'s
  configuration, its eval over the seeds, then ``--sweep`` over their
  stage files; ``top``, ``best``, ``defaults``, ``f1_spread`` and
  ``n_combos`` against the record's;
- ``scale``: ``tools/torch_scale_run.py`` at ``SCALE_r05.json``'s
  configuration; ``stats`` and ``eval`` against the record's;
- ``profile``: ``tools/torch_profile_e2e.py`` at its defaults (no record:
  its runs and span table are reported).

Every tool's JSON goes to ``<out>/<item>.json``, its standard output to
``<out>/<item>.out`` and its errors to ``<out>/<item>.log``; the f1 tool's
stage files go to ``<out>/<item>/``.  What an earlier run left there is
removed before an item starts (``fresh``): the f1 tool resumes from stage
files, and a record is only ever compared with what this run computed.
An item whose tool wrote no JSON differs with ``no output``.  The summary (the card's ``nvidia-smi`` name and
power limit, each item's wall seconds, the fields that differ) is printed
as one JSON object and written to ``--json-out``.  Exits 1 when a record
differs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITEMS = ("profile", "accuracy", "accuracy_host_small0", "long", "sweep",
         "scale")


def load(name: str) -> dict:
    with open(os.path.join(REPO, name)) as fh:
        return json.load(fh)


def f1_argv(cfg: dict, seeds: list) -> list:
    """``tools/torch_f1_eval.py`` flags of a record's configuration."""
    argv = []
    for k in ("genome", "coverage", "n_sv", "min_len", "max_len",
              "het_frac", "trf_frac", "cluster_frac", "err", "mean_len"):
        argv += ["--" + k.replace("_", "-"), str(cfg[k])]
    if cfg.get("trf") is False:
        argv.append("--no-trf")
    return argv + ["--seeds", *map(str, seeds)]


def compare_eval(got: dict, record: dict) -> list:
    """The fields in which an eval run differs from an ACCURACY record:
    each seed's ``eval`` and call count against "ours", and the F1 mean."""
    want = {p["seed"]: p["ours"] for p in record["per_seed"]}
    differ = []
    for rep in got["per_seed"]:
        ours = want.get(rep["seed"])
        if ours is None:
            differ.append(f"seed {rep['seed']}: no record")
            continue
        differ += [f"seed {rep['seed']} {k}: {v} against {ours['eval'][k]}"
                   for k, v in rep["eval"].items() if ours["eval"][k] != v]
        if rep["calls"] != ours["calls"]:
            differ.append(f"seed {rep['seed']} calls: {rep['calls']} "
                          f"against {ours['calls']}")
    if {r["seed"] for r in got["per_seed"]} == set(want) and \
            got["f1_mean"] != record["our_f1_mean"]:
        differ.append(f"f1_mean: {got['f1_mean']} against "
                      f"{record['our_f1_mean']}")
    return differ


def compare_sweep(got: dict, record: dict) -> list:
    return [k for k in ("top", "best", "defaults", "f1_spread", "n_combos")
            if got[k] != record[k]]


def compare_scale(got: dict, record: dict) -> list:
    return [f"{part}.{k}: {got[part].get(k)} against {v}"
            for part in ("stats", "eval") for k, v in record[part].items()
            if got[part].get(k) != v]


def fresh(base: str) -> None:
    """Remove what an earlier run of an item left under ``base``: the
    stage directory and the JSON, output and log files beside it."""
    shutil.rmtree(base, ignore_errors=True)
    for stem in (base, base + "_eval"):
        for ext in (".json", ".out", ".log"):
            if os.path.exists(stem + ext):
                os.remove(stem + ext)


def read_json(path: str):
    """The JSON at ``path``, or None where the tool wrote none."""
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def run_tool(name: str, argv: list, out: str, env: dict | None = None):
    """Run ``python3 tools/<name>`` with ``argv``; returns (seconds, exit
    code), its standard output in ``<out>.out``, its errors in
    ``<out>.log``."""
    t0 = time.time()
    with open(out + ".out", "w") as so, open(out + ".log", "w") as se:
        rc = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                          name), *argv],
                            stdout=so, stderr=se,
                            env={**os.environ, **(env or {})},
                            cwd=REPO).returncode
    return time.time() - t0, rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=ITEMS, default=list(ITEMS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "records"))
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from torch_genome_scale import card_line

    os.makedirs(args.out, exist_ok=True)
    summary: dict = {"card": card_line(args.device), "device": args.device,
                     "items": {}}
    dev = ["--device", args.device]
    for item in [i for i in ITEMS if i in args.only]:
        base = os.path.join(args.out, item)
        fresh(base)
        res: dict = {}
        got = None
        if item == "profile":
            res["s"], res["rc"] = run_tool(
                "torch_profile_e2e.py", dev + ["--out", base + ".json"], base)
            got = read_json(base + ".json")
            differ = []
        elif item == "scale":
            rec = load("SCALE_r05.json")
            res["s"], res["rc"] = run_tool(
                "torch_scale_run.py",
                dev + [f"--{k.replace('_', '-')}={v}"
                       for k, v in rec["config"].items()], base)
            differ = []
            got = read_json(base + ".out")
            if res["rc"] == 0 and got is not None:
                with open(base + ".json", "w") as fh:
                    json.dump(got, fh, indent=1)
                differ = compare_scale(got, rec)
        elif item == "sweep":
            rec = load("SWEEP_r05.json")
            fl = f1_argv(rec["config"], rec["config"]["seeds"]) + dev + [
                "--out", base]
            res["eval_s"], res["eval_rc"] = run_tool(
                "torch_f1_eval.py", fl + ["--json-out", base + "_eval.json"],
                base + "_eval")
            res["s"], res["rc"] = run_tool(
                "torch_f1_eval.py",
                fl + ["--sweep", "--json-out", base + ".json"], base)
            res["rc"] = res["rc"] or res["eval_rc"]
            differ = []
            got = read_json(base + ".json")
            if res["rc"] == 0 and got is not None:
                differ = compare_sweep(got, rec)
        else:
            rec = load("ACCURACY_r05_long.json" if item == "long"
                       else "ACCURACY_r05.json")
            seeds = ([0] if item == "accuracy_host_small0"
                     else rec["config"]["seeds"])
            env = ({"LESV_TORCH_HOST_SMALL": "0"}
                   if item == "accuracy_host_small0" else None)
            res["s"], res["rc"] = run_tool(
                "torch_f1_eval.py",
                f1_argv(rec["config"], seeds) + dev + [
                    "--out", base, "--json-out", base + ".json"], base, env)
            differ = []
            got = read_json(base + ".json")
            if res["rc"] == 0 and got is not None:
                differ = compare_eval(got, rec)
        if res["rc"] != 0:
            differ = differ + [f"exit code {res['rc']}"]
        elif got is None:
            differ = differ + ["no output"]
        res["differ"] = differ
        summary["items"][item] = res
        print(json.dumps({item: res}), flush=True)
    summary["ok"] = not any(r["differ"] for r in summary["items"].values())
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
