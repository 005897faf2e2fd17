"""F1 harness of lesv_tpu_torch: the project's headline metric on
simulated truth, on a torch device.

The port's counterpart of ``tools/f1_eval.py``: the same flags, cases,
matching rules and JSON, with the pipeline and the caller of
``lesv_tpu_torch`` on ``--device`` (default ``cuda``; ``--cpu`` is
``--device cpu``, the plain versions).  Each ``per_seed`` entry also
reports on the run (nothing it computes changes): the card's
``nvidia-smi`` name and power limit, peak RSS, peak device memory
allocated and reserved, kernel launches per kernel and the fill
launches of the wide design (``fill_block``, W > 2,048), the fills that
went to the card and to the host (``align_batch.FILL_STATS``), and the
calls as sorted (kind, pos, length, support, genotype) with their
SHA-256.  The text below is ``tools/f1_eval.py``'s.


The reference's published numbers are precision/recall/F1 of the final
VCF vs GIAB truth, scored by truvari `-r 1000 -p 0.00 --passonly`
(the reference's `README.md:185-244`, `install_lesv.md:330-349`).  This
harness is the simulated-genome analogue: plant a het/hom DEL/INS
spectrum (40bp-30kb log-uniform lengths, optional tandem-repeat overlap,
clustered pairs) on two haplotypes, simulate noisy reads from both, run
the FULL pipeline (including the native caller), and score the VCF with
truvari's matching semantics (refdist 1000, size similarity 0.7, no
sequence comparison = `-p 0.00`).

Usage:
  python3 tools/torch_f1_eval.py --genome 2000000 --coverage 25 \
      --n-sv 40 --seeds 0 1 2 --out build/f1
  # caller-constant sweep over cached pipeline artifacts:
  python3 tools/torch_f1_eval.py ... --sweep
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np  # noqa: E402

from lesv_tpu_torch.config import LesvConfig  # noqa: E402
from lesv_tpu_torch.sim import (plant_svs_diploid, repeat_genome,  # noqa: E402
                                simulate_reads)
from torch_genome_scale import card_line, rss_gb  # noqa: E402


def evaluate(calls, truth, refdist: int = 1000, len_ratio: float = 0.7):
    """truvari-matching: greedy 1-1, same type, |pos| <= refdist, size
    similarity >= len_ratio (truvari pctsize default; `-p 0.00` skips
    sequence comparison).  Genotype concordance reported over TPs."""
    matched: dict[int, object] = {}
    tp_all, tp_out, gt_ok = 0, 0, 0
    n_out_truth = sum(1 for s in truth.svs if not s.in_trf)
    for sv in truth.svs:
        best, best_d = None, refdist + 1
        for i, c in enumerate(calls):
            if i in matched or c.kind != sv.kind:
                continue
            d = abs(c.pos - sv.ref_pos)
            if d > refdist:
                continue
            if min(c.length, sv.length) < len_ratio * max(c.length, sv.length):
                continue
            if d < best_d:
                best, best_d = i, d
        if best is not None:
            matched[best] = sv
            tp_all += 1
            if not sv.in_trf:
                tp_out += 1
            if calls[best].genotype == sv.genotype:
                gt_ok += 1
    fn = len(truth.svs) - tp_all
    fp = len(calls) - len(matched)
    prec = tp_all / max(tp_all + fp, 1)
    rec = tp_all / max(tp_all + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    rec_out = tp_out / max(n_out_truth, 1)
    f1_out = 2 * prec * rec_out / max(prec + rec_out, 1e-9)
    return dict(tp=tp_all, fp=fp, fn=fn,
                precision=round(prec, 4), recall=round(rec, 4),
                f1=round(f1, 4),
                recall_non_trf=round(rec_out, 4),
                f1_non_trf=round(f1_out, 4),
                gt_concordance=round(gt_ok / max(tp_all, 1), 4))


_case_cache: dict[object, tuple] = {}


def _sim_key(seed: int, args) -> tuple:
    """Cache/compatibility key: every argument the simulation depends
    on (a seed-only key silently served stale cases if build_case was
    ever called with different args in one process)."""
    return (seed, args.genome, args.coverage, args.err, args.mean_len,
            args.n_sv, args.min_len, args.max_len, args.het_frac,
            bool(args.trf), args.trf_frac, args.cluster_frac, args.out)


def build_case(seed: int, args):
    # memoized per (seed, sim args): the sweep re-scores 100+ CallConfig
    # combos over the same cached pipeline artifacts and must not
    # re-simulate
    ck = _sim_key(seed, args)
    if ck in _case_cache:
        return _case_cache[ck]
    rng = np.random.default_rng(seed)
    if args.trf:
        genome, trf = repeat_genome(rng, args.genome,
                                    n_tandem=max(2, args.genome // 300_000),
                                    n_runs=0)
    else:
        from lesv_tpu_torch.sim import random_genome

        genome, trf = random_genome(rng, args.genome), []
    hap1, hap2, truth = plant_svs_diploid(
        rng, genome, n_sv=args.n_sv, min_len=args.min_len,
        max_len=args.max_len, het_frac=args.het_frac,
        trf_intervals=trf, trf_frac=args.trf_frac,
        cluster_frac=args.cluster_frac)
    reads = (simulate_reads(rng, hap1, coverage=args.coverage / 2,
                            mean_len=args.mean_len, err=args.err)
             + simulate_reads(rng, hap2, coverage=args.coverage / 2,
                              mean_len=args.mean_len, err=args.err))
    # re-name to avoid hap1/hap2 collisions
    reads = [(f"h{i % 2}_{n}", s) for i, (n, s) in enumerate(reads)]
    _case_cache[ck] = (genome, trf, reads, truth)
    return _case_cache[ck]


def _check_sim_config(out: str, seed: int, args, must_exist=False):
    """Persist the sim config beside the stage checkpoints and refuse to
    reuse artifacts generated under different sim args (resume/sweep
    over a mismatched --genome/--coverage would silently score the
    wrong case)."""
    import json as _json

    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "sim_config.json")
    want = {"key": list(map(str, _sim_key(seed, args)))}
    if os.path.exists(path):
        with open(path) as fh:
            got = _json.load(fh)
        if got != want:
            raise SystemExit(
                f"{out}: checkpoints were generated with different sim "
                f"args ({got['key']} vs {want['key']}); delete the "
                f"directory or pass a different --out")
    elif must_exist:
        raise SystemExit(
            f"{out}: no sim_config.json — run eval before sweep")
    else:
        with open(path, "w") as fh:
            _json.dump(want, fh)


def call_keys(calls) -> list:
    """The calls as sorted [kind, pos, length, support, genotype]."""
    return sorted([c.kind, int(c.pos), int(c.length), int(c.support),
                   c.genotype] for c in calls)


def calls_digest(calls) -> str:
    return hashlib.sha256(json.dumps(call_keys(calls)).encode()).hexdigest()


def kernel_report() -> dict:
    """Launches per kernel since the last ``_ext.reset_launches()``, the
    fill launches of the wide design among them (``fill_block``: W above
    2,048), and the fills since ``align_batch.reset_fill_stats()``."""
    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.ops import align_batch

    return dict(launches=dict(_ext.LAUNCHES),
                fill_block_launches=sum(v for k, v in _ext.FILL_SHAPES.items()
                                        if k[4] > 2_048),
                fills=dict(align_batch.FILL_STATS))


def run_case(seed: int, args, cfg: LesvConfig):
    import torch

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.pipeline.driver import run_pipeline

    genome, trf, reads, truth = build_case(seed, args)
    out = os.path.join(args.out, f"seed{seed}")
    _check_sim_config(out, seed, args)
    on_card = torch.device(args.device).type == "cuda"
    _ext.reset_launches()
    align_batch.reset_fill_stats()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_pipeline([("chr1", genome)], reads, cfg,
                       trf_intervals={0: trf} if trf else None,
                       out_dir=out, resume=True, device=args.device)
    wall = time.time() - t0
    ev = evaluate(res.calls, truth)
    total_bases = sum(len(r) for _, r in reads)
    return dict(seed=seed, reads=len(reads), bases=total_bases,
                truth_n=len(truth.svs),
                truth_het=sum(1 for s in truth.svs if s.genotype == "0/1"),
                truth_trf=sum(1 for s in truth.svs if s.in_trf),
                calls=len(res.calls), eval=ev, wall_s=round(wall, 1),
                timings={k: round(v, 1) for k, v in res.timings.items()},
                device=str(args.device), card=card_line(args.device),
                host_small=os.environ.get("LESV_TORCH_HOST_SMALL", "auto"),
                bases_per_sec=round(total_bases / wall),
                peak_rss_gb=round(rss_gb(), 3),
                max_memory_allocated=(torch.cuda.max_memory_allocated()
                                      if on_card else None),
                max_memory_reserved=(torch.cuda.max_memory_reserved()
                                     if on_card else None),
                **kernel_report(),
                call_keys=call_keys(res.calls),
                calls_digest=calls_digest(res.calls))


def recall_cached(seed: int, args, cfg: LesvConfig):
    """Re-run ONLY the caller over a cached pipeline run (sweep mode)."""
    from lesv_tpu_torch.io.seqstore import SeqStore
    from lesv_tpu_torch.pipeline import stages_io as sio
    from lesv_tpu_torch.pipeline.caller import call_svs

    genome, trf, reads, truth = build_case(seed, args)
    out = os.path.join(args.out, f"seed{seed}")
    _check_sim_config(out, seed, args, must_exist=True)
    key = ("art",) + _sim_key(seed, args)
    if key not in _case_cache:
        _case_cache[key] = (
            SeqStore.from_records([("chr1", genome)]),
            sio.load_m4s(os.path.join(out, "map.npz")),
            sio.load_remapped(os.path.join(out, "remap.npz")))
    sstore, m4s, remapped = _case_cache[key]
    best_span: dict[int, tuple[int, int, int, int]] = {}
    for m in m4s:
        cur = best_span.get(m.qid)
        if cur is None or m.score > cur[0]:
            best_span[m.qid] = (m.score, m.sid, m.soff, m.send)
    raw_spans = [(sid, so, se) for _, sid, so, se in best_span.values()]
    calls = call_svs(remapped, sstore, cfg, raw_spans=raw_spans)
    return evaluate(calls, truth), len(calls)


def sweep(args):
    """Grid-sweep CallConfig constants over cached runs; justify (or
    retune) the hand-set defaults (hom_genotype_frac et al)."""
    grid = {
        "hom_genotype_frac": [0.45, 0.55, 0.65, 0.75],
        "min_support_frac": [0.05, 0.1, 0.2, 0.3],
        "cluster_dist": [500, 1000, 2000],
        # min_support=1 is the precision-side falsifier: single-read
        # spurious events pass, so these rows measure how much FP mass
        # the support gate actually holds back (VERDICT r4 weak-5: a
        # zero-FP case cannot discriminate precision constants)
        "min_support": [1, 2, 3, 4],
    }
    base = LesvConfig()
    rows = []
    import itertools

    keys = list(grid)
    for combo in itertools.product(*(grid[k] for k in keys)):
        cfg = LesvConfig()
        cfg.call = dataclasses.replace(base.call,
                                       **dict(zip(keys, combo)))
        evs = []
        for seed in args.seeds:
            ev, n = recall_cached(seed, args, cfg)
            evs.append(ev)
        rows.append(dict(
            params=dict(zip(keys, combo)),
            f1=round(float(np.mean([e["f1"] for e in evs])), 4),
            precision=round(float(np.mean([e["precision"] for e in evs])), 4),
            recall=round(float(np.mean([e["recall"] for e in evs])), 4),
            gt=round(float(np.mean([e["gt_concordance"] for e in evs])), 4)))
    rows.sort(key=lambda r: (r["f1"], r["gt"]), reverse=True)
    # the shipped-defaults row, emitted explicitly so the "defaults are
    # argmax / tie at the top" claim is self-contained in the artifact
    dflt = {k: getattr(base.call, k) for k in keys}
    default_row = next((r for r in rows if r["params"] == dflt), None)
    return dict(rows=rows,
                defaults=dict(params=dflt, row=default_row,
                              rank=(rows.index(default_row)
                                    if default_row in rows else None),
                              best_f1=rows[0]["f1"] if rows else None),
                f1_spread=(round(rows[0]["f1"] - rows[-1]["f1"], 4)
                           if rows else None))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=2_000_000)
    ap.add_argument("--coverage", type=float, default=25.0)
    ap.add_argument("--n-sv", type=int, default=40)
    ap.add_argument("--min-len", type=int, default=40)
    ap.add_argument("--max-len", type=int, default=30_000)
    ap.add_argument("--het-frac", type=float, default=0.5)
    ap.add_argument("--trf", action="store_true", default=True)
    ap.add_argument("--no-trf", dest="trf", action="store_false")
    ap.add_argument("--trf-frac", type=float, default=0.15)
    ap.add_argument("--cluster-frac", type=float, default=0.1)
    ap.add_argument("--err", type=float, default=0.08)
    ap.add_argument("--mean-len", type=int, default=12_000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "f1"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    import torch

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("torch_f1_eval: CUDA is not available "
                         "(--device cpu runs the plain versions)")
    os.makedirs(args.out, exist_ok=True)

    if args.sweep:
        sw = sweep(args)
        out = {"mode": "sweep", "config": vars(args) | {"seeds": args.seeds},
               "top": sw["rows"][:15], "best": sw["rows"][0],
               "defaults": sw["defaults"], "f1_spread": sw["f1_spread"],
               "n_combos": len(sw["rows"])}
    else:
        cfg = LesvConfig()
        reports = [run_case(s, args, cfg) for s in args.seeds]
        out = {
            "mode": "eval",
            "config": {k: getattr(args, k) for k in
                       ("genome", "coverage", "n_sv", "min_len", "max_len",
                        "het_frac", "trf_frac", "cluster_frac", "err",
                        "mean_len", "seeds")},
            "per_seed": reports,
            "f1_mean": round(float(np.mean(
                [r["eval"]["f1"] for r in reports])), 4),
            "f1_non_trf_mean": round(float(np.mean(
                [r["eval"]["f1_non_trf"] for r in reports])), 4),
            "precision_mean": round(float(np.mean(
                [r["eval"]["precision"] for r in reports])), 4),
            "recall_mean": round(float(np.mean(
                [r["eval"]["recall"] for r in reports])), 4),
            "gt_concordance_mean": round(float(np.mean(
                [r["eval"]["gt_concordance"] for r in reports])), 4),
        }
    path = args.json_out or os.path.join(args.out, "f1.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
