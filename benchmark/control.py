"""The runs that the limits of ``correct`` were set against: a run of a
cell with the timed path's answers replaced underneath.  The benchmark's
own runs never take this path.

``--mode control`` breaks a guarantee that the configuration states:

* ``evidence`` cells: every M4 record's score is the reference's score of
  its own ops summed in int16, the state width below the stated int32
  (the int16 fill the port gates off where it could overflow);
* ``cns`` cells: every corrected read keeps its raw template in place of
  the consensus, so it is the consensus of one read, not of at least
  three.

``--mode half`` leaves half of the work out: the records of the second
half of each chunk's reads, or the second half of each call's groups.

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s> --mode <control|half>

prints the run's result line, as ``run.py`` does.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@contextlib.contextmanager
def int16_scores():
    """M4 scores re-summed in int16 from their ops, on the benchmark's own
    reads and reference."""
    from benchmark import reference
    from benchmark.drivers import evidence

    real_map, real_setup = evidence.map_all, evidence.setup
    held: dict = {}

    def setup(cell, config, seed, devices):
        st = real_setup(cell, config, seed, devices)
        held["subject"] = st.subject
        held["costs"] = evidence.costs(st.cfg)
        return st

    def map_all(recs, *a, **kw):
        m4s, qstore = real_map(recs, *a, **kw)
        if "subject" in held:
            for m in m4s:
                read = recs[m.qid][1]
                q = read if m.qdir == 0 else reference.revcomp(read)
                s = held["subject"](m.sid, m.soff, m.send)
                r = reference.read_alignment(m.ops, q, s, m.qoff, 0,
                                             held["costs"], dtype=np.int16)
                if r is not None:
                    m.score = r["score"]
        return m4s, qstore

    evidence.setup, evidence.map_all = setup, map_all
    try:
        yield
    finally:
        evidence.setup, evidence.map_all = real_setup, real_map


@contextlib.contextmanager
def raw_templates():
    """Corrected reads that keep their raw template."""
    from benchmark.drivers import cns

    real = cns.cns_groups

    def cns_groups(groups, qstore, *a, **kw):
        out = real(groups, qstore, *a, **kw)
        for r in out:
            raw = qstore.get(r.global_id)
            r.seq = raw
            r.cns_to = min(r.cns_to, len(raw))
        return out

    cns.cns_groups = cns_groups
    try:
        yield
    finally:
        cns.cns_groups = real


@contextlib.contextmanager
def half_work(driver: str):
    """The timed entry answers for half of its input only."""
    from benchmark.drivers import cns, evidence

    if driver == "evidence":
        mod, name = evidence, "map_all"

        def broken(recs, *a, **kw):
            m4s, qstore = real(recs, *a, **kw)
            return [m for m in m4s if m.qid < len(recs) // 2], qstore
    else:
        mod, name = cns, "cns_groups"

        def broken(groups, *a, **kw):
            return real(groups[: len(groups) // 2], *a, **kw)
    real = getattr(mod, name)
    setattr(mod, name, broken)
    try:
        yield
    finally:
        setattr(mod, name, real)


def mode_of(driver: str, mode: str):
    if mode == "half":
        return half_work(driver)
    return {"evidence": int16_scores, "cns": raw_templates}[driver]()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a control run of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("control", "half"), default="control")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    devices = [f"cuda:{i}" for i in range(cell["chips"])]
    with mode_of(cell["driver"], args.mode):
        out = harness.run(args.workload, args.seed, args.seconds, False,
                          T_START, devices, cell=cell)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
