"""Time the fill, traceback and chain-scan kernels of two checkouts of the
port in turns on one CUDA card.

    python3 tools/torch_kernel_ab.py --trees build/parent .

Runs one process per turn, in the order A, B, B, A (A and B the two trees);
each process builds that tree's kernels (into its own ``build/kernels/``),
makes the same inputs from seed 0 with ``fill_case``, ``hist_case``,
``traceback_probe`` and ``chain_case`` of this checkout's
``chip_smoke.py``, and times each
case three ways, over ``REPS`` calls each, with its ``cuda_ms`` (``_ms``:
events around back-to-back calls) and ``device_host_ms`` (``_device_ms``:
calls queued behind a sleeping kernel; ``_host_ms``: the host clock to
issue a call meanwhile, the host cost alone):

* the fill (``fill_cuda``), int32 at diag B=256 Q=4096 W=512 and int16 at
  diag B=256 Q=256 W=512, and at each bucket of
  ``chip_smoke.FILL_HIST_SHAPES`` (the largest of the fill launch
  histogram of ``chip_smoke.py``'s phase run) in its state type;
* the traceback on the int32 fill's direction bytes at diag B=256 Q=4096
  W=512 (T=4611) and on the int16 fill's at diag B=256 Q=256 W=512 (T=771);
* the traceback's C entry point alone at Q=256 (outputs allocated once,
  no wrapper): its ``_host_ms`` is the launcher's host cost;
* the traceback on the two probes of ``chip_smoke.TRACEBACK_PROBES``;
* the chain scan at B=128 J=64, M=16384 and M=8192;
* ``fill_block`` at ``chip_smoke.FILL_BLOCK_SHAPES`` (the map's and the
  whole-span NW's bands above 2,048), in the state type the gate picks,
  over ``BLOCK_REPS`` calls each.

Each turn prints one JSON line; the last line holds the mean of the two
turns of each tree and the ratio A / B.  Outputs of the two trees are
compared (exact equality) through checksums.  The tree's package is the
only one imported in its process: this script imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20  # calls a timing
BLOCK_REPS = 5  # calls a timing of fill_block (up to a second a call)


def _launcher(dirs, end_i, end_b, ok, W, mode, T):
    """A call of the traceback's C entry point on outputs allocated once:
    what ``traceback_cuda`` launches, without its host work around it."""
    import torch

    from lesv_tpu_torch import _ext

    B, R, _ = dirs.shape
    dev = dirs.device
    okv = ok.to(torch.uint8)
    ops = torch.empty((B, T), dtype=torch.uint8, device=dev)
    nops = torch.empty(B, dtype=torch.int32, device=dev)
    reached = torch.empty(B, dtype=torch.uint8, device=dev)
    P, I = _ext.P, _ext.I
    fn = _ext.function("traceback", "lesv_traceback",
                       [P, I, I, I, P, P, P, I, I, P, P, P, P])
    args = (dirs.data_ptr(), B, R, W, end_i.data_ptr(), end_b.data_ptr(),
            okv.data_ptr(), int(mode == "diag"), T, ops.data_ptr(),
            nops.data_ptr(), reached.data_ptr(), _ext.stream_of(dirs))
    return lambda: _ext.check(fn(*args), "lesv_traceback")


def _turn(tree: str) -> dict:
    import importlib.util

    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    # this checkout's chip_smoke.py (inputs and timing), whatever the tree
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.config import AlignConfig
    from lesv_tpu_torch.ops import align_torch as at
    from lesv_tpu_torch.ops import chain_torch as ct

    assert _ext.__file__.startswith(os.path.abspath(tree)), _ext.__file__
    _ext.build()
    dev = torch.device("cuda")
    cfg = AlignConfig()
    rng = np.random.default_rng(0)
    out = dict(tree=tree)

    def timed(name, fn, reps=REPS):
        out[f"{name}_ms"] = cs.cuda_ms(fn, reps)
        out[f"{name}_device_ms"], out[f"{name}_host_ms"] = (
            cs.device_host_ms(fn, reps))

    def fill(name, case, i16, reps=REPS):
        """Time one fill and keep its checksums: live direction bytes,
        score, end cell and ok."""
        qn, sn, qln, sln, W, mode, fe = case
        q, s, ql, sl = (torch.from_numpy(x).to(dev)
                        for x in (qn, sn, qln, sln))
        timed(name, lambda: at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe,
                                         i16=i16), reps)
        res = at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe, i16=i16)
        live = (torch.arange(res[0].shape[1], device=dev)[None, :, None]
                <= ql[:, None, None])
        out[f"{name}_sum"] = [int(torch.where(live, res[0], 0).long().sum())
                              ] + [int(x.long().sum()) for x in res[1:]]
        return q, res

    for kind, i16 in (("diag_W512", False), ("i16_diag_Q256_W512", True)):
        case = cs.fill_case(rng, kind)
        q, (d, _, ei, eb, ok) = fill(
            f"fill_{'i16' if i16 else 'i32'}_{case[5]}_Q{case[0].shape[1]}"
            f"_W{case[4]}", case, i16)
        W, mode = case[4], case[5]
        T = q.shape[1] + 1 + W + 2
        name = f"traceback_Q{q.shape[1]}"
        timed(name, lambda: at.traceback_cuda(d, ei, eb, ok, W, mode, T))
        ops, n, r = at.traceback_cuda(d, ei, eb, ok, W, mode, T)
        out[f"{name}_sum"] = [int(ops.long().sum()), int(n.long().sum()),
                              int(r.sum())]
        if i16:
            timed(f"{name}_launcher", _launcher(d, ei, eb, ok, W, mode, T))
    for shape in cs.FILL_HIST_SHAPES:
        st, mode, fe, Q, W, B = shape
        fill(f"fill_{st}_{mode}{'_fe' if fe else ''}_Q{Q}_W{W}_B{B}",
             cs.hist_case(rng, shape), st == "i16")
    for probe in cs.TRACEBACK_PROBES:
        d, ei, eb, ok, W, mode, T = cs.traceback_probe(probe, dev)
        timed(f"traceback_{probe}",
              lambda: at.traceback_cuda(d, ei, eb, ok, W, mode, T))
        n = at.traceback_cuda(d, ei, eb, ok, W, mode, T)[1]
        out[f"traceback_{probe}_sum"] = [int(n.long().sum())]
        del d
    args = dict(J=64, length=15, max_dq=5000, max_dr=5000, bw=1500)
    for M in (16384, 8192):
        qoff, soff, valid = cs.chain_case(rng, M)
        qs, ss_, vs = ct.sort_seeds_device(
            torch.from_numpy(qoff).to(dev), torch.from_numpy(soff).to(dev),
            torch.from_numpy(valid).to(dev))
        timed(f"chain_M{M}", lambda: ct.chain_scan_cuda(qs, ss_, vs, **args))
        f, p, v = ct.chain_scan_cuda(qs, ss_, vs, **args)
        out[f"chain_M{M}_sum"] = [int(f.long().sum()), int(p.long().sum()),
                                  int(v.long().sum())]
    for mode, Q, W, B in cs.FILL_BLOCK_SHAPES:
        i16 = at.i16_ok(Q, W, cfg)
        fill(f"block_{'i16' if i16 else 'i32'}_{mode}_Q{Q}_W{W}_B{B}",
             cs.hist_case(rng, (None, mode, False, Q, W, B)), i16,
             BLOCK_REPS)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        print(json.dumps(_turn(a.turn)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    A, B = a.trees
    turns = []
    for tree in (A, B, B, A):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--turn", tree],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    keys = [k for k in turns[0] if k.endswith("_ms")]
    mean = {t: {k: sum(x[k] for x in turns if x["tree"] == t) / 2
                for k in keys} for t in (A, B)}
    same = all(turns[0][k] == turns[1][k] for k in turns[0]
               if k.endswith("_sum"))
    print(json.dumps(dict(mean_ms=mean, equal_outputs=same,
                          ratio_a_over_b={k: mean[A][k] / mean[B][k]
                                          for k in keys})), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
