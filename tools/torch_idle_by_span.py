"""What the card waited on: its idle seconds by the port's innermost span.

Reads a Chrome trace written by ``torch.profiler`` (``trace.json`` of a
run with ``LESV_TORCH_PROFILE=dir``, or any trace whose program spans
appear as ``lesv/<name>`` ranges) and prints, over the whole trace, the
seconds in which no kernel, copy or memset ran, by the innermost span
that covered each idle stretch (``between spans`` outside every span;
``lesv_tpu_torch.utils.profiling.idle_by_span``), largest first.

Usage: python3 tools/torch_idle_by_span.py trace.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    args = ap.parse_args(argv)

    from lesv_tpu_torch.utils import profiling

    with open(args.trace) as fh:
        events = json.load(fh)["traceEvents"]
    r = profiling.idle_by_span(events)
    if not r["window_s"]:
        print("no timed event in the trace")
        return 1
    print(f"window {r['window_s']:.6f} s, device busy {r['busy_s']:.6f} s, "
          f"idle {r['idle_s']:.6f} s")
    print(f"{'idle s':>12}  {'share':>7}  span")
    for name, s in r["by_span"].items():
        print(f"{s:12.6f}  {100 * s / r['idle_s']:6.2f}%  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
