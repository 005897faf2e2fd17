"""Logging with the reference's timestamped-stderr style (`hbn_aux.c`)."""

from __future__ import annotations

import os
import sys
import time

_QUIET = os.environ.get("LESV_TORCH_QUIET", "0") == "1"


def log(msg: str) -> None:
    if _QUIET:
        return
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    print(f"[{ts}] {msg}", file=sys.stderr, flush=True)


class timing:
    """Context manager mirroring hbn_timing_begin/end."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        log(f"[{self.name}] begins...")
        return self

    def __exit__(self, *a):
        log(f"[{self.name}] done. ({time.time() - self.t0:.2f}s)")
