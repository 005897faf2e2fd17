"""Build and load the hand-written CUDA kernels of the port.

Each ``csrc/<name>.cu`` file is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under the
git-ignored ``build/kernels/`` directory of the checkout, and loaded with
``ctypes``.  All missing libraries are compiled in parallel (one ``nvcc``
per source).  Nothing here runs at import time: the CPU tests import every
module of the port on machines without ``nvcc`` or a GPU.

Every C entry point launches on the current device, on the stream it is
given, and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.  A wrapper launches under :func:`on_device_of`, which makes
its tensors' device current (the sources hold no per-process state, and
``fill.cu``'s wide-band design opts in to its dynamic shared memory on
every launch, so any card of the host can be addressed).

``LAUNCHES`` holds one plain integer per kernel.  A wrapper adds one where
it launches its kernel and nowhere else (:func:`count_launch`), so a run
can show that its main path went through the kernels.  ``FILL_SHAPES``
counts the fill's launches by shape, keyed ``(state type, mode, free_end,
Qmax, W, B)``, beside it.  Both are updated under a lock: the wrappers run
on several dispatch threads at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
KERNELS = ("fill", "chain", "traceback")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# csrc/fill.cu holds two kernels (int32 and int16 state), counted apart
LAUNCHES: dict[str, int] = {k: 0 for k in (*KERNELS, "fill_i16")}
FILL_SHAPES: dict[tuple, int] = {}

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[str, ctypes._CFuncPtr] = {}

P = ctypes.c_void_p
I = ctypes.c_int


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        FILL_SHAPES.clear()


def count_launch(kernel: str, shape: tuple | None = None) -> None:
    """Count one launch of ``kernel`` and, for the fill, of its ``shape``."""
    with _count_lock:
        LAUNCHES[kernel] += 1
        if shape is not None:
            FILL_SHAPES[shape] = FILL_SHAPES.get(shape, 0) + 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of lesv_tpu_torch "
                       "are built at first use on a CUDA host")


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"liblesv_{name}.so")


def _stale(name: str) -> bool:
    so = _so_path(name)
    src = os.path.join(CSRC, f"{name}.cu")
    return (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src))


def build(names=KERNELS) -> None:
    """Compile every stale kernel library, all ``nvcc`` runs at once."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for n in todo:
        tmp = _so_path(n) + f".{os.getpid()}.tmp"
        log = open(os.path.join(BUILD_DIR, f"{n}.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs.append((n, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, log, pr in procs:
        rc = pr.wait()
        log.close()
        if rc != 0:
            failed.append(n)
        else:
            os.replace(tmp, _so_path(n))
    if failed:
        msgs = []
        for n in failed:
            with open(os.path.join(BUILD_DIR, f"{n}.log")) as fh:
                msgs.append(f"--- {n}.cu ---\n{fh.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))


def function(kernel: str, symbol: str, argtypes: list,
             restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``csrc/<kernel>.cu`` (built and
    loaded on first use), returning ``restype`` (an int CUDA error code
    unless said otherwise)."""
    key = f"{kernel}:{symbol}"
    fn = _funcs.get(key)
    if fn is not None:
        return fn
    with _lock:
        if kernel not in _libs:
            build()
            _libs[kernel] = ctypes.CDLL(_so_path(kernel))
        fn = getattr(_libs[kernel], symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _funcs[key] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def on_device_of(*tensors):
    """Context manager for one kernel launch: makes the CUDA device that
    holds ``tensors`` current, so that the launch, its stream
    (:func:`stream_of`) and its ``cudaFuncSetAttribute`` all address that
    card.  Tensors on different devices, or not on a CUDA device, raise
    ``ValueError``."""
    import torch

    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError("kernel inputs lie on different devices: "
                         f"{sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs lie on {dev}, not on a CUDA device")
    return torch.cuda.device(dev)


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
