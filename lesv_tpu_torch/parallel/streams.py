"""Thread pools whose workers issue their device work on CUDA streams of
their own.

lesv_tpu keeps the device work of several chunks in flight with thread
pools (``align_batch._align_pairs_jax``, ``batch_align.batch_pair_chains``,
``mapper.map_all``); the kernels and readbacks of one chunk then run under
the host work of the next.  :class:`StreamPool` is that pool on a torch
device.  Each worker thread makes one stream on every card its tasks can
touch (the device, or every card of the mesh a dispatch on it runs over)
once, when the thread starts; a task runs with those streams current
(``torch.cuda.stream``) and with the caller's current device, so the
kernels' wrappers, which launch on the current stream
(``_ext.stream_of``), put its work there.  Before a task starts, each of
its streams waits on the stream that was current on the same card in the
thread that made the pool: tensors made there (the device k-mer index, a
caller's inputs) are complete before a worker reads them.

On the CPU a :class:`StreamPool` is a plain thread pool.  An exception in
a task is raised by its future's ``result()``.
"""

from __future__ import annotations

import concurrent.futures as _fut
import contextlib
import threading

import torch

from lesv_tpu_torch.parallel import mesh as meshmod


def _cuda_devices(device) -> list[torch.device]:
    """The cards a dispatch on ``device`` can touch: the device itself (the
    current card for ``cuda`` without an index), then the other cards of
    the mesh it runs over; none for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return []
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    devs = [torch.device("cuda", idx)]
    mesh = meshmod.active_mesh(dev)
    if mesh is not None:
        devs += [d for d in mesh.devices if d not in devs]
    return devs


class StreamPool:
    """``max_workers`` threads, each with a CUDA stream of its own on every
    card of ``device`` (see the module docstring).  Use as a context
    manager; leaving it waits for every task."""

    def __init__(self, max_workers: int, device):
        self._devices = _cuda_devices(device)
        self._callers = [torch.cuda.current_stream(d) for d in self._devices]
        self._current = (torch.cuda.current_device() if self._devices
                         else None)
        self._local = threading.local()
        self._pool = _fut.ThreadPoolExecutor(max_workers=max_workers,
                                             initializer=self._start)

    def _start(self) -> None:
        self._local.streams = [torch.cuda.Stream(d) for d in self._devices]

    def _run(self, fn, args):
        with contextlib.ExitStack() as st:
            for s, caller in zip(self._local.streams, self._callers):
                s.wait_stream(caller)
                st.enter_context(torch.cuda.stream(s))
            if self._current is not None:
                # entering a stream makes its card current
                st.enter_context(torch.cuda.device(self._current))
            return fn(*args)

    def submit(self, fn, *args) -> _fut.Future:
        return self._pool.submit(self._run, fn, args)

    def __enter__(self) -> StreamPool:
        return self

    def __exit__(self, *exc) -> None:
        self._pool.shutdown(wait=True)
