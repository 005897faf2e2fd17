"""Thread pools whose workers issue their device work on CUDA streams of
their own.

lesv_tpu keeps the device work of several chunks in flight with thread
pools (``align_batch._align_pairs_jax``, ``batch_align.batch_pair_chains``,
``mapper.map_all``); the kernels and readbacks of one chunk then run under
the host work of the next.  :class:`StreamPool` is that pool on a torch
device.  Each worker thread makes one stream on every card its tasks can
touch (``cuda:N`` itself; for plain ``cuda`` every visible card, since a
mesh or the round-robin of ``align_batch`` deals chunks to any of them)
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


def _cuda_devices(device) -> list[torch.device]:
    """The cards a dispatch on ``device`` can touch: ``cuda:N`` alone; for
    ``cuda`` without an index the current card, then every other visible
    card (the cards of a mesh, or of the round-robin without one); none
    for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return []
    if dev.index is not None:
        return [dev]
    cur = torch.cuda.current_device()
    return [torch.device("cuda", i) for i in
            [cur] + [i for i in range(torch.cuda.device_count()) if i != cur]]


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
