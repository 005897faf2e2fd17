"""Device-mesh data parallelism for the mapping compute.

Counterpart of :mod:`lesv_tpu.parallel.mesh`.  There the mesh is a
``jax.sharding.Mesh`` and the batch split is a ``shard_map`` around the
fill; here a :class:`Mesh` is a tuple of torch devices and the split is
written out: a batch is cut into ``mesh.size`` equal contiguous shards,
shard *i* is copied to device *i* and computed there by the same wrappers
a single device uses (the hand-written CUDA kernels on a card, their plain
PyTorch versions on CPU tensors).  Launches are asynchronous, so every
device's work is queued before anything is waited for and the cards run at
once.  The k-mer index is replicated per device; the per-shard statistics
that ``psum`` merged are summed on the host.

``mesh_fill`` has no arithmetic of its own: what it launches is
``csrc/fill.cu`` through :func:`align_torch.banded_fill`.

A mesh reaches the pipeline through :func:`use_mesh`, or automatically: a
call whose device is plain ``cuda`` (no index) on a host with more than one
visible card runs its fills over all of them.  A device with an index
(``cuda:1``) and ``cpu`` never pick up the automatic mesh; the CPU tests
opt in with ``use_mesh(make_mesh(devices=[cpu] * n))``.  The switch
``LESV_TORCH_MESH=0`` (lesv_tpu's ``LESV_TPU_MESH=0``, read at call time)
turns the automatic mesh off; ``align_batch.align_pairs`` then deals whole
chunks to the cards in turn.  An explicit :func:`use_mesh` still applies.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass

import torch

from lesv_tpu_torch.config import AlignConfig, ChainConfig, SeedingConfig
from lesv_tpu_torch.ops import align_torch


@dataclass(frozen=True)
class Mesh:
    """The devices of one host that share a batch, in shard order."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` visible CUDA devices (all of
    them by default), or over an explicit list of devices (which may
    repeat one device: n shards computed in turn on it); not both."""
    if devices is not None and n_devices is not None:
        raise ValueError("make_mesh: give a count or a list of devices, "
                         "not both")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible")
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} devices asked for, {count} "
                             "visible")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devs = tuple(torch.device(d) for d in devices)
        if not devs or len({d.type for d in devs}) != 1:
            raise ValueError("make_mesh: needs at least one device, all of "
                             "one type")
        if devs[0].type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA devices asked for, none "
                               "visible")
    return Mesh(devs)


# -- production-path mesh context -------------------------------------------
# `use_mesh` makes the pipeline's alignment dispatches
# (ops/align_torch.banded_align_dispatch) shard their batches over the mesh.

_ACTIVE: list[Mesh] = []
_UNSET = object()
_AUTO: Mesh | None | object = _UNSET
_AUTO_LOCK = threading.Lock()


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh(device) -> Mesh | None:
    """The mesh a dispatch on ``device`` runs over, or None: the innermost
    :func:`use_mesh`, else the automatic mesh unless ``LESV_TORCH_MESH`` is
    ``0``; only for a device without an index and of the mesh's type."""
    dev = torch.device(device)
    if dev.index is not None:
        return None
    if _ACTIVE:
        mesh = _ACTIVE[-1]
    elif os.environ.get("LESV_TORCH_MESH", "auto") == "0":
        return None
    else:
        mesh = _auto_mesh(dev)
    if mesh is None or mesh.devices[0].type != dev.type:
        return None
    return mesh


def _auto_mesh(dev: torch.device) -> Mesh | None:
    """A mesh over all visible cards when there is more than one (the
    multi-card path without explicit opt-in)."""
    global _AUTO
    if dev.type != "cuda":
        return None
    with _AUTO_LOCK:
        if _AUTO is _UNSET:
            n = torch.cuda.device_count()
            _AUTO = make_mesh(n) if n > 1 else None
        return _AUTO


def _cut(mesh: Mesh, x, dtype) -> list[torch.Tensor]:
    """``x`` (numpy or torch, batch first) as ``mesh.size`` equal
    contiguous shards, shard i on device i."""
    t = torch.as_tensor(x).to(dtype)
    B = t.shape[0]
    if B % mesh.size:
        raise ValueError(f"batch of {B} lanes is not a multiple of the "
                         f"mesh size {mesh.size}")
    n = B // mesh.size
    return [t[i * n : (i + 1) * n].contiguous().to(d, non_blocking=True)
            for i, d in enumerate(mesh.devices)]


@dataclass
class ShardedFill:
    """What :func:`mesh_fill` returns: per shard, in batch order,
    ``(dirs, score, end_i, end_b, ok)`` left on the shard's device."""

    shards: list[tuple]
    i16: bool

    def small(self):
        """(score, end_i, end_b, ok) of the whole batch on the host (waits
        for every device); the direction bytes stay where they are."""
        return tuple(torch.cat([sh[j].cpu() for sh in self.shards])
                     for j in (1, 2, 3, 4))


def mesh_fill(mesh: Mesh, q, s, qlen, slen, W: int, mode: str,
              cfg: AlignConfig, free_end: bool,
              force_i16: bool | None = None) -> ShardedFill:
    """Run the banded fill sharded over ``mesh`` (batch padded to a
    multiple of the mesh size by the caller).  The state type is decided
    once for the whole batch (:func:`align_torch.i16_ok` unless
    ``force_i16`` pins it) and every shard is filled with it."""
    i16 = align_torch._use_i16(torch.as_tensor(q).shape[1], W, cfg,
                               force_i16)
    parts = zip(_cut(mesh, q, torch.uint8), _cut(mesh, s, torch.uint8),
                _cut(mesh, qlen, torch.int32), _cut(mesh, slen, torch.int32))
    return ShardedFill(
        [align_torch.banded_fill(qi, si, qli, sli, W, mode, cfg, free_end,
                                 force_i16=i16)
         for qi, si, qli, sli in parts], i16)


def sharded_align_step(mesh: Mesh, W: int, mode: str,
                       cfg: AlignConfig | None = None):
    """Build a mesh-sharded alignment-fill step.

    step(q, s, qlen, slen) -> per-lane score, end_b, ok (host tensors in
    batch order) plus the totals merged over the shards: ok-lane count and
    score sum of the ok lanes, as Python ints.
    """
    cfg = cfg or AlignConfig()

    def step(q, s, qlen, slen):
        fill = mesh_fill(mesh, q, s, qlen, slen, W, mode, cfg,
                         free_end=False)
        # per-shard reductions queued on each device, summed on the host
        parts = [(ok.sum(), torch.where(ok, score, 0).sum())
                 for _, score, _, _, ok in fill.shards]
        score, _, end_b, ok = fill.small()
        n_ok = sum(int(n) for n, _ in parts)
        total_score = sum(int(t) for _, t in parts)
        return score, end_b, ok, n_ok, total_score

    return step


def sharded_seed_chain_step(mesh: Mesh, k: int,
                            M: int = 2048, J: int = 64,
                            seeding: SeedingConfig | None = None,
                            chain: ChainConfig | None = None):
    """Build a mesh-sharded seeding + chain-DP step, the device front half
    of the mapper (ops.seeding_torch + ops.chain_torch): reads cut on the
    batch axis, the k-mer index replicated once per device, per-shard
    best-chain statistics summed on the host.  On a card the chain scan is
    ``csrc/chain.cu``, launched on every device of the mesh.

    Returns step(codes, qlen, index) -> (f (B, M) and best (B,) host
    tensors in batch order, n_chained, score_sum as Python ints).  ``index``
    is the host :class:`KmerIndex` (its hashes are one int64 array here,
    not the two int32 limb arrays of the JAX step).
    """
    from lesv_tpu_torch.ops.chain_torch import chain_scan, sort_seeds_device
    from lesv_tpu_torch.ops.seeding_torch import (
        DeviceIndex,
        _seed_match_kernel,
        sampled_offsets_static,
    )

    seeding = seeding or SeedingConfig()
    chain = chain or ChainConfig()
    # (host index, one DeviceIndex per distinct device) of the live index
    replicas: list = []

    def replicate(index):
        if index.k != k:
            raise ValueError(f"index k-mer size {index.k} != step's {k}")
        if not replicas or replicas[0] is not index:
            replicas[:] = [index, {d: DeviceIndex(index, d)
                                   for d in dict.fromkeys(mesh.devices)}]
        return replicas[1]

    def step(codes, qlen, index):
        on = replicate(index)
        offs = torch.from_numpy(sampled_offsets_static(
            torch.as_tensor(codes).shape[1], k, seeding.query_stride,
            seeding).astype("int64"))
        outs = []
        for dev, c, ql in zip(mesh.devices, _cut(mesh, codes, torch.uint8),
                              _cut(mesh, qlen, torch.int64)):
            qoff, soff, valid, _ = _seed_match_kernel(
                c, ql, offs.to(dev), on[dev], seeding.max_query_kmer_occ, M)
            qs, ss, vs = sort_seeds_device(qoff, soff, valid)
            f, _, _ = chain_scan(qs, ss, vs, J, k, chain.max_dist_qry,
                                 chain.max_dist_ref, chain.max_band_width)
            best = torch.where(vs, f, 0).max(dim=1).values
            outs.append((f, best, (best >= chain.min_chain_score).sum(),
                         best.sum()))
        f = torch.cat([o[0].cpu() for o in outs])
        best = torch.cat([o[1].cpu() for o in outs])
        n_chained = sum(int(o[2]) for o in outs)
        score_sum = sum(int(o[3]) for o in outs)
        return f, best, n_chained, score_sum

    return step
