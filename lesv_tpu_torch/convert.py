"""State carried across from the JAX package, as plain data.

The port shares no class with ``lesv_tpu``.  What a caller built there (a
sequence store, a k-mer index, a configuration) crosses as numpy arrays
and dicts through the functions below; stage checkpoints cross as the
``.npz`` files both packages' ``pipeline.stages_io`` read and write.
Nothing here takes or returns a ``lesv_tpu`` object.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lesv_tpu_torch import config as _config
from lesv_tpu_torch.index.kmer_index import KmerIndex
from lesv_tpu_torch.io.seqstore import SeqStore


def seqstore_from_arrays(names, starts, packed, ambig) -> SeqStore:
    """A :class:`SeqStore` over the given names, per-sequence start
    offsets, 2-bit packed residues and (seq_id, start, length) ambiguous
    runs."""
    names = [str(n) for n in names]
    starts = np.ascontiguousarray(starts, np.int64)
    if len(starts) != len(names) + 1:
        raise ValueError(f"seqstore_from_arrays: {len(names)} names need "
                         f"{len(names) + 1} start offsets, got {len(starts)}")
    store = SeqStore(
        names=names, starts=starts,
        packed=np.ascontiguousarray(packed, np.uint8),
        ambig=np.ascontiguousarray(ambig, np.int64).reshape(-1, 3))
    store._name_to_id = {n: i for i, n in enumerate(names)}
    return store


def kmer_index_from_arrays(k, window, uniq_hash, start, positions,
                           subject_starts) -> KmerIndex:
    """A :class:`KmerIndex` over sorted distinct hashes, group starts,
    grouped uint32 positions and per-subject start offsets."""
    uniq_hash = np.ascontiguousarray(uniq_hash, np.int64)
    start = np.ascontiguousarray(start, np.int64)
    if len(start) != len(uniq_hash) + 1:
        raise ValueError("kmer_index_from_arrays: start must hold one more "
                         "entry than uniq_hash")
    return KmerIndex(
        k=int(k), window=int(window), uniq_hash=uniq_hash, start=start,
        positions=np.ascontiguousarray(positions, np.uint32),
        subject_starts=np.ascontiguousarray(subject_starts, np.int64))


_DEFAULTS = _config.LesvConfig()


def config_from_dict(d: dict, section: str | None = None):
    """The port's configuration from ``dataclasses.asdict`` of either
    package's: the whole :class:`LesvConfig`, or with ``section`` (for
    example ``"align"``) one of its parts from that part's dict.  Missing
    fields take their defaults; unknown fields raise."""
    d = dict(d)
    if section is not None:
        cls = type(getattr(_DEFAULTS, section))
        extra = set(d) - {f.name for f in dataclasses.fields(cls)}
        if extra:
            raise ValueError(f"{cls.__name__}: unknown fields "
                             f"{sorted(extra)}")
        return cls(**d)
    cfg = _config.LesvConfig(num_threads=int(d.pop("num_threads", 0)))
    for name, sub in d.items():
        if not dataclasses.is_dataclass(getattr(_DEFAULTS, name, None)):
            raise ValueError(f"LesvConfig: unknown section {name!r}")
        setattr(cfg, name, config_from_dict(sub, name))
    return cfg
