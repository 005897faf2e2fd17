"""In-memory / on-disk sequence store and subread splitting.

TPU-native replacement for the reference seqdb (`corelib/seqdb.c`,
`corelib/build_db.c`): 2-bit packed residues, per-sequence offset table,
name<->id map, ambiguous-base runs recorded and re-substituted on extract.
Volume partitioning is replaced by streaming fixed-size read batches (the
out-of-core mechanism lives in the pipeline driver, not the store).

Subread splitting reproduces `app/split_seq/main.c:28-45`: reads longer than
``max_subseq_size`` are cut into pieces with the ``name_from_to`` renaming
convention; a final piece shorter than ``min_last_subseq_size`` is merged
into the previous one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from lesv_tpu_torch.config import SplitConfig
from lesv_tpu_torch.io.fasta import revcomp


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack uint8 codes (0..3; 4 mapped to 0) into 2-bit words, 4 per byte.

    Layout matches little-endian in-byte ordering: base i occupies bits
    (2*(i%4)) of byte i//4.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    codes = np.where(codes >= 4, 0, codes).astype(np.uint8)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    c = codes.reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return packed.astype(np.uint8)


def unpack_2bit(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_2bit`."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty((len(packed), 4), dtype=np.uint8)
    out[:, 0] = packed & 3
    out[:, 1] = (packed >> 2) & 3
    out[:, 2] = (packed >> 4) & 3
    out[:, 3] = (packed >> 6) & 3
    return out.reshape(-1)[:n]


def _ambig_runs(codes: np.ndarray) -> np.ndarray:
    """Return (start, length) runs of ambiguous (>=4) residues, shape (R, 2)."""
    amb = codes >= 4
    if not amb.any():
        return np.empty((0, 2), dtype=np.int64)
    d = np.diff(amb.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if amb[0]:
        starts = np.concatenate([[0], starts])
    if amb[-1]:
        ends = np.concatenate([ends, [len(codes)]])
    return np.stack([starts, ends - starts], axis=1)


@dataclass
class SeqStore:
    """2-bit packed sequence collection with O(1) random access by id.

    Mirrors the reference seqdb capabilities (`corelib/seqdb.h`): packed
    residues, CSeqInfo-style offsets, header blob, ambiguous runs.
    """

    names: List[str] = field(default_factory=list)
    starts: np.ndarray = field(default_factory=lambda: np.zeros(1, dtype=np.int64))
    packed: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.uint8))
    # ambiguous runs: (seq_id, start, length)
    ambig: np.ndarray = field(default_factory=lambda: np.empty((0, 3), dtype=np.int64))
    _name_to_id: dict = field(default_factory=dict, repr=False)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_records(cls, records: Iterable[Tuple[str, np.ndarray]]) -> "SeqStore":
        names: List[str] = []
        starts = [0]
        chunks: List[np.ndarray] = []
        ambig: List[Tuple[int, int, int]] = []
        total = 0
        for name, codes in records:
            codes = np.asarray(codes, dtype=np.uint8)
            sid = len(names)
            names.append(name)
            for s, l in _ambig_runs(codes):
                ambig.append((sid, int(s), int(l)))
            chunks.append(codes)
            total += len(codes)
            starts.append(total)
        # Pack the concatenation once; per-seq boundaries are bit offsets.
        allcodes = (
            np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8)
        )
        store = cls(
            names=names,
            starts=np.asarray(starts, dtype=np.int64),
            packed=pack_2bit(allcodes),
            ambig=np.asarray(ambig, dtype=np.int64).reshape(-1, 3),
        )
        store._name_to_id = {n: i for i, n in enumerate(names)}
        return store

    # -- stats -------------------------------------------------------------
    @property
    def num_seqs(self) -> int:
        return len(self.names)

    @property
    def total_res(self) -> int:
        return int(self.starts[-1])

    def seq_size(self, sid: int) -> int:
        return int(self.starts[sid + 1] - self.starts[sid])

    def name_of(self, sid: int) -> str:
        return self.names[sid]

    def id_of(self, name: str) -> int:
        return self._name_to_id[name]

    def sizes(self) -> np.ndarray:
        return np.diff(self.starts)

    # -- extraction --------------------------------------------------------
    def _unpacked_range(self, lo: int, hi: int) -> np.ndarray:
        """Unpack global residue range [lo, hi)."""
        blo, bhi = lo // 4, (hi + 3) // 4
        codes = unpack_2bit(self.packed[blo:bhi], (bhi - blo) * 4)
        return codes[lo - blo * 4 : lo - blo * 4 + (hi - lo)]

    def get(self, sid: int, start: int = 0, end: int | None = None,
            rc: bool = False, restore_ambig: bool = True) -> np.ndarray:
        """Extract subsequence codes [start, end) of sequence sid.

        ``rc=True`` returns the reverse complement of that subsequence
        (matching RawReadReader_ExtractSubRead direction semantics).
        """
        g0 = int(self.starts[sid])
        size = self.seq_size(sid)
        if end is None:
            end = size
        assert 0 <= start <= end <= size, (sid, start, end, size)
        codes = self._unpacked_range(g0 + start, g0 + end).copy()
        if restore_ambig and len(self.ambig):
            rows = self.ambig[self.ambig[:, 0] == sid]
            for _, s, l in rows:
                a = max(s, start) - start
                b = min(s + l, end) - start
                if a < b:
                    codes[a:b] = 4
        if rc:
            codes = revcomp(codes)
        return codes

    def n50(self) -> int:
        sizes = np.sort(self.sizes())[::-1]
        if not len(sizes):
            return 0
        half = sizes.sum() / 2
        return int(sizes[np.searchsorted(np.cumsum(sizes), half)])

    # -- on-disk form (reference seqdb volumes / RawReadReader role) -------
    def write(self, dirpath: str) -> None:
        """Persist to a directory; reopen with :meth:`open` (mmap)."""
        import os

        os.makedirs(dirpath, exist_ok=True)
        np.save(os.path.join(dirpath, "packed.npy"), self.packed)
        np.save(os.path.join(dirpath, "starts.npy"), self.starts)
        np.save(os.path.join(dirpath, "ambig.npy"), self.ambig)
        with open(os.path.join(dirpath, "names.txt"), "w") as fh:
            fh.write("\n".join(self.names))

    @classmethod
    def open(cls, dirpath: str, mmap: bool = True) -> "SeqStore":
        """Open an on-disk store; 2-bit residues stay memory-mapped so
        random access touches only the pages it needs (the reference's
        RawReadReader flagged-load mechanism becomes OS paging)."""
        import os

        mode = "r" if mmap else None
        packed = np.load(os.path.join(dirpath, "packed.npy"), mmap_mode=mode)
        starts = np.load(os.path.join(dirpath, "starts.npy"))
        ambig = np.load(os.path.join(dirpath, "ambig.npy"))
        with open(os.path.join(dirpath, "names.txt")) as fh:
            names = fh.read().split("\n") if os.path.getsize(
                os.path.join(dirpath, "names.txt")) else []
        st = cls(names=names, starts=starts, packed=packed, ambig=ambig)
        st._name_to_id = {n: i for i, n in enumerate(names)}
        return st


# -- subread splitting -----------------------------------------------------

def split_subreads(
    records: Iterable[Tuple[str, np.ndarray]],
    cfg: SplitConfig | None = None,
) -> Iterator[Tuple[str, np.ndarray]]:
    """Split raw reads into <= max_subseq_size subreads.

    Reproduces `app/split_seq/main.c:28-45`:
    - pieces are [i*L, (i+1)*L) with optional overlap extension;
    - a piece is renamed ``{name}_{from}_{to}`` (half-open, 0-based offsets);
    - if the final piece would be < min_last_subseq_size it is merged into
      the previous piece;
    - reads <= max size pass through unchanged (keeping their name).
    """
    cfg = cfg or SplitConfig()
    L = cfg.max_subseq_size
    for name, codes in records:
        n = len(codes)
        frm = 0
        while frm < n:
            to = min(frm + L, n)
            if n - to < cfg.min_last_subseq_size:
                to = n
            if frm == 0 and to == n:
                yield name, codes
            else:
                yield f"{name}_{frm}_{to}", codes[frm:to]
            frm = (to - cfg.overlap_size) if to < n else n


def subread_origin(name: str) -> Tuple[str, int, int] | None:
    """Parse a ``name_from_to`` subread name; None if not a split read."""
    parts = name.rsplit("_", 2)
    if len(parts) == 3:
        try:
            return parts[0], int(parts[1]), int(parts[2])
        except ValueError:
            return None
    return None
