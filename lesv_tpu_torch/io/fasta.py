"""FASTA/FASTQ readers and writers.

Replaces the reference's gz-capable buffered readers with format sniffing
(`corelib/fasta.c`, `corelib/line_reader.c`).  Sequences are returned as
numpy uint8 code arrays (A=0 C=1 G=2 T=3, ambiguous=4) — the same residue
encoding the reference uses on top of its 2-bit pack (`corelib/hbn_aux.h`).
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, Tuple

import numpy as np

# Residue codes. 0..3 = ACGT, 4 = ambiguous (N etc).
CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4

_ENCODE = np.full(256, CODE_N, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _ENCODE[ord(_c)] = _i
    _ENCODE[ord(_c.lower())] = _i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_seq(s: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 codes."""
    if isinstance(s, str):
        s = s.encode()
    return _ENCODE[np.frombuffer(s, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string."""
    return _DECODE[codes].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (N stays N)."""
    rc = codes[::-1]
    out = np.where(rc < 4, 3 - rc, rc).astype(np.uint8)
    return out


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_fastx(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, codes) from a FASTA or FASTQ file (optionally gzipped).

    Format is sniffed from the first character (reference
    `hbn_guess_db_format`).  Only the first whitespace-delimited token of the
    header is kept as the name.
    """
    with _open_text(path) as fh:
        first = fh.read(1)
    if not first:
        return
    with _open_text(path) as fh:
        if first == ">":
            yield from _read_fasta_records(fh)
        elif first == "@":
            while True:
                hdr = fh.readline()
                if not hdr:
                    break
                hdr = hdr.rstrip()
                seq = fh.readline().rstrip()
                fh.readline()  # +
                fh.readline()  # qual
                yield hdr[1:].split()[0], encode_seq(seq)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _read_fasta_records(fh) -> Iterator[Tuple[str, np.ndarray]]:
    name = None
    chunks: list[str] = []
    for line in fh:
        line = line.rstrip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                yield name, encode_seq("".join(chunks))
            name = line[1:].split()[0] if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield name, encode_seq("".join(chunks))


def read_fasta(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, codes) from a FASTA file (robust multi-line parser)."""
    with _open_text(path) as fh:
        yield from _read_fasta_records(fh)


def write_fasta(path: str, records, width: int = 80) -> None:
    """Write (name, codes) records to a FASTA file."""
    with open(path, "w") as fh:
        for name, codes in records:
            fh.write(f">{name}\n")
            s = decode_seq(np.asarray(codes, dtype=np.uint8))
            for i in range(0, len(s), width):
                fh.write(s[i : i + width])
                fh.write("\n")
