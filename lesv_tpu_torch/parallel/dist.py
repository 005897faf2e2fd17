"""Multi-host distributed pipeline (reference `-grid node_id num_nodes`).

The reference shards query volumes across nodes with no IPC — results meet
on a shared filesystem (`app/map/main.c:35-55`).  The TPU-native layout:

* every host runs map -> sv_reads -> signatures on a strided shard of the
  reads (the reference's volume striding);
* SV-read metadata + signatures (small: ~KBs/Mb of genome) are all-gathered
  across hosts;
* grouping is deterministic on the gathered set; groups are then sharded
  by group_id and each host runs consensus -> remap on its groups (group
  member reads are part of the gathered SV-read payload, so no further
  exchange is needed);
* remap results are gathered; host 0 calls and emits the VCF.

The exchange is abstracted so tests can simulate N hosts in one process
(`SimExchange`); between real processes `TorchExchange` rides
``torch.distributed.all_gather`` in a process group the caller has
initialised.  Counterpart of :mod:`lesv_tpu.parallel.dist`; every host
runs its shard on ``device`` (each of its fills over the host's mesh when
one is active, :mod:`lesv_tpu_torch.parallel.mesh`).
"""

from __future__ import annotations

import io
import pickle
from dataclasses import dataclass

import numpy as np

from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.index.kmer_index import KmerIndex
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.io.vcf import VcfCall
from lesv_tpu_torch.pipeline.caller import call_svs
from lesv_tpu_torch.pipeline.cns import cns_groups
from lesv_tpu_torch.pipeline.grouping import group_signatures
from lesv_tpu_torch.pipeline.mapper import map_all
from lesv_tpu_torch.pipeline.remap import remap_all
from lesv_tpu_torch.pipeline.signatures import extract_signatures
from lesv_tpu_torch.pipeline.sv_reads import TrfMask, select_sv_reads


class Exchange:
    """All-gather of opaque byte payloads across hosts."""

    def allgather(self, payload: bytes) -> list[bytes]:
        raise NotImplementedError

    @property
    def host_id(self) -> int:
        raise NotImplementedError

    @property
    def n_hosts(self) -> int:
        raise NotImplementedError


class LocalExchange(Exchange):
    """Single host."""

    def allgather(self, payload: bytes) -> list[bytes]:
        return [payload]

    host_id = 0
    n_hosts = 1


class TorchExchange(Exchange):
    """Real multi-process exchange over ``torch.distributed``.

    The caller initialises the process group (address, world size and
    rank are its business); without one the constructor raises.  The
    payloads are pickled host records, so they travel as CPU ``int64`` /
    ``uint8`` tensors: the group needs a backend that moves host tensors
    (gloo does on any machine)."""

    def __init__(self):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("TorchExchange: torch.distributed has no "
                               "initialised process group")
        self._pid = dist.get_rank()
        self._n = dist.get_world_size()

    @staticmethod
    def pad_to(payload: bytes, maxlen: int) -> np.ndarray:
        buf = np.zeros(maxlen, np.uint8)
        buf[: len(payload)] = np.frombuffer(payload, np.uint8)
        return buf

    @staticmethod
    def unpad(gathered: np.ndarray, lens: np.ndarray,
              n_hosts: int) -> list[bytes]:
        g = np.asarray(gathered).reshape(n_hosts, -1)
        lens = np.asarray(lens).reshape(-1)
        return [g[i, : int(lens[i])].tobytes() for i in range(n_hosts)]

    def _gather(self, t):
        import torch
        import torch.distributed as dist

        out = [torch.empty_like(t) for _ in range(self._n)]
        dist.all_gather(out, t)
        return torch.stack(out).numpy()

    def allgather(self, payload: bytes) -> list[bytes]:
        import torch

        # length-prefix and pad to the max length across hosts
        lens = self._gather(torch.tensor([len(payload)], dtype=torch.int64))
        maxlen = int(np.max(lens))
        gathered = self._gather(
            torch.from_numpy(self.pad_to(payload, maxlen)))
        return self.unpad(gathered, lens, self._n)

    @property
    def host_id(self) -> int:
        return self._pid

    @property
    def n_hosts(self) -> int:
        return self._n


def shard_strided(n: int, host_id: int, n_hosts: int) -> list[int]:
    """Reference grid striding: node i takes items i, i+N, ... ."""
    return list(range(host_id, n, n_hosts))


def _pack_codes(codes: np.ndarray):
    """2-bit pack for the exchange (4x smaller than raw codes);
    ambiguous positions (code >= 4) are carried as an index list."""
    amb = np.flatnonzero(codes >= 4).astype(np.int64)
    c = np.where(codes >= 4, 0, codes).astype(np.uint8)
    pad = (-len(c)) % 4
    if pad:
        c = np.pad(c, (0, pad))
    packed = (c[0::4] << 6) | (c[1::4] << 4) | (c[2::4] << 2) | c[3::4]
    return packed, len(codes), amb


def _unpack_codes(packed: np.ndarray, n: int, amb: np.ndarray) -> np.ndarray:
    out = np.empty((len(packed), 4), np.uint8)
    out[:, 0] = (packed >> 6) & 3
    out[:, 1] = (packed >> 4) & 3
    out[:, 2] = (packed >> 2) & 3
    out[:, 3] = packed & 3
    codes = out.reshape(-1)[:n].copy()
    codes[amb] = 4
    return codes


@dataclass
class _ShardPayload:
    sv_reads: list
    signatures: list
    read_seqs: dict      # global (host, local) read id -> (name, packed)
    raw_spans: list      # (sid, soff, send) best-M4 span per mapped read


def distributed_call(
    ref_records,
    read_records,
    cfg: LesvConfig | None = None,
    exchange: Exchange | None = None,
    trf_intervals=None,
    device="cuda",
) -> list[VcfCall]:
    """Run the full pipeline with reads sharded across hosts, each host's
    device work on ``device``.

    Deterministic: the gathered signature set (and hence grouping, calls)
    is independent of the number of hosts.
    """
    cfg = cfg or LesvConfig()
    ex = exchange or LocalExchange()
    sstore = SeqStore.from_records(ref_records)
    index = KmerIndex.build(sstore, cfg.index)
    trf = TrfMask(sstore, trf_intervals) if trf_intervals else None

    # reference grid semantics: node i takes query VOLUMES i, i+N, ...
    # (`app/map/main.c:35,41,55`; volume size = -max_query_vol_res).
    # When the read set packs into fewer volumes than hosts, stride
    # individual reads instead so every host contributes (outputs are
    # sharding-invariant either way — signatures merge globally).
    from lesv_tpu_torch.pipeline.mapper import query_volumes

    vols = query_volumes([len(r) for _, r in read_records],
                         cfg.map.max_query_vol_res)
    if len(vols) >= ex.n_hosts:
        my_vols = shard_strided(len(vols), ex.host_id, ex.n_hosts)
        my_ids = [i for v in my_vols for i in vols[v]]
    else:
        my_ids = shard_strided(len(read_records), ex.host_id,
                               ex.n_hosts)
    my_reads = [read_records[i] for i in my_ids]

    m4s, qstore = map_all(my_reads, sstore, index, cfg, device=device)
    svrs = select_sv_reads(m4s, qstore, sstore, cfg, trf,
                           device=device)
    sigs = extract_signatures(svrs, qstore, sstore, cfg, trf,
                              device=device)

    # exchange: signatures + the (few) SV reads they reference, with
    # globally unique read keys "host:local"
    used_qids = sorted({s.qid for s in sigs})
    best_span: dict[int, tuple[int, int, int, int]] = {}
    for m in m4s:
        cur = best_span.get(m.qid)
        if cur is None or m.score > cur[0]:
            best_span[m.qid] = (m.score, m.sid, m.soff, m.send)
    payload = _ShardPayload(
        sv_reads=[(f"{ex.host_id}:{r.query_id}", r) for r in svrs],
        signatures=[(f"{ex.host_id}:{s.qid}", s) for s in sigs],
        read_seqs={f"{ex.host_id}:{qid}":
                   (qstore.name_of(qid), *_pack_codes(qstore.get(qid)))
                   for qid in used_qids},
        raw_spans=[(sid, so, se)
                   for _, sid, so, se in best_span.values()],
    )
    gathered = ex.allgather(pickle.dumps(payload))
    payloads = [pickle.loads(b) for b in gathered]

    # deterministic merged read universe
    all_seqs: dict[str, tuple[str, np.ndarray]] = {}
    for p in payloads:
        all_seqs.update(p.read_seqs)
    keys = sorted(all_seqs, key=lambda k: (int(k.split(":")[0]),
                                           int(k.split(":")[1])))
    key_to_gid = {k: i for i, k in enumerate(keys)}
    merged_store = SeqStore.from_records(
        [(all_seqs[k][0], _unpack_codes(*all_seqs[k][1:])) for k in keys])

    merged_sigs = []
    for p in payloads:
        for key, s in p.signatures:
            s2 = pickle.loads(pickle.dumps(s))
            s2.qid = key_to_gid[key]
            merged_sigs.append(s2)
    merged_sigs.sort(key=lambda g: (g.subject_id, g.kind, g.sfrom, g.qid))

    groups = group_signatures(merged_sigs, cfg)

    # shard groups across hosts; every host has the full merged read set
    my_groups = [groups[i] for i in
                 shard_strided(len(groups), ex.host_id, ex.n_hosts)]
    corrected = cns_groups(my_groups, merged_store, cfg, device=device)
    remapped = remap_all(corrected, sstore, cfg, device=device)

    gathered = ex.allgather(pickle.dumps(remapped))
    all_remapped = []
    for b in gathered:
        all_remapped.extend(pickle.loads(b))
    all_remapped.sort(key=lambda r: (r.subject_id, r.pos, r.name))
    all_spans = [t for p in payloads for t in p.raw_spans]
    return call_svs(all_remapped, sstore, cfg, raw_spans=all_spans)


class SimExchange(Exchange):
    """Simulates one host of an N-host run inside one process.

    Usage: the test runs the per-host function N times, collecting each
    host's payloads, then re-runs with the recorded payloads.  Simpler:
    `run_simulated` below drives it.
    """

    def __init__(self, host_id: int, n_hosts: int, mailbox: list):
        self._host_id = host_id
        self._n_hosts = n_hosts
        self._mailbox = mailbox  # list of per-round lists of payloads
        self._round = 0

    def allgather(self, payload: bytes) -> list[bytes]:
        rounds = self._mailbox
        if len(rounds) <= self._round:
            rounds.append([None] * self._n_hosts)
        rounds[self._round][self._host_id] = payload
        got = rounds[self._round]
        self._round += 1
        if any(x is None for x in got):
            raise _NeedMoreHosts()
        return list(got)

    @property
    def host_id(self) -> int:
        return self._host_id

    @property
    def n_hosts(self) -> int:
        return self._n_hosts


class PaddedSimExchange(Exchange):
    """A TorchExchange-shaped fake: routes every payload through the SAME
    length-prefix + pad-to-max + unpad path as the real exchange
    (TorchExchange.pad_to/unpad), with a SimExchange as the transport,
    so the padding logic is exercised without a process group."""

    def __init__(self, base: "SimExchange"):
        self._base = base

    def allgather(self, payload: bytes) -> list[bytes]:
        lens_b = self._base.allgather(
            np.int64(len(payload)).tobytes())
        lens = np.array([np.frombuffer(b, np.int64)[0] for b in lens_b])
        maxlen = int(lens.max())
        buf = TorchExchange.pad_to(payload, maxlen)
        gathered_b = self._base.allgather(buf.tobytes())
        stack = np.stack([np.frombuffer(b, np.uint8) for b in gathered_b])
        return TorchExchange.unpad(stack, lens, self.n_hosts)

    @property
    def host_id(self) -> int:
        return self._base.host_id

    @property
    def n_hosts(self) -> int:
        return self._base.n_hosts


class _NeedMoreHosts(Exception):
    pass


def run_simulated(fn, n_hosts: int):
    """Run `fn(exchange)` as n_hosts simulated hosts in one process.

    Hosts are re-executed in rounds until every allgather has all
    payloads (fn must be deterministic per host)."""
    mailbox: list = []
    results = [None] * n_hosts
    progress = True
    while progress:
        progress = False
        done = 0
        for h in range(n_hosts):
            ex = SimExchange(h, n_hosts, mailbox)
            try:
                results[h] = fn(ex)
                done += 1
            except _NeedMoreHosts:
                progress = True
        if done == n_hosts:
            return results
    raise RuntimeError("simulated exchange deadlock")
