"""The port's multi-host path (``lesv_tpu_torch.parallel.dist``) on the CPU
against ``lesv_tpu.parallel.dist``: the codecs, the padded exchange, a real
two-process ``TorchExchange`` over gloo, and ``distributed_call`` on the
60 kb world of tests/test_torch_stages.py, call for call (every field of
every ``VcfCall``, exact) and for 1 and 2 simulated hosts.  The 3-host and
mesh-inside-dist cases are marked slow.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from lesv_tpu.config import LesvConfig as JaxConfig
from lesv_tpu.parallel import dist as jax_dist
from lesv_tpu.sim import plant_svs, random_genome, simulate_reads
from lesv_tpu_torch import convert
from lesv_tpu_torch.parallel import dist
from lesv_tpu_torch.parallel.mesh import make_mesh, use_mesh

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _calls(calls):
    return [dataclasses.asdict(c) for c in calls]


def test_shard_strided():
    assert dist.shard_strided(10, 0, 3) == [0, 3, 6, 9]
    assert dist.shard_strided(10, 2, 3) == [2, 5, 8]
    ids = sorted(sum((dist.shard_strided(10, h, 3) for h in range(3)), []))
    assert ids == list(range(10))
    assert dist.shard_strided(10, 2, 3) == jax_dist.shard_strided(10, 2, 3)


@pytest.mark.parametrize("n", [0, 1, 4, 37, 1001])
def test_pack_codes_round_trip_with_ambiguous_bases(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.1] = 4
    packed, length, amb = dist._pack_codes(codes)
    jp, jl, ja = jax_dist._pack_codes(codes)
    np.testing.assert_array_equal(packed, jp)
    np.testing.assert_array_equal(amb, ja)
    assert length == jl == n and len(packed) == (n + 3) // 4
    back = dist._unpack_codes(packed, length, amb)
    np.testing.assert_array_equal(back, codes)
    assert back.dtype == np.uint8


def test_padded_exchange_codec_round_trip():
    payloads = [b"x" * 5, b"", b"hello world" * 100, b"\x00\xff" * 7]
    lens = np.array([len(p) for p in payloads], np.int64)
    stack = np.stack([dist.TorchExchange.pad_to(p, int(lens.max()))
                      for p in payloads])
    assert dist.TorchExchange.unpad(stack, lens, len(payloads)) == payloads
    np.testing.assert_array_equal(
        stack[2], jax_dist.JaxExchange.pad_to(payloads[2], int(lens.max())))


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_padded_sim_exchange_equals_sim_exchange(n_hosts):
    """Two rounds of unequal payloads: the length-prefix / pad / unpad path
    hands every host what the plain simulated exchange hands it."""
    def fn(wrap):
        def host(ex):
            ex = wrap(ex)
            a = ex.allgather(b"a" * (3 + 50 * ex.host_id))
            b = ex.allgather(pickle.dumps((ex.host_id, [len(x) for x in a])))
            return ex.host_id, ex.n_hosts, a, b
        return host

    plain = dist.run_simulated(fn(lambda ex: ex), n_hosts)
    padded = dist.run_simulated(fn(dist.PaddedSimExchange), n_hosts)
    assert padded == plain
    assert [r[0] for r in plain] == list(range(n_hosts))
    assert len(set(map(len, plain[0][2]))) == n_hosts


def test_torch_exchange_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        dist.TorchExchange()


RANK = """
import datetime, pickle, sys
import torch.distributed as td
from lesv_tpu_torch.parallel.dist import TorchExchange
rank = int(sys.argv[1])
td.init_process_group("gloo", init_method=sys.argv[2], world_size=2,
                      rank=rank, timeout=datetime.timedelta(seconds=60))
ex = TorchExchange()
first = ex.allgather(bytes([65 + rank]) * (7 + 4000 * rank))
second = ex.allgather(pickle.dumps([len(b) for b in first] + [rank]))
td.destroy_process_group()
sys.stdout.write(pickle.dumps((ex.host_id, ex.n_hosts, first, second)).hex())
"""


def test_torch_exchange_allgather_between_two_gloo_processes(tmp_path):
    """Two real processes, payloads of unequal length, two rounds.  Each
    wait has a time limit, so a hang fails here instead of stalling the
    suite."""
    env = dict(os.environ, PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'group'}"
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), init],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(tmp_path))
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(pickle.loads(bytes.fromhex(out)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want_first = [b"A" * 7, b"B" * 4007]
    for rank, (host_id, n_hosts, first, second) in enumerate(outs):
        assert (host_id, n_hosts) == (rank, 2)
        assert first == want_first
        assert [pickle.loads(b) for b in second] == [[7, 4007, 0],
                                                     [7, 4007, 1]]


# -- distributed_call on the 60 kb world -----------------------------------

@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(6)
    genome = random_genome(rng, 60_000)
    donor, truth = plant_svs(rng, genome, n_del=1, n_ins=1, min_len=80,
                             max_len=400, margin=15_000, min_gap=15_000)
    reads = simulate_reads(rng, donor, coverage=8.0, mean_len=3_000,
                           min_len=2_000, err=0.08)
    jcfg = JaxConfig()
    jcfg.cns.min_size = 1_000       # short synthetic reads
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    ref = [("chr1", genome)]
    single = dist.distributed_call(ref, reads, cfg,
                                   exchange=dist.LocalExchange(),
                                   device="cpu")
    return dict(ref=ref, reads=reads, truth=truth, jcfg=jcfg, cfg=cfg,
                single=single)


def test_distributed_call_equals_jax_call_for_call(world):
    want = jax_dist.distributed_call(world["ref"], world["reads"],
                                     world["jcfg"],
                                     exchange=jax_dist.LocalExchange())
    assert _calls(world["single"]) == _calls(want)
    for sv in world["truth"].svs:
        assert [c for c in world["single"]
                if c.kind == sv.kind and abs(c.pos - sv.ref_pos) <= 50], sv


def _simulated(world, n_hosts, wrap=lambda ex: ex, mesh=None):
    def host(ex):
        if mesh is None:
            return dist.distributed_call(world["ref"], world["reads"],
                                         world["cfg"], exchange=wrap(ex),
                                         device="cpu")
        with use_mesh(mesh):
            return dist.distributed_call(world["ref"], world["reads"],
                                         world["cfg"], exchange=wrap(ex),
                                         device="cpu")
    return dist.run_simulated(host, n_hosts)


def test_two_simulated_hosts_equal_the_single_host(world):
    """Reads strided over two hosts, through the padded exchange: every
    host returns the single host's calls, field for field."""
    multi = _simulated(world, 2, wrap=dist.PaddedSimExchange)
    assert len(multi) == 2 and world["single"]
    for res in multi:
        assert _calls(res) == _calls(world["single"])


@pytest.mark.slow
def test_three_simulated_hosts_equal_the_single_host(world):
    for res in _simulated(world, 3):
        assert _calls(res) == _calls(world["single"])


@pytest.mark.slow
def test_distributed_with_mesh_per_host(world):
    """mesh x dist: every host runs its shard with a 4-shard mesh active
    while signatures merge across hosts."""
    mesh = make_mesh(devices=[torch.device("cpu")] * 4)
    for res in _simulated(world, 2, mesh=mesh):
        assert _calls(res) == _calls(world["single"])
