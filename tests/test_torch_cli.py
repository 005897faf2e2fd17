"""The host-only subcommands of ``python -m lesv_tpu_torch`` (``config``,
``split``, ``view``, ``dump``) against ``python -m lesv_tpu`` on the same
inputs: the same bytes written and the same lines printed (modelled on
tests/test_cli.py).  Nothing here touches a device."""

import numpy as np
import pytest

from lesv_tpu.__main__ import main as jax_main
from lesv_tpu.io.fasta import write_fasta
from lesv_tpu_torch.__main__ import build_config, main, parse_cfg


def _both(capsys, argv_of):
    """Run one subcommand through both CLIs; (stdout, stdout) of the port
    and of lesv_tpu.  ``argv_of(tag)`` builds the argument list with
    output paths that carry ``tag``."""
    outs = []
    for tag, fn in (("torch", main), ("jax", jax_main)):
        capsys.readouterr()
        fn(argv_of(tag))
        outs.append(capsys.readouterr().out)
    return outs


def _reads(seed, sizes, amb=False):
    rng = np.random.default_rng(seed)
    recs = []
    for i, n in enumerate(sizes):
        r = rng.integers(0, 4, n).astype(np.uint8)
        if amb:
            r[rng.random(n) < 0.01] = 4
        recs.append((f"r{i} extra words", r))
    return recs


def test_config_writes_the_same_template(tmp_path, capsys):
    got, want = _both(capsys, lambda t: ["config", str(tmp_path / f"{t}.cfg")])
    assert (tmp_path / "torch.cfg").read_bytes() == \
        (tmp_path / "jax.cfg").read_bytes()
    assert got == want.replace("jax.cfg", "torch.cfg")
    assert got.startswith("wrote template to ")
    kv = parse_cfg(str(tmp_path / "torch.cfg"))
    assert kv["MAX_SUBSEQ_SIZE"] == "50000" and kv["THREADS"] == "4"
    kv["MAP_OPTIONS"] = "-kmer_size 19 -kmer_window 20"
    kv["SVR_MIN_SVE_PERC_IDENTITY"] = "80.0"
    cfg = build_config(kv)
    assert (cfg.index.kmer_size, cfg.index.kmer_window) == (19, 20)
    assert cfg.sv_read.min_ident_perc == 80.0


@pytest.mark.parametrize("extra", [
    [], ["--seg-len", "30000", "--ovlp-len", "500", "--min-last", "5000"]])
def test_split_writes_the_same_bytes(tmp_path, capsys, extra):
    inp = tmp_path / "in.fa"
    write_fasta(str(inp), _reads(0, [120_000, 61_000, 900]))
    got, want = _both(capsys, lambda t: ["split", str(inp),
                                         str(tmp_path / f"{t}.fa")] + extra)
    out = (tmp_path / "torch.fa").read_bytes()
    assert out == (tmp_path / "jax.fa").read_bytes()
    assert got == want == ""
    # 120k -> 50k + 50k + 20k, 61k whole (an 11k tail is merged), 900 whole
    assert out.count(b">") == (5 if not extra else 7)


@pytest.mark.parametrize("sizes", [[120_000, 61_000, 900, 20_000], []])
def test_view_prints_the_same_lines(tmp_path, capsys, sizes):
    inp = tmp_path / "in.fa"
    write_fasta(str(inp), _reads(1, sizes))
    got, want = _both(capsys, lambda t: ["view", str(inp)])
    assert got == want
    lines = got.splitlines()
    assert lines[0] == f"sequences: {len(sizes)}"
    assert lines[1] == f"residues:  {sum(sizes)}"
    assert len(lines) == (6 if sizes else 2)
    if sizes:
        assert lines[2] == "max:       120000" and "N50:" in lines[5]


def test_dump_writes_the_same_bytes(tmp_path, capsys):
    inp = tmp_path / "in.fa"
    recs = _reads(3, [100, 2_345, 81], amb=True)
    write_fasta(str(inp), recs)
    got, want = _both(capsys, lambda t: ["dump", str(inp),
                                         str(tmp_path / f"{t}.fa")])
    out = (tmp_path / "torch.fa").read_bytes()
    assert out == (tmp_path / "jax.fa").read_bytes()
    assert got == want == ""
    from lesv_tpu_torch.io.fasta import read_fastx

    back = list(read_fastx(str(tmp_path / "torch.fa")))
    assert [n for n, _ in back] == ["r0", "r1", "r2"]
    for (_, a), (_, b) in zip(back, recs):
        np.testing.assert_array_equal(a, b)


def test_host_subcommands_take_no_device(tmp_path):
    with pytest.raises(SystemExit):
        main(["view", str(tmp_path / "x.fa"), "--device", "cpu"])
