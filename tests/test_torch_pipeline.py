"""The port's assembly (alga_tpu_torch.pipeline.assemble, device="cpu")
against alga_tpu.pipeline.assemble on simulated genomes: byte-identical
contigs, paired and unpaired, in configuration A (the default CLI run,
error_rate=0) and configuration B (error_rate=0.02 with the ACLCS
banded-LCS fallback on), with the default routing and with the fused
GCPS path and device consensus forced (ALGA_GCPS_DEVICE=small,
ALGA_DEVICE_CONSENSUS=1, which both packages read).  In B the JAX side
also runs with its Pallas kernels in interpret mode
(ALGA_TPU_ENABLE_PALLAS=1).  Also: the same log lines, the host engine
alone under ALGA_GCPS_DEVICE=off, and the CLI's options and
--profile_dir."""

import numpy as np
import pytest
import torch

from alga_tpu import cli as jcli
from alga_tpu import pipeline as jpipeline
from alga_tpu.config import AssemblyConfig
from alga_tpu_torch import cli, pipeline
from alga_tpu_torch.contig import consensus
from alga_tpu_torch.graph import prefsuf
from tests.simulate import random_genome, simulate_paired, simulate_single

torch.set_num_threads(2)

CONFIGS = {
    "A": dict(),
    "B": dict(error_rate=0.02, use_acler_instead_of_aclcs=False),
}


def _reads(paired: bool, error_rate: float, seed: int = 3):
    """Reads of a 4.4 kb genome with a 400 bp repeat (several contigs)."""
    rng = np.random.default_rng(seed)
    rep = random_genome(rng, 400)
    genome = (random_genome(rng, 1200) + rep + random_genome(rng, 1200)
              + rep + random_genome(rng, 1200))
    if paired:
        r1, r2 = simulate_paired(genome, rng, read_len=100, insert=300,
                                 coverage=30, error_rate=error_rate)
        return dict(file1_seqs=r1, file2_seqs=r2)
    return dict(file1_seqs=simulate_single(genome, rng, read_len=100,
                                           coverage=30,
                                           error_rate=error_rate))


def _contigs(res):
    return [(c.cid, c.seq) for c in res.contigs]


ROUTES = {
    "default": {},
    "small_devcons": {"ALGA_GCPS_DEVICE": "small",
                      "ALGA_DEVICE_CONSENSUS": "1"},
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("config", ["A", "B"])
def test_assemble_matches_jax(config, paired, route, monkeypatch):
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    kw = _reads(paired, 0.01 if config == "B" else 0.0)
    cfg = AssemblyConfig(file2="x" if paired else "", **CONFIGS[config])
    got = pipeline.assemble(cfg, device="cpu", **kw)
    want = jpipeline.assemble(cfg, **kw)
    assert len(got.contigs) >= 2
    assert _contigs(got) == _contigs(want)
    if config == "B":
        assert got.cfg.use_supplement
        # pairs reached the port's banded LCS (its plain version on the CPU)
        assert got.stats["counters"]["ach_lcs_pairs"] > 0
        monkeypatch.setenv("ALGA_TPU_ENABLE_PALLAS", "1")
        assert _contigs(jpipeline.assemble(cfg, **kw)) == _contigs(got)


def _fastq_pair(tmp_path, seed):
    kw = _reads(True, 0.0, seed=seed)
    paths = []
    for name, seqs in (("r1.fastq", kw["file1_seqs"]),
                       ("r2.fastq", kw["file2_seqs"])):
        path = tmp_path / name
        path.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                                for i, s in enumerate(seqs)))
        paths.append(str(path))
    return ["--file1", paths[0], "--file2", paths[1], "--threads", "2"]


def test_cli_writes_identical_fasta(tmp_path):
    args = _fastq_pair(tmp_path, seed=4)
    assert cli.main(args + ["--output", str(tmp_path / "port.fasta"),
                            "--device", "cpu"]) == 0
    assert jcli.main(args + ["--output", str(tmp_path / "jax.fasta")]) == 0
    port = (tmp_path / "port.fasta").read_bytes()
    assert port.count(b">contig_id=") >= 2
    assert port == (tmp_path / "jax.fasta").read_bytes()


@pytest.mark.parametrize("devcons", [False, True], ids=["host", "devcons"])
@pytest.mark.parametrize("mode", ["wide", "off"])
def test_assemble_forced_routes(mode, devcons, monkeypatch):
    """ALGA_GCPS_DEVICE=wide|off, with and without device consensus, in
    configuration B on paired reads, against alga_tpu's default route
    (every route of alga_tpu gives the same graph and contigs); `off`
    never enters a device graph path."""
    kw = _reads(True, 0.01)
    cfg = AssemblyConfig(file2="x", **CONFIGS["B"])
    want = _contigs(jpipeline.assemble(cfg, **kw))
    monkeypatch.setenv("ALGA_GCPS_DEVICE", mode)
    if devcons:
        monkeypatch.setenv("ALGA_DEVICE_CONSENSUS", "1")
    if mode == "off":
        def refuse(*a, **kw):
            raise AssertionError("device GCPS entered under off")
        monkeypatch.setattr(prefsuf, "gcps_graph_device", refuse)
        monkeypatch.setattr(prefsuf, "gcps_graph_device_scale", refuse)
    calls = []
    real = consensus.correct_all_device
    monkeypatch.setattr(consensus, "correct_all_device",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = pipeline.assemble(cfg, device="cpu", **kw)
    assert len(calls) == int(devcons)
    assert len(got.contigs) >= 2
    assert _contigs(got) == want


def test_log_lines_match_jax(capsys):
    """The port logs alga_tpu's `config:` and post-simplifier degree
    lines, with the same text."""
    kw = _reads(False, 0.0)
    prefixes = ("config: ", "post-simplifier degree stats: ")

    def lines():
        err = capsys.readouterr().err.splitlines()
        return [ln for ln in err if ln.startswith(prefixes)]
    capsys.readouterr()
    pipeline.assemble(AssemblyConfig(), device="cpu", **kw)
    got = lines()
    jpipeline.assemble(AssemblyConfig(), **kw)
    assert [ln.split(" ", 1)[0] for ln in got] == ["config:",
                                                   "post-simplifier"]
    assert got == lines()


def test_cli_accepts_every_alga_tpu_option():
    port = cli.build_parser()._option_string_actions
    options = [o for a in jcli.build_parser()._actions
               for o in a.option_strings]
    assert "--profile_dir" in options
    assert [o for o in options if o not in port] == []


def test_cli_profile_dir_writes_a_trace(tmp_path):
    args = _fastq_pair(tmp_path, seed=5) + ["--device", "cpu"]
    trace_dir = tmp_path / "trace"
    assert cli.main(args + ["--output", str(tmp_path / "plain.fasta")]) == 0
    assert cli.main(args + ["--output", str(tmp_path / "prof.fasta"),
                            "--profile_dir", str(trace_dir)]) == 0
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert cli.TRACE_SPAN.encode() in traces[0].read_bytes()
    plain = (tmp_path / "plain.fasta").read_bytes()
    assert plain.count(b">contig_id=") >= 2
    assert (tmp_path / "prof.fasta").read_bytes() == plain
