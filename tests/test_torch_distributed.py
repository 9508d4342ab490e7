"""The port's distributed layer on 2 and 3 gloo ranks against alga_tpu,
exactly: the sharded ingest (io/multihost), gathered, against
alga_tpu.io.fastx.load_read_batch; `assemble_distributed` (rank 0's FASTA
byte-identical to alga_tpu's assemble_to_file, the other ranks' results
empty and unwritten) in configuration A, paired and unpaired, and B (its
gathered route); `pipeline.assemble(mesh=...)` in A, in B with ACLER
(through `ach_batch_mesh`) and in B with the ACLCS fallback.  Also the
named errors of the inputs the mesh route refuses, and the
`sharded_gcps` switch of the one-device pipeline."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from alga_tpu.config import AssemblyConfig
from alga_tpu.io import fastx
from alga_tpu.pipeline import assemble_to_file
from alga_tpu_torch import pipeline
from alga_tpu_torch.config import AssemblyConfig as TConfig
from alga_tpu_torch.io import multihost
from alga_tpu_torch.parallel import mesh as mesh_mod
from alga_tpu_torch.parallel import sharded_gcps
from tests.simulate import random_genome, simulate_paired
from tests.test_torch_mesh import run_ranks

torch.set_num_threads(2)

CONFIGS = {"A": {}, "B": dict(error_rate=0.02),
           "B_lcs": dict(error_rate=0.02, use_acler_instead_of_aclcs=False)}


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """FASTQ mates of a 4.4 kb genome with a 400 bp repeat (several
    contigs): error-free (A) and with 1% substitutions (B), an odd
    record count; also 20-base reads and unrelated random reads."""
    tmp = tmp_path_factory.mktemp("dist_files")
    rng = np.random.default_rng(3)
    rep = random_genome(rng, 400)
    genome = (random_genome(rng, 1200) + rep + random_genome(rng, 1200)
              + rep + random_genome(rng, 1200))
    for name, err in (("a", 0.0), ("b", 0.01)):
        r1, r2 = simulate_paired(genome, rng, read_len=100, insert=300,
                                 coverage=30, error_rate=err)
        _write_fastq(tmp / f"{name}1.fastq", r1[:-1])
        _write_fastq(tmp / f"{name}2.fastq", r2[:-1])
    _write_fastq(tmp / "short.fastq", [random_genome(rng, 20)
                                       for _ in range(40)])
    _write_fastq(tmp / "random.fastq", [random_genome(rng, 100)
                                        for _ in range(41)])
    return tmp


def _cfg(files, name, paired=True, **kw):
    return dict(file1=str(files / f"{name}1.fastq"),
                file2=str(files / f"{name}2.fastq") if paired else "", **kw)


def _alga_fasta(files, tag, cfg_kw):
    out = files / f"alga_{tag}.fasta"
    if not out.exists():
        assemble_to_file(AssemblyConfig(output=str(out), **cfg_kw))
    return out.read_bytes()


_BODY = r"""
import os
from alga_tpu_torch import pipeline
from alga_tpu_torch.config import AssemblyConfig
from alga_tpu_torch.graph import supplement
from alga_tpu_torch.io import output
from alga_tpu_torch.io.multihost import load_read_batch_distributed
from alga_tpu_torch.parallel.distributed import assemble_distributed

F = os.environ["DIST_FILES"]
d = mesh.d
f = lambda n: f"{F}/{n}.fastq"
for tag, files in (("paired", (f("a1"), f("a2"))),
                   ("single", (f("b1"), None))):
    pk, ln, vd, nrows = load_read_batch_distributed(mesh, *files)
    out[f"shard_{tag}"] = tuple(pk.shape)
    out[f"ingest_{tag}"] = tuple(
        mesh_mod.gather_all(mesh, x).numpy() for x in (pk, ln, vd)) + (nrows,)

for tag, kw in (("A_paired", dict(file1=f("a1"), file2=f("a2"))),
                ("A_single", dict(file1=f("a1"))),
                ("B_paired", dict(file1=f("b1"), file2=f("b2"),
                                  error_rate=0.02))):
    path = f"{F}/dist_{tag}_{d}_{rank}.fasta"
    res = assemble_distributed(AssemblyConfig(output=path, **kw), mesh)
    out[f"dist_{tag}"] = (open(path, "rb").read() if os.path.exists(path)
                          else None, len(res.contigs))

calls = []
real = supplement.ach_batch_mesh
def spy(*a, **k):
    calls.append(len(a[3]))
    return real(*a, **k)
supplement.ach_batch_mesh = spy
for tag, kw in (("A", {}), ("B", dict(error_rate=0.02)),
                ("B_lcs", dict(error_rate=0.02,
                               use_acler_instead_of_aclcs=False))):
    calls.clear()
    name = "a" if tag == "A" else "b"
    res = pipeline.assemble(AssemblyConfig(file1=f(name + "1"),
                                           file2=f(name + "2"), **kw),
                            mesh=mesh)
    path = f"{F}/mesh_{tag}_{d}_{rank}.fasta"
    output.write_contigs(res.contigs, path)
    out[f"mesh_{tag}"] = (open(path, "rb").read(), list(calls),
                          res.stats["counters"].get("ach_total_alignments", 0))

def error_of(**kw):
    try:
        assemble_distributed(AssemblyConfig(output=f"{F}/err.fasta", **kw),
                             mesh, write_output=False)
    except Exception as e:
        return type(e).__name__, str(e)
out["err_short"] = error_of(file1=f("short"), str_period_threshold=4)
out["err_quality"] = error_of(file1=f("random"))
"""


@pytest.fixture(scope="module", params=[2, 3], ids=["d2", "d3"])
def ranks(request, files, tmp_path_factory):
    d = request.param
    return d, run_ranks(tmp_path_factory.mktemp(f"dist{d}"), d, _BODY,
                        timeout=400, env={"DIST_FILES": str(files)})


@pytest.mark.parametrize("tag", ["paired", "single"])
def test_distributed_ingest_matches_alga_tpu(ranks, files, tag):
    d, outs = ranks
    name, paired = ("a", True) if tag == "paired" else ("b", False)
    want = fastx.load_read_batch(str(files / f"{name}1.fastq"),
                                 str(files / f"{name}2.fastq") if paired
                                 else None)
    n = len(want)
    step = 4 if paired else 2
    for o in outs:
        pk, ln, vd, nrows = o[f"ingest_{tag}"]
        assert nrows == n and len(pk) % (d * step) == 0
        assert o[f"shard_{tag}"] == (len(pk) // d, want.packed.shape[1])
        np.testing.assert_array_equal(pk.view(np.uint32)[:n], want.packed)
        np.testing.assert_array_equal(ln[:n], want.lengths)
        np.testing.assert_array_equal(vd[:n], want.valid)
        assert not vd[n:].any() and not ln[n:].any()


@pytest.mark.parametrize("tag", ["A_paired", "A_single", "B_paired"])
def test_assemble_distributed_matches_alga_tpu(ranks, files, tag):
    d, outs = ranks
    name, paired, kw = {"A_paired": ("a", True, {}),
                        "A_single": ("a", False, {}),
                        "B_paired": ("b", True, CONFIGS["B"])}[tag]
    want = _alga_fasta(files, tag, _cfg(files, name, paired, **kw))
    assert want.count(b">") >= 2
    fasta0, n0 = outs[0][f"dist_{tag}"]
    assert fasta0 == want and n0 == want.count(b">")
    for o in outs[1:]:
        fasta, n = o[f"dist_{tag}"]
        assert fasta is None and (n == 0 or tag == "B_paired")


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_assemble_on_mesh_matches_alga_tpu(ranks, files, tag):
    """Every rank writes alga_tpu's bytes; B's ACLER supplement verifies
    its pairs through ach_batch_mesh, B_lcs through ach_batch_auto."""
    d, outs = ranks
    want = _alga_fasta(files, f"mesh_{tag}", _cfg(
        files, "a" if tag == "A" else "b", **CONFIGS[tag]))
    for o in outs:
        fasta, calls, n_ach = o[f"mesh_{tag}"]
        assert fasta == want
        if tag == "B":
            assert calls and sum(calls) == n_ach > 0
        else:
            assert calls == []
    if tag == "B_lcs":
        assert outs[0][f"mesh_{tag}"][2] > 0


def test_short_reads_raise_a_named_error(ranks, files):
    """Reads under 16 bases after trimming reach the sharded marking only
    with a lower STR threshold; every rank raises ShortReadError."""
    d, outs = ranks
    for o in outs:
        assert o["err_short"][0] == "ShortReadError"


def test_no_valid_read_raises_data_quality_error(ranks, files):
    """Unrelated reads leave no valid read after simplification: every
    rank raises DataQualityError, as the one-device pipeline does."""
    d, outs = ranks
    for o in outs:
        assert o["err_quality"][0] == "DataQualityError"
    with pytest.raises(pipeline.DataQualityError):
        pipeline.assemble(TConfig(file1=str(files / "random.fastq")),
                          device="cpu")


def test_pfasta_raises_a_named_error(tmp_path):
    """The sharded ingest refuses an interleaved .pfasta file by name,
    before any exchange."""
    path = tmp_path / "reads.pfasta"
    path.write_text(">a\nACGTACGTACGTACGTACGT\n>b\nTTTTACGTACGTACGTAAAA\n")
    mesh = mesh_mod.Mesh(None, 0, 1, torch.device("cpu"))
    with pytest.raises(multihost.UnsupportedInputError, match="pfasta"):
        multihost.load_read_batch_distributed(mesh, str(path))


def test_sharded_gcps_on_runs_the_sharded_path(files, monkeypatch):
    """AssemblyConfig(sharded_gcps="on") builds the graph through
    parallel.sharded_gcps (on a one-rank gloo mesh here) and writes the
    same bytes as "off"."""
    assert not dist.is_initialized()
    calls = []
    real = sharded_gcps.gcps_graph_sharded

    def spy(mesh, *a, **k):
        calls.append(mesh.d)
        return real(mesh, *a, **k)
    monkeypatch.setattr(sharded_gcps, "gcps_graph_sharded", spy)
    got = {}
    for mode in ("off", "on"):
        out = files / f"switch_{mode}.fasta"
        pipeline.assemble_to_file(TConfig(output=str(out), sharded_gcps=mode,
                                          **_cfg(files, "a")), device="cpu")
        got[mode] = out.read_bytes()
    assert calls == [1]
    assert got["on"] == got["off"] == _alga_fasta(files, "A_paired",
                                                  _cfg(files, "a"))
    assert not dist.is_initialized()


def test_sharded_gcps_on_leaves_no_process_group(files, tmp_path):
    """The one-rank group that sharded_gcps="on" makes for the GCPS phase
    is destroyed after it, so calls can follow one another; a group the
    caller made is used and left standing."""
    cfg = TConfig(output=str(tmp_path / "on.fasta"), sharded_gcps="on",
                  **_cfg(files, "a"))
    for _ in range(2):
        pipeline.assemble(cfg, device="cpu")
        assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        pipeline.assemble(cfg, device="cpu")
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
