"""alga_tpu_torch runs without jax and without alga_tpu: it imports in a
process where neither can be imported and assembles there on the CPU, in
configuration A (the default run) and configuration B (error_rate=0.02,
ACLCS fallback on), with and without the native host engine (the same
contigs), also with the fused GCPS path and the device consensus
forced (ALGA_GCPS_DEVICE=small, ALGA_DEVICE_CONSENSUS=1), and through the
distributed driver on a one-rank gloo mesh; without CUDA it refuses to
pick a device on its own, for a mesh too, and a CUDA mesh refuses more
ranks than cards; and no file of it, nor chip_smoke.py, imports jax or
alga_tpu."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from alga_tpu.config import AssemblyConfig
from alga_tpu_torch import pipeline
from alga_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

_NOJAX = r"""
import os
import sys
sys.modules["jax"] = None            # any `import jax` now fails
sys.modules["alga_tpu"] = None       # and any import of alga_tpu
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(2)
import alga_tpu_torch
import alga_tpu_torch.native
from alga_tpu_torch.config import AssemblyConfig
from alga_tpu_torch.pipeline import assemble
from tests.simulate import random_genome, simulate_single
for name, kw, err in (
        ("A", dict(), 0.0),
        ("B", dict(error_rate=0.02, use_acler_instead_of_aclcs=False), 0.01)):
    rng = np.random.default_rng(9)
    genome = random_genome(rng, 3000)
    reads = simulate_single(genome, rng, read_len=100, coverage=25,
                            error_rate=err)
    res = assemble(AssemblyConfig(**kw), file1_seqs=reads, device="cpu")
    assert res.contigs, f"{{name}}: no contigs"
    if name == "B":
        assert res.stats["counters"]["ach_lcs_pairs"] > 0
    # the same run without the native host engine
    real_available = alga_tpu_torch.native.available
    alga_tpu_torch.native.available = lambda: False
    try:
        bare = assemble(AssemblyConfig(**kw), file1_seqs=reads, device="cpu")
    finally:
        alga_tpu_torch.native.available = real_available
    assert "contract_walk_native" not in bare.stats["phase_seconds"]
    assert ([(c.cid, c.seq) for c in bare.contigs]
            == [(c.cid, c.seq) for c in res.contigs]), name
from alga_tpu_torch.parallel.distributed import assemble_distributed
from alga_tpu_torch.parallel.mesh import make_mesh
path = os.path.join({tmp!r}, "reads.fastq")
with open(path, "w") as f:
    for i, r in enumerate(reads):
        f.write(f"@r{{i}}\n{{r}}\n+\n{{'I' * len(r)}}\n")
dres = assemble_distributed(
    AssemblyConfig(file1=path, output=os.path.join({tmp!r}, "d.fasta")),
    make_mesh("cpu"))
assert dres.contigs
assert sys.modules["jax"] is None and sys.modules["alga_tpu"] is None
loaded = [m for m in sys.modules
          if m.startswith(("jax.", "jaxlib", "alga_tpu."))]
assert not loaded, loaded
print("NOJAX_OK", len(res.contigs))
"""


@pytest.mark.parametrize("forced", [False, True], ids=["default", "forced"])
def test_import_and_assemble_without_jax(forced, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("ALGA_GCPS_DEVICE", "ALGA_DEVICE_CONSENSUS"):
        env.pop(k, None)
    if forced:
        env.update(ALGA_GCPS_DEVICE="small", ALGA_DEVICE_CONSENSUS="1")
    out = subprocess.run([sys.executable, "-c", _NOJAX.format(root=str(ROOT),
                                                           tmp=str(tmp_path))],
                         capture_output=True, text=True, timeout=300, env=env,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NOJAX_OK" in out.stdout


def test_assemble_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.assemble(AssemblyConfig(), file1_seqs=["ACGT" * 30])


def test_make_mesh_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_mesh()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs CUDA")
def test_cuda_mesh_refuses_more_ranks_than_cards(monkeypatch):
    """NCCL takes one card per rank: a world larger than the cards raises
    before any process group is made."""
    monkeypatch.setenv("WORLD_SIZE", str(torch.cuda.device_count() + 1))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29555")
    with pytest.raises(RuntimeError, match="one card per rank"):
        mesh_mod.make_mesh("cuda")
    assert not torch.distributed.is_initialized()


# the engine-free functions and the files that define them
ENGINE_FREE = {
    "alga_tpu_torch/graph/prefsuf.py": (
        "OverlapMatches", "find_exact_overlaps", "_regime1_ring_survivors",
        "gcps_from_matches"),
    "alga_tpu_torch/graph/supplement.py": (
        "li_kmers", "_canonical_runs", "_gen_candidate_pairs",
        "_replay_runs", "_replay_runs_auto"),
    "alga_tpu_torch/ops/hashes.py": (
        "np_window_kmer_keys", "combine_keys", "window_keys"),
    "alga_tpu_torch/ops/bitops.py": (
        "np_substr_equal_batch", "substr_equal_auto"),
    "alga_tpu_torch/native.py": ("join_ranges",),
    "alga_tpu_torch/pipeline.py": ("SupplementAdj",),
    "alga_tpu_torch/utils/serialize.py": ("save_checkpoint",
                                          "load_checkpoint"),
}


def test_no_jax_import_in_the_port():
    """Neither jax nor alga_tpu (the name alone, or a module of it) is
    imported by a file of the port, its mesh layer and its engine-free
    functions included, or by chip_smoke.py."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|alga_tpu)(?![\w])", re.M)
    files = [*(ROOT / "alga_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    names = {str(p.relative_to(ROOT)) for p in files}
    for mod in ("mesh", "sharded_gcps", "sharded_preprocess",
                "sharded_simplify", "sharded_contract", "distributed"):
        assert f"alga_tpu_torch/parallel/{mod}.py" in names
    assert "alga_tpu_torch/io/multihost.py" in names
    for path, funcs in ENGINE_FREE.items():
        assert path in names
        text = (ROOT / path).read_text()
        for fn in funcs:
            assert re.search(rf"^(def|class) {fn}\b", text, re.M), (path, fn)
    bad = [str(p) for p in files if pat.search(p.read_text())]
    assert not bad, f"jax or alga_tpu imported in {bad}"
    assert pat.search("from alga_tpu.core import packing")
    assert pat.search("import alga_tpu")
    assert not pat.search("from alga_tpu_torch import native")
