"""alga_tpu_torch runs without jax and without alga_tpu: it imports in a
process where neither can be imported and assembles there on the CPU, in
configuration A (the default run) and configuration B (error_rate=0.02,
ACLCS fallback on), also with the fused GCPS path and the device consensus
forced (ALGA_GCPS_DEVICE=small, ALGA_DEVICE_CONSENSUS=1); without CUDA it
refuses to pick a device on its own; and no file of it, nor chip_smoke.py,
imports jax or alga_tpu."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from alga_tpu.config import AssemblyConfig
from alga_tpu_torch import pipeline

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

_NOJAX = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now fails
sys.modules["alga_tpu"] = None       # and any import of alga_tpu
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(2)
import alga_tpu_torch
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
assert sys.modules["jax"] is None and sys.modules["alga_tpu"] is None
loaded = [m for m in sys.modules
          if m.startswith(("jax.", "jaxlib", "alga_tpu."))]
assert not loaded, loaded
print("NOJAX_OK", len(res.contigs))
"""


@pytest.mark.parametrize("forced", [False, True], ids=["default", "forced"])
def test_import_and_assemble_without_jax(forced):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("ALGA_GCPS_DEVICE", "ALGA_DEVICE_CONSENSUS"):
        env.pop(k, None)
    if forced:
        env.update(ALGA_GCPS_DEVICE="small", ALGA_DEVICE_CONSENSUS="1")
    out = subprocess.run([sys.executable, "-c", _NOJAX.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, env=env,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NOJAX_OK" in out.stdout


def test_assemble_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.assemble(AssemblyConfig(), file1_seqs=["ACGT" * 30])


def test_no_jax_import_in_the_port():
    """Neither jax nor alga_tpu (the name alone, or a module of it) is
    imported by a file of the port or by chip_smoke.py."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|alga_tpu)(?![\w])", re.M)
    files = [*(ROOT / "alga_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    bad = [str(p) for p in files if pat.search(p.read_text())]
    assert not bad, f"jax or alga_tpu imported in {bad}"
    assert pat.search("from alga_tpu.core import packing")
    assert pat.search("import alga_tpu")
    assert not pat.search("from alga_tpu_torch import native")
