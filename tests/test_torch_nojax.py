"""alga_tpu_torch runs without jax: it imports in a process where jax
cannot be imported and assembles there on the CPU, also with the fused
GCPS path and the device consensus forced (ALGA_GCPS_DEVICE=small,
ALGA_DEVICE_CONSENSUS=1); without CUDA it refuses to pick a device on its
own; and no file of it imports jax."""

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
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(2)
import alga_tpu_torch
from alga_tpu_torch.pipeline import AssemblyConfig, assemble
from tests.simulate import random_genome, simulate_single
rng = np.random.default_rng(9)
genome = random_genome(rng, 3000)
reads = simulate_single(genome, rng, read_len=100, coverage=25)
res = assemble(AssemblyConfig(), file1_seqs=reads, device="cpu")
assert res.contigs, "no contigs"
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith(("jax.", "jaxlib"))]
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
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    bad = [str(p) for p in (ROOT / "alga_tpu_torch").rglob("*.py")
           if pat.search(p.read_text())]
    assert not bad, f"jax imported in {bad}"
    assert not pat.search((ROOT / "chip_smoke.py").read_text())
