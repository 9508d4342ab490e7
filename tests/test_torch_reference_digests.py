"""chip_smoke.py's digest constants against alga_tpu on the CPU.

On the card, chip_smoke.py holds every assembly it runs byte for byte
against alga_tpu's output through sha256 digests (REFERENCE_SHA256), and
its datasets against their recipe's (DATASET_SHA256): the card has no
jax.  This test recomputes each digest here, with alga_tpu on the JAX CPU
backend, on the datasets that chip_smoke.py builds: A and C through
alga_tpu's CLI in-process (the CLI's configuration), B through
alga_tpu.pipeline.assemble_to_file with chip_smoke.B_KW, all at 920k read
slots; A_40k and B_40k as chip_smoke.py's phase 10 runs them.  When a
recipe changes, the failure message prints the new digest.

    python -m pytest tests/test_torch_reference_digests.py -q   (~40 s)
"""

import pytest

import chip_smoke
from alga_tpu import cli as jcli
from alga_tpu import pipeline as jpipeline
from alga_tpu.config import AssemblyConfig


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    """(A's and B's FASTQ paths) of chip_smoke.scale_datasets()."""
    _genome, a, b, _n = chip_smoke.scale_datasets(
        tmp_path_factory.mktemp("scale"))
    return a, b


@pytest.fixture(scope="module")
def reads_40k():
    """(clean, noisy) read lists of chip_smoke's 40k-read recipe."""
    reads = chip_smoke.bench_40k()[1]
    return reads, chip_smoke.noisy_40k(reads)


def _run(case, scale, reads_40k, out):
    if case in ("A", "C"):
        a, b = scale
        paths = a if case == "A" else b
        extra = chip_smoke.C_CLI_ARGS if case == "C" else ()
        assert jcli.main(["--file1", paths[0], "--file2", paths[1],
                          "--output", str(out), *extra]) == 0
    elif case == "B":
        b = scale[1]
        jpipeline.assemble_to_file(AssemblyConfig(
            file1=b[0], file2=b[1], output=str(out), **chip_smoke.B_KW))
    else:
        seqs, kw = {"A_40k": (reads_40k[0], {}),
                    "B_40k": (reads_40k[1], chip_smoke.B_KW)}[case]
        jpipeline.assemble_to_file(AssemblyConfig(output=str(out), **kw),
                                   file1_seqs=seqs)
    return chip_smoke.sha256_of(out)


@pytest.mark.parametrize("case", ["datasets", "A", "B", "C", "A_40k",
                                  "B_40k"])
def test_reference_digest(request, tmp_path, case):
    if case == "datasets":
        a, b = request.getfixturevalue("scale")
        clean, noisy = request.getfixturevalue("reads_40k")
        got = {**chip_smoke.dataset_digests(a, b),
               "reads_40k": chip_smoke.sha256_of(clean),
               "reads_40k_B": chip_smoke.sha256_of(noisy)}
        assert got == chip_smoke.DATASET_SHA256
        return
    scale = (request.getfixturevalue("scale") if "40k" not in case
             else None)
    reads = (request.getfixturevalue("reads_40k") if "40k" in case
             else None)
    got = _run(case, scale, reads, tmp_path / f"{case}.fasta")
    assert got == chip_smoke.REFERENCE_SHA256[case], (
        f"alga_tpu's {case} FASTA has sha256 {got}")
