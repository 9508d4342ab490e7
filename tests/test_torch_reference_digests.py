"""chip_smoke.py's digest constants against alga_tpu on the CPU.

On the card, chip_smoke.py holds every assembly it runs byte for byte
against alga_tpu's output through sha256 digests (REFERENCE_SHA256), and
its datasets against their recipe's (DATASET_SHA256): the card has no
jax.  This test recomputes each digest here, with alga_tpu on the JAX CPU
backend, on the datasets that chip_smoke.py builds: A and C through
alga_tpu's CLI in-process (the CLI's configuration), B through
alga_tpu.pipeline.assemble_to_file with chip_smoke.B_KW, all at 920k read
slots; A_40k and B_40k as chip_smoke.py's phase 10 runs them, and
B_40k_E16 and B_E16 as its phase 12 does (B_40k's and B's reads with a
band half-width of 16, chip_smoke.B_E16_KW).  When a recipe changes, the failure message prints the new digest.

    python -m pytest tests/test_torch_reference_digests.py -q   (~1 min)

The digests of alga_tpu's larger recipes (chip_smoke.FLAGSHIP: A_20M;
chip_smoke.CONFIG3: B_12M and C_12M) take minutes and about 5 GB each,
and those of the read-length recipes (chip_smoke.NOVASEQ150: A_150,
B_150, T_150; chip_smoke.MISEQ250: A_250, B_250) about two minutes
together, so they are marked slow and left out of `-m 'not slow'`:

    python -m pytest tests/test_torch_reference_digests.py -q -m slow
"""

import pytest

import chip_smoke
from alga_tpu import cli as jcli
from alga_tpu import pipeline as jpipeline
from alga_tpu.config import AssemblyConfig


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    """(A's and B's FASTQ paths) of chip_smoke.scale_datasets()."""
    paths = chip_smoke.scale_datasets(tmp_path_factory.mktemp("scale"))[1]
    return paths["A"], paths["B"]


@pytest.fixture(scope="module")
def large(tmp_path_factory):
    """{"F": paths, "G": paths} of the FLAGSHIP and CONFIG3 recipes."""
    out = tmp_path_factory.mktemp("large")
    return {**chip_smoke.scale_datasets(out, **chip_smoke.FLAGSHIP)[1],
            **chip_smoke.scale_datasets(out, **chip_smoke.CONFIG3)[1]}


@pytest.fixture(scope="module")
def read_lengths(tmp_path_factory):
    """{set: paths} of the NOVASEQ150 and MISEQ250 recipes."""
    out = tmp_path_factory.mktemp("read_lengths")
    return {**chip_smoke.scale_datasets(out, **chip_smoke.NOVASEQ150)[1],
            **chip_smoke.scale_datasets(out, **chip_smoke.MISEQ250)[1]}


@pytest.fixture(scope="module")
def reads_40k():
    """(clean, noisy) read lists of chip_smoke's 40k-read recipe."""
    reads = chip_smoke.bench_40k()[1]
    return reads, chip_smoke.noisy_40k(reads)


def _cli(paths, out, extra=()):
    assert jcli.main(["--file1", paths[0], "--file2", paths[1],
                      "--output", str(out), *extra]) == 0
    return chip_smoke.sha256_of(out)


def _run(case, scale, reads_40k, out):
    if case in ("A", "C"):
        a, b = scale
        return _cli(a if case == "A" else b, out,
                    chip_smoke.C_CLI_ARGS if case == "C" else ())
    if case in ("B", "B_E16"):
        b = scale[1]
        kw = chip_smoke.B_KW if case == "B" else chip_smoke.B_E16_KW
        jpipeline.assemble_to_file(AssemblyConfig(
            file1=b[0], file2=b[1], output=str(out), **kw))
    else:
        seqs, kw = {"A_40k": (reads_40k[0], {}),
                    "B_40k": (reads_40k[1], chip_smoke.B_KW),
                    "B_40k_E16": (reads_40k[1], chip_smoke.B_E16_KW)}[case]
        jpipeline.assemble_to_file(AssemblyConfig(output=str(out), **kw),
                                   file1_seqs=seqs)
    return chip_smoke.sha256_of(out)


def _same_digests(got: dict) -> None:
    want = {k: chip_smoke.DATASET_SHA256.get(k) for k in got}
    assert got == want, f"the recipes' digests are {got}"


@pytest.mark.parametrize("case", ["datasets", "A", "B", "C", "A_40k",
                                  "B_40k", "B_40k_E16", "B_E16"])
def test_reference_digest(request, tmp_path, case):
    if case == "datasets":
        a, b = request.getfixturevalue("scale")
        clean, noisy = request.getfixturevalue("reads_40k")
        got = {**chip_smoke.dataset_digests(a, b),
               "reads_40k": chip_smoke.sha256_of(clean),
               "reads_40k_B": chip_smoke.sha256_of(noisy)}
        assert len(got) == 6
        _same_digests(got)
        return
    scale = (request.getfixturevalue("scale") if "40k" not in case
             else None)
    reads = (request.getfixturevalue("reads_40k") if "40k" in case
             else None)
    got = _run(case, scale, reads, tmp_path / f"{case}.fasta")
    assert got == chip_smoke.REFERENCE_SHA256[case], (
        f"alga_tpu's {case} FASTA has sha256 {got}")


@pytest.mark.parametrize("noisy", [False, True])
def test_scale_datasets_parameters(tmp_path, noisy):
    """The recipe's parameters reach its draws, and `sets` only picks what
    is written: a one-set call at a small size writes the same bytes as
    the default two-set call's clean (A) or noisy (B) set."""
    kw = {"genome_len": 30_000, "coverage": 4, "seed": 9}
    genome, one, n = chip_smoke.scale_datasets(
        tmp_path / "one", **kw, sets=(("X", noisy),))
    genome2, both, n2 = chip_smoke.scale_datasets(tmp_path / "both", **kw)
    assert (n, n2, genome) == (2 * 600, 2 * 600, genome2)
    assert len(genome) == 30_000
    assert sorted(both) == ["A", "B"] and list(one) == ["X"]
    for x, ref in zip(one["X"], both["B" if noisy else "A"]):
        assert open(x, "rb").read() == open(ref, "rb").read()
    other = chip_smoke.scale_datasets(tmp_path / "seed", **{**kw, "seed": 10},
                                      sets=(("X", noisy),))[1]
    assert open(other["X"][0], "rb").read() != open(one["X"][0], "rb").read()


@pytest.mark.slow
@pytest.mark.parametrize("case", ["datasets", "A_20M", "B_12M", "C_12M"])
def test_large_reference_digest(large, tmp_path, case):
    """FLAGSHIP's FASTQ files through alga_tpu's CLI (A_20M), CONFIG3's
    through assemble_to_file with B_KW (B_12M) and the CLI with
    C_CLI_ARGS (C_12M)."""
    if case == "datasets":
        got = chip_smoke.dataset_digests(large["F"], large["G"])
        assert len(got) == 4
        _same_digests(got)
        return
    out = tmp_path / f"{case}.fasta"
    if case == "A_20M":
        got = _cli(large["F"], out)
    elif case == "C_12M":
        got = _cli(large["G"], out, chip_smoke.C_CLI_ARGS)
    else:
        g = large["G"]
        jpipeline.assemble_to_file(AssemblyConfig(
            file1=g[0], file2=g[1], output=str(out), **chip_smoke.B_KW))
        got = chip_smoke.sha256_of(out)
    assert got == chip_smoke.REFERENCE_SHA256[case], (
        f"alga_tpu's {case} FASTA has sha256 {got}")


@pytest.mark.parametrize("trimmed", [False, True])
def test_scale_datasets_read_length(tmp_path, trimmed):
    """read_len and insert reach the draws (fragments genome_len *
    coverage / (2 * read_len), mates of read_len bases), and a trimmed
    set is its untrimmed twin with each mate's 3' end cut to
    [read_len // 2, read_len] bases; adding a trimmed set leaves the
    other sets' bytes as they were."""
    kw = {"genome_len": 30_000, "coverage": 5, "seed": 9, "read_len": 150,
          "insert": 400}
    sets = (("X", True),) + ((("Y", True, True),) if trimmed else ())
    _, paths, n = chip_smoke.scale_datasets(tmp_path, **kw, sets=sets)
    assert n == 2 * 500
    alone = chip_smoke.scale_datasets(tmp_path / "alone", **kw,
                                      sets=(("X", True),))[1]
    for m in range(2):
        full = open(paths["X"][m], "rb").read()
        assert full == open(alone["X"][m], "rb").read()
        seqs = full.split(b"\n")[1::4]
        assert {len(x) for x in seqs} == {150}
        if trimmed:
            cut = open(paths["Y"][m], "rb").read().split(b"\n")
            assert [q for q in cut[3::4]] == [b"I" * len(x)
                                              for x in cut[1::4]]
            cut = cut[1::4]
            assert all(x.startswith(y) for x, y in zip(seqs, cut))
            lens = [len(y) for y in cut]
            assert min(lens) == 75 and max(lens) == 150


@pytest.mark.slow
@pytest.mark.parametrize("case", ["datasets", "A_150", "B_150", "T_150",
                                  "A_250", "B_250"])
def test_read_length_reference_digest(read_lengths, tmp_path, case):
    """NOVASEQ150's and MISEQ250's FASTQ files through alga_tpu's CLI (A)
    and through assemble_to_file with B_KW (B, T), with alga_tpu's ACLCS
    pair counts in the B runs."""
    if case == "datasets":
        got = chip_smoke.dataset_digests(*read_lengths.values())
        assert len(got) == 10
        _same_digests(got)
        return
    out = tmp_path / f"{case}.fasta"
    paths = read_lengths[case.replace("_", "")]
    if case.startswith("A"):
        got = _cli(paths, out)
    else:
        res = jpipeline.assemble_to_file(AssemblyConfig(
            file1=paths[0], file2=paths[1], output=str(out),
            **chip_smoke.B_KW))
        want = chip_smoke.ACH_READ_LENGTHS[case]
        assert {k: res.stats["counters"].get(k, 0) for k in want} == want
        got = chip_smoke.sha256_of(out)
    assert got == chip_smoke.REFERENCE_SHA256[case], (
        f"alga_tpu's {case} FASTA has sha256 {got}")
