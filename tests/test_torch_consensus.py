"""The port's device consensus (alga_tpu_torch/contig/device_consensus.py)
on the CPU against alga_tpu.contig.device_consensus.correct_all_device and
the host oracle consensus.correct_snips, on the recipe of
tests/test_contig.py:95-138 (many contigs, ragged reads, a fully trimmed
contig), plus a contig of no columns and a column with tied votes; and
the routing of alga_tpu_torch/contig/consensus.py."""

import pytest
import torch

from alga_tpu.contig import consensus as jconsensus
from alga_tpu.contig import device_consensus as jdc
from alga_tpu.contig.walk import Contig
from alga_tpu.core.seqbatch import SeqBatch
from alga_tpu_torch.contig import consensus
from alga_tpu_torch.contig.device_consensus import correct_all_device
from tests.test_contig import random_dna

torch.set_num_threads(2)


def _contigs(rng):
    """(reads, [(cid, [(read id, offset)])]) of 14 tiled contigs with
    SNPs, a contig of no columns between them, a tied column, and a
    single low-coverage read (fully trimmed)."""
    all_reads, layout = [], []
    for ci in range(14):
        g = random_dna(rng, int(rng.integers(60, 220)))
        reads, offsets = [], []
        pos, prev = 0, 0
        rl = int(rng.integers(25, 45))
        while pos + rl <= len(g):
            r = list(g[pos:pos + rl])
            if rng.random() < 0.4:
                i = int(rng.integers(0, rl))
                r[i] = "ACGT"[int(rng.integers(0, 4))]
            reads.append("".join(r))
            offsets.append(pos - prev)
            prev = pos
            pos += int(rng.integers(4, 18))
        if len(reads) < 2:
            continue
        offsets[0] = -1
        ids = range(len(all_reads), len(all_reads) + len(reads))
        all_reads.extend(reads)
        layout.append((ci, list(zip(ids, offsets))))
        if ci == 6:
            # a read of length 0: the contig has no columns and starts
            # where the next one does
            layout.append((50, [(len(all_reads), -1)]))
            all_reads.append("")
    # 8 reads over 40 columns; column 17 has 4 votes C and 4 votes G
    base = random_dna(rng, 40)
    for j in range(8):
        all_reads.append(base[:17] + "CG"[j % 2] + base[18:])
    layout.append((60, [(len(all_reads) - 8 + j, -1 if j == 0 else 0)
                        for j in range(8)]))
    all_reads.append(random_dna(rng, 30))
    layout.append((99, [(len(all_reads) - 1, -1)]))
    return all_reads, layout


def _make(layout):
    return [Contig(cid, "", list(reads)) for cid, reads in layout]


@pytest.mark.parametrize("chunk_reads", [64, 1 << 20])
def test_correct_all_device_matches_jax_and_host(rng, chunk_reads):
    reads, layout = _contigs(rng)
    batch = SeqBatch.from_strings(reads)
    got = _make(layout)
    correct_all_device(got, batch, chunk_reads=chunk_reads, device="cpu")
    jax_ctgs = _make(layout)
    jdc.correct_all_device(jax_ctgs, batch, chunk_reads=chunk_reads)
    host = _make(layout)
    for c in host:
        jconsensus.correct_snips(c, batch)
    seqs = [c.seq for c in got]
    assert seqs == [c.seq for c in jax_ctgs]
    assert seqs == [c.seq for c in host]
    by_id = {c.cid: c.seq for c in got}
    assert by_id[50] == "" and by_id[99] == ""
    assert by_id[60][17] == "C"          # the tie goes to the lower code
    assert sum(len(s) > 0 for s in seqs) >= 12


@pytest.mark.parametrize("device_consensus", [False, True])
def test_correct_all_routing(rng, monkeypatch, device_consensus):
    """ALGA_DEVICE_CONSENSUS selects the port's device twin; unset, the
    host pass runs; both give the host oracle's sequences."""
    reads, layout = _contigs(rng)
    batch = SeqBatch.from_strings(reads)
    calls = []
    monkeypatch.setattr(consensus, "correct_all_device",
                        lambda *a, **kw: calls.append(1)
                        or correct_all_device(*a, **kw))
    if device_consensus:
        monkeypatch.setenv("ALGA_DEVICE_CONSENSUS", "1")
    else:
        monkeypatch.delenv("ALGA_DEVICE_CONSENSUS", raising=False)
    got = _make(layout)
    consensus.correct_all(got, batch, device="cpu")
    assert calls == ([1] if device_consensus else [])
    want = _make(layout)
    monkeypatch.delenv("ALGA_DEVICE_CONSENSUS", raising=False)
    jconsensus.correct_all(want, batch)
    assert [c.seq for c in got] == [c.seq for c in want]
