"""Sharded ingest, one block of the read store per rank (port of
alga_tpu/io/multihost.py; ref src/IO/InputReader.cpp:272-391, where T
threads each read every T-th record).

Every rank of a mesh:
  1. scans the input file(s) with the native pass-1 line count
     (native.fastx_scan), so all ranks agree on the record count and the
     longest record without talking;
  2. fills only the records whose rows land in its own block
     (native.fastx_fill_range);
  3. preprocesses and packs them with the fused native pass (trim, N drop,
     STR filter, reverse-complement interleave: the layout of
     fastx.load_read_batch);
  4. moves its block to its device.  No rank ever holds the whole store.

The blocks, gathered, equal fastx.load_read_batch on the same files, the
padding rows past `n_rows` aside.
"""

from __future__ import annotations

import numpy as np
import torch

from alga_tpu_torch import native
from alga_tpu_torch.core import packing
from alga_tpu_torch.io.fastx import detect_format
from alga_tpu_torch.parallel import mesh as mesh_mod
from alga_tpu_torch.store import words_as_int32


class UnsupportedInputError(ValueError):
    """An input the sharded ingest cannot split by records."""


def _scan(path: str):
    buf = np.fromfile(path, dtype=np.uint8)
    if len(buf) == 0:
        return buf, "my_input", 0, 0, None, 0
    fmt = detect_format(path)
    if fmt == "pfasta":
        raise UnsupportedInputError(
            f"{path}: the sharded ingest reads FASTQ, FASTA and one-read-per-"
            "line files; an interleaved .pfasta file needs the single-"
            "process pipeline (pipeline.assemble)")
    m, maxlen, meta, nch = native.fastx_scan(buf, fmt)
    return buf, fmt, m, maxlen, meta, nch


def load_read_batch_distributed(mesh, file1: str, file2: str | None = None,
                                *, trim_left: int = 3, trim_right: int = 3,
                                rna: bool = False, str_period: int = 20):
    """(packed int32[per, W], lengths int32[per], valid bool[per], n_rows):
    this rank's block of the read store on its device, and the number of
    real rows over all ranks (the rest is padding of length 0, invalid).
    Blocks hold a multiple of 4 rows with mates (2 without), so no
    record's rows straddle two ranks."""
    step = 4 if file2 else 2
    buf1, fmt1, m1, len1, meta1, nch1 = _scan(file1)
    lpad = len1
    if file2:
        buf2, fmt2, m2, len2, meta2, nch2 = _scan(file2)
        if m1 != m2:
            raise UnsupportedInputError(
                f"mate files hold {m1} and {m2} records")
        lpad = max(len1, len2)
    lpad = max(1, lpad)
    nrows = step * m1
    _, per = mesh_mod.block(mesh, nrows, step)
    rec_lo = mesh.rank * per // step
    m_local = max(0, min((mesh.rank + 1) * per // step, m1) - rec_lo)

    packed_l = np.zeros((per, packing.words_for(lpad)), dtype=np.uint32)
    lengths_l = np.zeros(per, dtype=np.int32)
    dropped_l = np.ones(per, dtype=np.uint8)     # padding rows invalid
    if m_local:
        kw = dict(trim_left=trim_left, trim_right=trim_right, rna=rna,
                  str_period=str_period, out_step=step,
                  out_packed=packed_l, out_lengths=lengths_l,
                  out_dropped=dropped_l)
        native.preprocess_pack(*native.fastx_fill_range(
            buf1, fmt1, lpad, rec_lo, rec_lo + m_local, meta1, nch1),
            out_base=1, **kw)
        if file2:
            native.preprocess_pack(*native.fastx_fill_range(
                buf2, fmt2, lpad, rec_lo, rec_lo + m_local, meta2, nch2),
                out_base=3, **kw)
    dropped_l[step * m_local:] = 1
    dev = mesh.device
    return (torch.from_numpy(words_as_int32(packed_l)).to(dev),
            torch.from_numpy(lengths_l).to(dev),
            torch.from_numpy(dropped_l == 0).to(dev), nrows)
