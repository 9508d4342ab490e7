"""Semantic graph checker (port of alga_tpu/utils/oracle.py; ref
Global::checkOLCGraphCorrectness, src/Global.cpp:121-145): every edge's
claimed overlap re-verified by exact packed compare, on the device."""

from __future__ import annotations

import numpy as np
import torch

from alga_tpu_torch import device as device_mod
from alga_tpu_torch.core import packing
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.ops import bitops
from alga_tpu_torch.store import words_as_int32


def check_olc_graph(g: OverlapGraph, packed: np.ndarray, lengths: np.ndarray,
                    *, device=None) -> np.ndarray:
    """bool[E]: edge (src→dst, offset) is a genuine exact overlap, i.e.
    src[offset : len_src] == dst[0 : len_src - offset] and the overlap is
    positive and within dst.  The compares run on `device` (CUDA when
    None, as everywhere in the port)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    if g.num_edges == 0:
        return np.zeros(0, dtype=bool)
    ov = np.minimum(lengths[g.src], lengths[g.dst] + g.offset) - g.offset
    ok_shape = (ov > 0) & (g.offset >= 0) & (ov <= lengths[g.dst])
    dev = device_mod.resolve(device)

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)
    match = bitops.substr_equal(
        torch.from_numpy(words_as_int32(packed)).to(dev), t(g.src),
        t(g.offset), t(g.dst), t(np.maximum(ov, 0)),
        packing.words_for(max(1, int(ov.max())))).cpu().numpy()
    return ok_shape & match


def assert_olc_graph_correct(g, packed, lengths, *, device=None) -> None:
    ok = check_olc_graph(g, packed, lengths, device=device)
    if not ok.all():
        bad = np.flatnonzero(~ok)[:10]
        raise AssertionError(
            f"{(~ok).sum()} invalid overlap edges, e.g. "
            f"{[(int(g.src[i]), int(g.dst[i]), int(g.offset[i])) for i in bad]}")
