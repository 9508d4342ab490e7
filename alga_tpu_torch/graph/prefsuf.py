"""GCPS graph routing (port of alga_tpu/graph/prefsuf.py:251-315).

Three engines build the same graph: the fused one-pass device path
(graph/device_join.py) for short-read batches under its packed-key
limits, the blocked device path (graph/device_scale.py) at any size, and
the native host engine, whose fused join rolls only the last `cap`
windows of each sequence (alga_tpu/graph/prefsuf.py:97-119,312-315) and
so takes long sequences: the contig-trim graph.

ALGA_GCPS_DEVICE=small|wide|off forces the fused path, the blocked path
or the host engine, as it does in the JAX package; `small` falls through
with a notice when the input breaks the fused path's limits.  Without
it, a CUDA device takes the fused path where the JAX package's
accelerator rule does (alga_tpu/graph/prefsuf.py:276-283,298-299); other
short-read graphs, and every one on the CPU, take the blocked path, and
sequences longer than cap + cap/4 stay on the host.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from alga_tpu_torch import device as device_mod
from alga_tpu_torch import native
from alga_tpu_torch.graph.device_join import Matches, gcps_graph_device
from alga_tpu_torch.graph.device_scale import gcps_graph_device_scale
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.ops import hashes
from alga_tpu_torch.utils import timers


def host_gcps_graph(packed, lengths, n: int, ell_min: int, cap: int,
                    rsoe: int, soes: int = 3, align_from=None,
                    align_to=None):
    """GCPS graph by the native engine: prefix keys, fused join + verify
    straight from the packed store, then the post-match stages."""
    if not native.available():
        raise RuntimeError("alga_tpu_torch: the native host engine "
                           "(native/libalga_host.so) is required for the "
                           "contig-trim graph")
    lengths = np.asarray(lengths, dtype=np.int64)
    k = int(ell_min)
    max_len = int(lengths.max(initial=0))
    if n == 0 or k <= 0 or max_len < k:
        return OverlapGraph.empty(n)
    af = (np.ones(n, dtype=bool) if align_from is None
          else np.asarray(align_from, dtype=bool))
    at = (np.ones(n, dtype=bool) if align_to is None
          else np.asarray(align_to, dtype=bool))
    packed = np.asarray(packed)
    pref_ids = np.flatnonzero((lengths >= k) & at)
    pk = native.prefix_keys(packed, pref_ids, k, hashes.A1, hashes.A2)
    order = np.argsort(pk, kind="stable")
    src, dst, ell = native.gcps_join_verify_packed(
        n, max_len - k + 1, lengths, af & (lengths >= k), k, cap,
        hashes.A1, hashes.A2, pk[order], pref_ids[order].astype(np.int32),
        packed)
    timers.bump("gcps_matches", len(src))
    return native.gcps_from_matches(n, Matches(src, dst, ell), packed,
                                    lengths, rsoe, soes)


def build_gcps_graph(packed, lengths, n: int, ell_min: int, cap: int,
                     rsoe: int, soes: int = 3, align_from=None,
                     align_to=None, *, device=None):
    """Full GCPS graph: orientation src→dst where dst's prefix equals
    src's suffix, offset = len(src) - ell.  Deterministic."""
    lengths_np = _numpy(lengths)
    max_len = int(lengths_np.max(initial=0))
    n_windows = max(0, max_len - int(ell_min) + 1)
    force = os.environ.get("ALGA_GCPS_DEVICE", "")
    # the fused path's packed sort keys need ids < 2^22 and lengths < 1024;
    # its automatic use stops at 2^19 reads, as in the JAX package
    small_safe = n_windows <= 4096 and n < (1 << 22) and max_len < 1024
    if force == "small" and not small_safe:
        print("[alga_tpu] ALGA_GCPS_DEVICE=small ignored: input "
              f"violates fused-path preconditions (n={n}, "
              f"max_len={max_len}, n_windows={n_windows}); "
              "falling through to wide/host routing", file=sys.stderr)
        force = ""
    args = (packed, lengths, n, ell_min, cap, rsoe, soes, align_from,
            align_to)
    if force == "small" or (
            not force and small_safe and n < (1 << 19)
            and len(lengths_np) * n_windows >= 1 << 18
            and device_mod.resolve(device).type == "cuda"):
        return gcps_graph_device(*args, device=device)
    if force == "wide" or (not force and max_len <= cap + (cap >> 2)):
        return gcps_graph_device_scale(*args, device=device)
    packed = _numpy(packed)
    if packed.dtype == np.int32:
        packed = packed.view(np.uint32)
    return host_gcps_graph(packed, lengths_np, n, ell_min, cap, rsoe, soes,
                           _numpy(align_from), _numpy(align_to))


def _numpy(x):
    """numpy array of a tensor (fetched from its device) or array-like;
    None stays None."""
    if x is None:
        return None
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
