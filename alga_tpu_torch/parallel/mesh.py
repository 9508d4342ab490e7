"""The device mesh on torch.distributed (port of alga_tpu/parallel/mesh.py).

alga_tpu shards over the 1-D axis 'r' of a `jax.sharding.Mesh` inside one
program (`shard_map`).  Here each rank is a process with one device, and
the collectives are torch.distributed calls on a process group: NCCL for
CUDA tensors, gloo for CPU tensors.  Read g lives on rank g // per, as
P("r", None) places it.

Every exchange is sized exactly: the ranks first swap their send counts
(one `all_to_all_single` of int64[d]), then the payload moves with those
splits.  So nothing here has alga_tpu's static capacities, overflow flags
or retry loops (sharded_gcps.py:563-633): those exist because XLA needs
static shapes.  Payloads are int32 or int64 tensors (gloo has no unsigned
types), so alga_tpu's uint32 rows with a 0xFFFFFFFF fill become integer
rows with no fill.

Collectives: `route` (rows to owner ranks), `fetch_rows` (remote gather
of table rows by global id), `gather_all` (variable-length all-gather)
and `all_sum` / `all_max`.  Each exchange and gather adds the payload
bytes this rank sends to the counters `a2a_bytes_<tag>`,
`a2a_bytes_total` and `a2a_bytes_cross_device` (the part sent to other
ranks); the int64 counts swapped ahead of a payload and the reductions
are not counted.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from alga_tpu_torch import device as device_mod
from alga_tpu_torch.graph.device_join import _fold
from alga_tpu_torch.ops import bitops, hashes
from alga_tpu_torch.utils import timers


@dataclass(frozen=True)
class Mesh:
    group: object            # the torch.distributed process group
    rank: int
    d: int                   # world size
    device: torch.device     # this rank's device


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def make_mesh(device=None) -> Mesh:
    """The mesh of this process: the default process group when one is
    initialized; else, under `torchrun` (RANK/WORLD_SIZE/MASTER_ADDR set),
    a group initialized from the environment; else a one-rank group over
    a `torch.distributed.HashStore`.

    `device=None` means CUDA and raises without it; `device="cpu"` runs on
    gloo.  A CUDA mesh runs on NCCL with one card per rank, so it raises
    when the world is larger than the cards visible.  The group's backend
    must be the device's: nothing falls back to the other one."""
    dev = device_mod.resolve(device)
    backend = _backend(dev)
    if dist.is_initialized():
        rank, d = dist.get_rank(), dist.get_world_size()
        if dist.get_backend() != backend:
            raise ValueError(
                f"make_mesh: the default process group runs "
                f"{dist.get_backend()}, but a mesh on {dev.type} needs "
                f"{backend}")
    else:
        env = all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                            "MASTER_ADDR", "MASTER_PORT"))
        rank = int(os.environ["RANK"]) if env else 0
        d = int(os.environ["WORLD_SIZE"]) if env else 1
    if dev.type == "cuda":
        if d > torch.cuda.device_count():
            raise RuntimeError(
                f"make_mesh: {d} ranks but {torch.cuda.device_count()} CUDA "
                "devices; NCCL needs one card per rank")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if d > 1:
            dist.init_process_group(backend, init_method="env://",
                                    rank=rank, world_size=d)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1,
                                    timeout=timedelta(seconds=600))
    return Mesh(dist.group.WORLD, rank, d, dev)


# ---------------------------------------------------------------------------
# collectives


def count_bytes(tag: str, total: int, cross: int) -> None:
    """Add `total` bytes sent by this rank, `cross` of them to other
    ranks, to the exchange counters."""
    timers.bump(f"a2a_bytes_{tag}", total)
    timers.bump("a2a_bytes_total", total)
    timers.bump("a2a_bytes_cross_device", cross)


def _bump_bytes(mesh: Mesh, tag: str, row_bytes: int, send) -> None:
    total = int(send.sum()) * row_bytes
    count_bytes(tag, total, total - int(send[mesh.rank]) * row_bytes)


def _exchange(mesh: Mesh, rows: torch.Tensor, send: torch.Tensor,
              tag: str, recv: torch.Tensor | None = None):
    """(received rows, recv counts): `rows` grouped by destination rank,
    send[r] of them for rank r.  The counts are swapped first unless the
    caller knows them (`recv`)."""
    if recv is None:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group)
    send_l, recv_l = send.tolist(), recv.tolist()
    out = rows.new_empty((sum(recv_l),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(out, rows.contiguous(), recv_l, send_l,
                           group=mesh.group)
    row_bytes = rows.element_size() * math.prod(rows.shape[1:])
    _bump_bytes(mesh, tag, row_bytes, send)
    return out, recv


def route(mesh: Mesh, dest: torch.Tensor, payload: torch.Tensor,
          tag: str = "route") -> torch.Tensor:
    """The rows of `payload` whose destination rank is dest[i], as every
    rank receives them: grouped by source rank, each source's rows in
    their order there (the bucketing sort is stable).  int32/int64 rows."""
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=mesh.d)
    out, _ = _exchange(mesh, payload[order], send, tag)
    return out


def fetch_rows(mesh: Mesh, table_l: torch.Tensor, gids: torch.Tensor,
               per: int, tag: str = "fetch") -> torch.Tensor:
    """table[gids] for a table block-sharded by rows (rank r holds rows
    [r*per, (r+1)*per) as `table_l`): the ids go to their home ranks, the
    rows come back on the reverse exchange in request order (the
    request/response pair of alga_tpu's _fetch_table_rows,
    sharded_gcps.py:114).  Every id must be in range."""
    gids = gids.to(torch.int64)
    owner = gids // per
    order = torch.argsort(owner, stable=True)
    send = torch.bincount(owner, minlength=mesh.d)
    req, recv = _exchange(mesh, gids[order], send, f"{tag}_request")
    resp, _ = _exchange(mesh, table_l[req - mesh.rank * per], recv,
                        f"{tag}_response", recv=send)
    out = torch.empty_like(resp)
    out[order] = resp
    return out


def gather_all(mesh: Mesh, x: torch.Tensor,
               tag: str = "gather_all") -> torch.Tensor:
    """The concatenation over ranks, in rank order, of every rank's `x`
    (lengths may differ; bool travels as int32), on every rank.  Each
    rank sends its rows, padded to the longest rank's, to every rank."""
    if x.dtype == torch.bool:
        return gather_all(mesh, x.to(torch.int32), tag) != 0
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [torch.zeros_like(n) for _ in range(mesh.d)]
    dist.all_gather(sizes, n, group=mesh.group)
    sizes = [int(s) for s in sizes]
    m = max(sizes)
    pad = x.new_zeros((m,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(mesh.d)]
    dist.all_gather(parts, pad, group=mesh.group)
    nbytes = pad.numel() * pad.element_size()
    count_bytes(tag, mesh.d * nbytes, (mesh.d - 1) * nbytes)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def _reduce(mesh: Mesh, x, op):
    t = torch.as_tensor(x, device=mesh.device).to(torch.int64).clone()
    dist.all_reduce(t, op=op, group=mesh.group)
    return int(t) if not torch.is_tensor(x) else t


def all_sum(mesh: Mesh, x):
    """Sum over ranks of an int (returns an int) or an integer tensor."""
    return _reduce(mesh, x, dist.ReduceOp.SUM)


def all_max(mesh: Mesh, x):
    """Max over ranks of an int (returns an int) or an integer tensor."""
    return _reduce(mesh, x, dist.ReduceOp.MAX)


def block(mesh: Mesh, n: int, multiple: int = 1) -> tuple[int, int]:
    """(npad, per): rows padded so that every rank holds `per` rows, a
    multiple of `multiple`."""
    gran = mesh.d * multiple
    npad = max(gran, -(-n // gran) * gran)
    return npad, npad // mesh.d


# ---------------------------------------------------------------------------
# the sharded candidate count and overlap step


def sharded_candidate_count(mesh: Mesh, packed_l, lengths_l, k: int,
                            num_windows: int) -> int:
    """Suffix-prefix candidate pairs over the mesh: each rank hashes its
    own reads, all ranks' prefix keys are gathered, and each rank joins
    its window keys against them; the global count (alga_tpu's
    sharded_candidate_count, mesh.py:34)."""
    k1, k2, valid = hashes.window_kmer_keys_u32(packed_l, lengths_l, k,
                                                num_windows)
    keys = _fold(k1, k2)
    pk = keys[:, 0][lengths_l.to(torch.int64) >= k]
    sorted_pk, _ = torch.sort(gather_all(mesh, pk, "candidate_prefixes"))
    flat = keys[valid]
    hits = (torch.searchsorted(sorted_pk, flat, right=True)
            - torch.searchsorted(sorted_pk, flat))
    return all_sum(mesh, int(hits.sum()))


def sharded_overlap_step(mesh: Mesh, packed, lengths, cand_a, cand_starts,
                         cand_b, cand_lens, k: int, num_windows: int,
                         num_words: int):
    """(global candidate count, ok, mismatches): the count over the
    rank's block of the store (`packed`/`lengths` are the whole store,
    as P() replicates it), and the exact compare and mismatch count of
    this rank's candidates (alga_tpu's sharded_overlap_step, mesh.py:59)."""
    per = packed.shape[0] // mesh.d
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    count = sharded_candidate_count(mesh, packed[rows], lengths[rows], k,
                                    num_windows)
    ok = bitops.substr_equal(packed, cand_a, cand_starts, cand_b, cand_lens,
                             num_words)
    mm = bitops.overlap_mismatch_count(packed, cand_a, cand_starts, cand_b,
                                       cand_lens, num_words)
    return count, ok, mm
