"""The port's mesh layer (alga_tpu_torch/parallel/mesh.py) on gloo ranks.

The port runs in 2 and 3 rank processes on the CPU, with jax and alga_tpu
blocked there; alga_tpu runs here, on the 8-device virtual mesh of
tests/conftest.py.  Everything compared is an integer, so the tolerance
is 0.  `run_ranks` is the harness the other mesh test files share: one
spawn per module and world size, each rank's results pickled back.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from alga_tpu.core import packing
from alga_tpu.ops import bitops
from alga_tpu.parallel import mesh as jmesh
from alga_tpu_torch.ops import bitops as tbitops

ROOT = Path(__file__).resolve().parents[1]

_PRELUDE = r"""
import os, pickle, sys
sys.modules["jax"] = None            # any `import jax` now fails
sys.modules["alga_tpu"] = None       # and any import of alga_tpu
sys.path.insert(0, {root!r})
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://{store}", rank=rank,
                        world_size={d}, timeout=timedelta(seconds=120))
from alga_tpu_torch.parallel import mesh as mesh_mod
mesh = mesh_mod.make_mesh("cpu")
assert (mesh.rank, mesh.d) == (rank, {d})
out = {{}}
"""

# every rank waits for the others, then leaves without tearing gloo down
# (its teardown at interpreter exit can abort a rank under load)
_EPILOGUE = r"""
with open(os.path.join({tmp!r}, f"out{{rank}}.pkl"), "wb") as f:
    pickle.dump(out, f)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""

# data both sides build from the same seeds
GEN = r"""
def overlapping_reads(seed, genome_len=606, read_len=48, step=3):
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=genome_len))
    return [genome[i:i + read_len]
            for i in range(0, genome_len - read_len, step)]
"""


def run_ranks(tmp_path: Path, d: int, body: str, timeout: float = 240,
              env: dict | None = None) -> list[dict]:
    """Run `body` in d gloo rank processes on the CPU (`mesh`, `rank`,
    numpy, torch and the GEN helpers in scope) and return each rank's
    `out` dict.  A rank that fails ends the others and fails the test
    with its output."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    store = tmp_path / "store"
    if store.exists():
        store.unlink()
    script = (_PRELUDE.format(root=str(ROOT), store=str(store), d=d) + GEN
              + body + _EPILOGUE.format(tmp=str(tmp_path)))
    penv = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                **(env or {}))
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(d)]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=penv, cwd=str(tmp_path))
             for r in range(d)]
    t_end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > t_end):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                    + f.read()[-4000:])
        f.close()
    assert all(p.returncode == 0 for p in procs), "\n".join(text)
    outs = []
    for r in range(d):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def gen():
    """The GEN helpers, for this process."""
    ns = {"np": np}
    exec(GEN, ns)
    return ns


_BODY = r"""
from alga_tpu_torch.core import packing
from alga_tpu_torch.parallel.mesh import (all_max, all_sum, fetch_rows,
                                          gather_all, route)
from alga_tpu_torch.utils import timers
d = mesh.d
timers.reset_counters()
# rank r sends r + 1 rows to each rank s <= r and none to the others;
# the last rank sends nothing at all
dest = torch.tensor([s for s in range(d) if rank < d - 1 and s <= rank
                     for _ in range(rank + 1)], dtype=torch.int64)
pay = torch.stack([torch.full_like(dest, rank), torch.arange(dest.numel()),
                   dest], dim=1)
out["route"] = route(mesh, dest, pay).tolist()
per = 5
table = (torch.arange(per * 3, dtype=torch.int32).reshape(per, 3)
         + 1000 * rank)
gids = torch.tensor([(7 * i + rank) % (per * d) for i in range(4 * rank)],
                    dtype=torch.int64)
out["fetch"] = (gids.tolist(), fetch_rows(mesh, table, gids, per).tolist())
out["gather"] = gather_all(mesh, torch.full((rank, 2), rank)).tolist()
out["gather_bool"] = gather_all(mesh, torch.ones(2 - rank % 2,
                                                 dtype=torch.bool)).tolist()
out["bytes"] = {k: v for k, v in timers.counters_report().items()
                if k.startswith("a2a_bytes_")}
out["sum"], out["max"] = all_sum(mesh, rank + 1), all_max(mesh, 10 * rank)

seqs = overlapping_reads(7)
packed, lengths = packing.pack_strings(seqs)
n = len(seqs)
npad, per = mesh_mod.block(mesh, n)
pk = np.zeros((npad, packed.shape[1]), np.uint32)
pk[:n] = packed
ln = np.zeros(npad, np.int32)
ln[:n] = lengths
pt = torch.from_numpy(pk.view(np.int32))
lt = torch.from_numpy(ln)
k, nw = 20, int(lengths.max()) - 20 + 1
rows = slice(rank * per, (rank + 1) * per)
out["count"] = mesh_mod.sharded_candidate_count(mesh, pt[rows], lt[rows], k,
                                                nw)
rng = np.random.default_rng(3)
m = 64
a = rng.integers(0, n, m); b = rng.integers(0, n, m)
start = rng.integers(0, 20, m); ml = rng.integers(0, 29, m)
c = slice(rank * m // d, (rank + 1) * m // d)
t = lambda x: torch.from_numpy(x[c])
cnt, ok, mm = mesh_mod.sharded_overlap_step(
    mesh, pt, lt, t(a), t(start), t(b), t(ml), k, nw, 3)
out["step"] = (cnt, gather_all(mesh, ok).tolist(),
               gather_all(mesh, mm).tolist())
"""


@pytest.fixture(scope="module", params=[2, 3], ids=["d2", "d3"])
def ranks(request, tmp_path_factory):
    d = request.param
    return d, run_ranks(tmp_path_factory.mktemp(f"mesh{d}"), d, _BODY)


def test_route_uneven_and_empty_splits(ranks):
    """Rank r sends r + 1 rows to each rank s <= r (the last rank sends
    none); each rank receives them grouped by source, in source order."""
    d, outs = ranks
    for s, o in enumerate(outs):
        want = [[r, s * (r + 1) + i, s] for r in range(d - 1) if s <= r
                for i in range(r + 1)]
        assert o["route"] == want


def test_fetch_rows_uneven_and_empty(ranks):
    d, outs = ranks
    per = 5
    for o in outs:
        gids, rows = o["fetch"]
        assert rows == [[3 * (g % per) + c + 1000 * (g // per)
                         for c in range(3)] for g in gids]
    assert outs[0]["fetch"] == ([], [])


def test_gather_all_and_reductions(ranks):
    d, outs = ranks
    for o in outs:
        assert o["gather"] == [[r, r] for r in range(d) for _ in range(r)]
        assert o["gather_bool"] == [True for r in range(d)
                                    for _ in range(2 - r % 2)]
        assert (o["sum"], o["max"]) == (d * (d + 1) // 2, 10 * (d - 1))


def test_exchange_byte_counters(ranks):
    """Every exchange and gather counts the payload bytes its rank sends,
    and the part of them sent to other ranks: route rows of 3 int64, fetch
    requests (int64 ids) and responses (3 int32), gather_all's rows padded
    to the longest rank's (2 int64, then bool as int32) to every rank."""
    d, outs = ranks
    per = 5
    owners = [[g // per for g in o["fetch"][0]] for o in outs]
    for r, o in enumerate(outs):
        route = [(r + 1) * 24 if r < d - 1 and s <= r else 0
                 for s in range(d)]
        req = [8 * owners[r].count(s) for s in range(d)]
        resp = [12 * owners[s].count(r) for s in range(d)]
        gather = [16 * (d - 1) + 4 * 2] * d
        want = {"route": route, "fetch_request": req,
                "fetch_response": resp, "gather_all": gather}
        cross = 0
        for tag, sent in want.items():
            assert o["bytes"].get(f"a2a_bytes_{tag}", 0) == sum(sent), tag
            cross += sum(sent) - sent[r]
        assert o["bytes"]["a2a_bytes_total"] == sum(
            sum(s) for s in want.values())
        assert o["bytes"]["a2a_bytes_cross_device"] == cross


def _padded_store(n_to: int = 192):
    seqs = gen()["overlapping_reads"](7)
    packed, lengths = packing.pack_strings(seqs)
    n = len(seqs)
    pk = np.zeros((n_to, packed.shape[1]), np.uint32)
    pk[:n] = packed
    ln = np.zeros(n_to, np.int32)
    ln[:n] = lengths
    return pk, ln, n, int(lengths.max())


def test_candidate_count_matches_alga_tpu(ranks):
    d, outs = ranks
    pk, ln, n, max_len = _padded_store()
    want = int(jmesh.sharded_candidate_count(
        jmesh.make_mesh(8), pk, ln, 20, max_len - 20 + 1))
    assert want > 0
    assert [o["count"] for o in outs] == [want] * d


def test_overlap_step_matches_alga_tpu(ranks):
    d, outs = ranks
    pk, ln, n, max_len = _padded_store()
    rng = np.random.default_rng(3)
    m = 64
    a = rng.integers(0, n, m)
    b = rng.integers(0, n, m)
    start = rng.integers(0, 20, m)
    ml = rng.integers(0, 29, m)
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    cnt, ok, mm = jmesh.sharded_overlap_step(
        jmesh.make_mesh(8), pk, ln, i32(a), i32(start), i32(b), i32(ml), 20,
        max_len - 20 + 1, 3)
    want = (int(cnt), np.asarray(ok).tolist(),
            np.asarray(mm).astype(int).tolist())
    assert 0 < sum(want[1]) < m
    for o in outs:
        assert o["step"] == want


def test_overlap_mismatch_count_matches_alga_tpu():
    """bitops.overlap_mismatch_count and np_mismatch_count against
    alga_tpu's, on random reads, starts and lengths (ragged words)."""
    rng = np.random.default_rng(5)
    seqs = ["".join("ACGT"[c]
                    for c in rng.integers(0, 4, rng.integers(30, 90)))
            for _ in range(40)]
    packed, lengths = packing.pack_strings(seqs)
    codes = packing.packed_to_codes(packed)
    m = 300
    a = rng.integers(0, 40, m)
    b = rng.integers(0, 40, m)
    start = rng.integers(0, 25, m)
    ml = np.minimum(rng.integers(0, 70, m), np.minimum(
        lengths[a] - start, lengths[b])).clip(0)
    want = np.asarray(bitops.overlap_mismatch_count(
        packed, a.astype(np.int32), start.astype(np.int32),
        b.astype(np.int32), ml.astype(np.int32), packed.shape[1]))
    got = tbitops.overlap_mismatch_count(
        torch.from_numpy(packed.view(np.int32)), torch.from_numpy(a),
        torch.from_numpy(start), torch.from_numpy(b), torch.from_numpy(ml),
        packed.shape[1]).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).any()
    host = [tbitops.np_mismatch_count(codes, a[i], start[i], b[i], ml[i])
            for i in range(m)]
    assert host == [bitops.np_mismatch_count(codes, a[i], start[i], b[i],
                                             ml[i]) for i in range(m)]
    np.testing.assert_array_equal(host, want)
