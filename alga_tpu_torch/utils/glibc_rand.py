"""Exact replica of glibc's rand() (TYPE_3 additive-feedback generator,
default seed 1) and libstdc++'s std::random_shuffle.

Needed for bug-compatible parity with the reference's dangling-branch
removal, which shuffles its edge list with std::random_shuffle
(GraphSimplifier.cpp:677) and then DROPS a rand()-dependent tail of it via
a WorkloadManager block-coverage quirk (WorkloadManager.cpp:14-19: with
N0 = N - n items-1, blocks clamped to N0 and W = ceil(N0/blocks), the
covered index range is [0, min(blocks*W - 1, N0)] — whenever blocks
divides N0 the LAST item is never processed, and a single-item list is
skipped entirely because blocks clamps to 0).

The reference never calls srand() and consumes rand() exclusively in
these shuffles (all other rand() sites live in test() functions), so the
stream is replayable from seed 1.  Differential-tested against the
in-process libc rand() (tests/test_aux.py).

A copy of alga_tpu/utils/glibc_rand.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

_M31 = 0x7FFFFFFF


class GlibcRand:
    """glibc rand(): TYPE_3, 31-word additive feedback, 310-step warmup."""

    def __init__(self, seed: int = 1):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 34
        r[0] = seed
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2^31-1, computed like glibc
            r[i] = (16807 * r[i - 1]) % _M31
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._r = r
        self._i = 34
        for _ in range(310):            # warmup discards
            self._next()

    def _next(self) -> int:
        r = self._r
        i = self._i
        v = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        r.append(v)
        self._i = i + 1
        # bound memory: keep only the live window
        if len(r) > 4096:
            del r[: len(r) - 31]
            self._i = 31
        return v

    def rand(self) -> int:
        return self._next() >> 1


def random_shuffle(lst: list, rng: GlibcRand) -> None:
    """libstdc++ std::random_shuffle(first, last): for i in [1, n),
    iter_swap(i, rand() % (i+1)) (bits/stl_algo.h).  Consumes exactly
    len(lst)-1 rand() calls for len >= 2, none otherwise."""
    for i in range(1, len(lst)):
        j = rng.rand() % (i + 1)
        lst[i], lst[j] = lst[j], lst[i]


def workload_covered(count: int, blocks: int) -> int:
    """Number of items [0, count) actually processed by the reference's
    WorkloadManager::parallelBlockExecution(0, count-1, blocks, T)
    (WorkloadManager.cpp:12-43).  Returns a PREFIX length: whenever the
    clamped block count divides count-1 the last item is dropped, and a
    single-item range is skipped entirely."""
    if count <= 0:
        return 0
    n0 = count - 1
    b = max(1, blocks)
    if b > n0:
        b = n0
    if b == 0:
        return 0
    w = -(-n0 // b)
    return min(b * w - 1, n0) + 1
