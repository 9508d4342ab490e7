"""Exact replica of libstdc++ std::sort (introsort) element ordering.

The reference filters contigs after `std::sort` with a strictly-greater
size comparator (ref OutputWriterNew.cpp:157-159).  std::sort is NOT
stable, and which of two equal-size contigs (a contig and its reverse
complement twin) comes first decides which orientation survives the
greedy read-claiming filter — so byte-identical output requires replaying
libstdc++'s exact permutation: __introsort_loop (threshold 16, median-of-3
pivot, depth limit 2*log2(n), heapsort fallback) + __final_insertion_sort.

Ported from libstdc++ bits/stl_algo.h (GPL runtime exception); validated
differentially against a compiled std::sort in tests/test_libstdcxx_sort.py.

A copy of alga_tpu/utils/libstdcxx_sort.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

_S_THRESHOLD = 16


def _lg(n: int) -> int:
    return n.bit_length() - 1


def libstdcxx_sort(items: list, comp) -> list:
    """Return items permuted exactly as libstdc++ std::sort(begin, end, comp)
    would order them.  comp(a, b) -> bool ("a before b", strict)."""
    a = list(items)
    n = len(a)
    if n > 1:
        _introsort_loop(a, 0, n, 2 * _lg(n), comp)
        _final_insertion_sort(a, 0, n, comp)
    return a


def _introsort_loop(a, first, last, depth_limit, comp):
    while last - first > _S_THRESHOLD:
        if depth_limit == 0:
            _heap_sort(a, first, last, comp)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, first, last, comp)
        _introsort_loop(a, cut, last, depth_limit, comp)
        last = cut


def _unguarded_partition_pivot(a, first, last, comp):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, comp)
    return _unguarded_partition(a, first + 1, last, first, comp)


def _move_median_to_first(a, result, x, y, z, comp):
    if comp(a[x], a[y]):
        if comp(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif comp(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif comp(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif comp(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition(a, first, last, pivot, comp):
    while True:
        while comp(a[first], a[pivot]):
            first += 1
        last -= 1
        while comp(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _final_insertion_sort(a, first, last, comp):
    if last - first > _S_THRESHOLD:
        _insertion_sort(a, first, first + _S_THRESHOLD, comp)
        _unguarded_insertion_sort(a, first + _S_THRESHOLD, last, comp)
    else:
        _insertion_sort(a, first, last, comp)


def _insertion_sort(a, first, last, comp):
    if first == last:
        return
    for i in range(first + 1, last):
        if comp(a[i], a[first]):
            val = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, comp)


def _unguarded_insertion_sort(a, first, last, comp):
    for i in range(first, last):
        _unguarded_linear_insert(a, i, comp)


def _unguarded_linear_insert(a, last, comp):
    val = a[last]
    nxt = last - 1
    while comp(val, a[nxt]):
        a[nxt + 1] = a[nxt]
        nxt -= 1
    a[nxt + 1] = val


def _heap_sort(a, first, last, comp):
    # __make_heap + __sort_heap (bits/stl_heap.h)
    _make_heap(a, first, last, comp)
    for end in range(last - 1, first, -1):
        a[first], a[end] = a[end], a[first]
        _adjust_heap(a, first, 0, end - first, a[first], comp)


def _make_heap(a, first, last, comp):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, comp)
        if parent == 0:
            return
        parent -= 1


def _adjust_heap(a, first, hole, length, value, comp):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if comp(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if length & 1 == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    # __push_heap
    parent = (hole - 1) // 2
    while hole > top and comp(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value
