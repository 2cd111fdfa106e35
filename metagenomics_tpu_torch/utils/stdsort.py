"""Behavioral clone of libstdc++'s std::sort (introsort).

The reference assembler orders contigs, adjacency lists and support lists
with std::sort under NON-strict keys (equal overlap offsets, equal support
counts): the relative order of tied elements is then determined by
introsort's partitioning, not by input order (std::sort is not stable, see
e.g. the contig sort at MetaGenomics/OverlapGraph.cpp:478 and the support
sorts at :1968/:2197).  Reproducing the reference's output byte-for-byte
therefore requires reproducing the exact element movements of libstdc++'s
introsort: quicksort with median-of-3 pivot, depth limit 2*floor(log2 n)
falling back to heapsort, and a final insertion-sort pass with threshold 16.

This module re-implements that algorithm (as published in GCC's
stl_algo.h/stl_heap.h) for Python lists.  tests/test_utils.py fuzzes it
against a std::sort oracle binary compiled by the local g++.
"""

_THRESHOLD = 16


def std_sort(a, less):
    """In-place std::sort(a.begin(), a.end(), less) with libstdc++ element
    order, including the order of tied elements."""
    n = len(a)
    if n > 1:
        _introsort_loop(a, 0, n, _lg(n) * 2, less)
        _final_insertion_sort(a, 0, n, less)


def std_sort_key(a, key):
    """std_sort with a key function: comparator is key(x) < key(y)."""
    std_sort(a, lambda x, y: key(x) < key(y))


def _lg(n):
    return n.bit_length() - 1


def _introsort_loop(a, first, last, depth_limit, less):
    while last - first > _THRESHOLD:
        if depth_limit == 0:
            _heap_sort(a, first, last, less)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, first, last, less)
        _introsort_loop(a, cut, last, depth_limit, less)
        last = cut


def _move_median_to_first(a, result, x, y, z, less):
    if less(a[x], a[y]):
        if less(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif less(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif less(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif less(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition(a, first, last, pivot, less):
    while True:
        while less(a[first], a[pivot]):
            first += 1
        last -= 1
        while less(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, first, last, less):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, less)
    return _unguarded_partition(a, first + 1, last, first, less)


def _final_insertion_sort(a, first, last, less):
    if last - first > _THRESHOLD:
        _insertion_sort(a, first, first + _THRESHOLD, less)
        _unguarded_insertion_sort(a, first + _THRESHOLD, last, less)
    else:
        _insertion_sort(a, first, last, less)


def _insertion_sort(a, first, last, less):
    if first == last:
        return
    for i in range(first + 1, last):
        if less(a[i], a[first]):
            val = a[i]
            a[first + 1:i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, less)


def _unguarded_linear_insert(a, last, less):
    val = a[last]
    nxt = last - 1
    while less(val, a[nxt]):
        a[nxt + 1] = a[nxt]
        nxt -= 1
    a[nxt + 1] = val


def _unguarded_insertion_sort(a, first, last, less):
    for i in range(first, last):
        _unguarded_linear_insert(a, i, less)


# ------------------------------------------------------------------ heapsort
# __partial_sort(first, last, last) == make_heap + sort_heap (stl_heap.h)

def _heap_sort(a, first, last, less):
    _make_heap(a, first, last, less)
    _sort_heap(a, first, last, less)


def _push_heap(a, first, hole, top, value, less):
    parent = (hole - 1) // 2
    while hole > top and less(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _adjust_heap(a, first, hole, length, value, less):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if less(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, value, less)


def _make_heap(a, first, last, less):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, less)
        if parent == 0:
            return
        parent -= 1


def _sort_heap(a, first, last, less):
    while last - first > 1:
        last -= 1
        value = a[last]
        a[last] = a[first]
        _adjust_heap(a, first, 0, last - first, value, less)
