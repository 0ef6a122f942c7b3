"""Segment helpers (``norma_tpu/utils.py:104-137``)."""

from __future__ import annotations

from typing import Callable, Iterator, List, Sequence, TypeVar

T = TypeVar("T")


def inclusive_segments(
    seq: Sequence[T], pred: Callable[[T], bool]
) -> Iterator[Sequence[T]]:
    """Yield sub-slices of ``seq`` bounded inclusively by ``pred`` matches.

    Consecutive segments do not share boundary elements: for boundaries
    b0, b1, b2 the segments are ``[b0..b1]`` and then ``[b2..b3]`` (the
    search restarts *after* each segment's closing boundary).
    """
    i = 0
    n = len(seq)
    while i < n:
        start = None
        for j in range(i, n):
            if pred(seq[j]):
                start = j
                break
        if start is None:
            return
        end = None
        for j in range(start + 1, n):
            if pred(seq[j]):
                end = j
                break
        if end is None:
            return
        yield seq[start : end + 1]
        i = end + 1


def segments_list(seq: Sequence[T], pred: Callable[[T], bool]) -> List[Sequence[T]]:
    return list(inclusive_segments(seq, pred))
