"""The port's segments_list (norma_tpu_torch/utils.py) against the JAX
package's on tests/test_utils.py's nine cases: both give the expected
segments, exactly."""

import pytest

from norma_tpu.utils import segments_list as jsegments
from norma_tpu_torch.utils import segments_list


def pred(x):
    return x >= 10


CASES = {
    "empty": ([], []),
    "no_match": ([1, 2, 3], []),
    # One boundary only -> no complete segment (the tail is dropped).
    "single_match_dropped": ([1, 10, 2], []),
    "basic_pair": ([10, 1, 2, 11], [[10, 1, 2, 11]]),
    "leading_dropped": ([1, 2, 10, 3, 11], [[10, 3, 11]]),
    # Boundaries are consumed: [10,1,11] then restart after 11 -> [12,2,13].
    "non_overlapping_boundaries": ([10, 1, 11, 12, 2, 13], [[10, 1, 11], [12, 2, 13]]),
    "adjacent_boundaries": ([10, 11, 12, 13], [[10, 11], [12, 13]]),
    "trailing_incomplete_dropped": ([10, 1, 11, 12, 2], [[10, 1, 11]]),
    "all_match_even": ([10, 11], [[10, 11]]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_segments_list(case):
    seq, want = CASES[case]
    assert segments_list(seq, pred) == want
    assert jsegments(seq, pred) == want
