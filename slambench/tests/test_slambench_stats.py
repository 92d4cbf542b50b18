"""The host-clock arithmetic: rate, mean and p95 over all samples."""
import pytest

from slambench import stats


def test_rate_and_mean():
    assert stats.rate(30, 10.0) == 3.0
    assert stats.mean([1.0, 2.0, 6.0]) == 3.0


@pytest.mark.parametrize("n,expected", [(1, 1), (19, 19), (20, 19),
                                        (21, 20), (100, 95), (101, 96)])
def test_p95_nearest_rank_over_all_samples(n, expected):
    xs = list(range(n, 0, -1))           # order must not matter
    assert stats.p95(xs) == expected
