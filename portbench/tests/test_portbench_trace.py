"""The trace's reductions, on hand-made intervals: the union of the
device's intervals, and its idle gaps summed by the operation that ended
each."""
import pytest

from portbench.harness.trace import _idle_by_next_op, union


@pytest.mark.parametrize('intervals, want', [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 2), (1, 3)], 4.0),
    ([(0, 10), (2, 3)], 10.0),
])
def test_union(intervals, want):
    assert union(intervals) == want


def test_idle_by_next_op():
    kernels = [('gemm', 10.0, 20.0), ('copy', 25.0, 30.0),
               ('gemm', 40.0, 50.0), ('fill', 45.0, 48.0)]
    got = dict(_idle_by_next_op(kernels, 0.0, 60.0))
    assert got == pytest.approx({'before gemm': 20e-6, 'before copy': 5e-6,
                                 'after the last op': 10e-6})


def test_no_idle():
    assert _idle_by_next_op([('k', 0.0, 5.0)], 0.0, 5.0) == []
