"""The reading of a traced stretch: busy time as the union of kernel
intervals, and each idle gap put to what the host was doing."""

from types import SimpleNamespace

import pytest

from portbench import trace


def event(start, end, name="op"):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end), name=name)


def test_busy_time_is_the_union_of_kernel_intervals():
    merged = trace._merged([(0, 10), (5, 12), (20, 30), (30, 31), (40, 41)])
    assert merged == [[0, 12], [20, 31], [40, 41]]
    assert sum(end - start for start, end in merged) == 24


def test_idle_gaps_go_to_the_innermost_open_host_operation():
    busy = [[0, 10], [20, 30], [50, 60], [100, 110]]
    host = [event(0, 200, "outer"), event(12, 18, "cudaStreamSynchronize"), event(31, 49, "cudaGraphLaunch")]
    gaps = dict(trace._idle_by_host(busy, host))
    # 10-20 inside the synchronise, 30-50 inside the launch, 60-100 in the outer op alone
    assert gaps == pytest.approx({"cudaStreamSynchronize": 10e-6, "cudaGraphLaunch": 20e-6, "outer": 40e-6})


def test_idle_gaps_with_no_host_operation_open_are_python():
    assert trace._idle_by_host([[0, 1], [3, 4]], []) == [["python", pytest.approx(2e-6)]]
