"""The busy time is the union of the device intervals, not their sum."""
from harness.trace import Trace, gaps, union_length


def test_union_of_overlapping_intervals():
    ivs = [(0.0, 4.0), (1.0, 2.0), (3.0, 6.0), (8.0, 9.0)]
    assert union_length(ivs) == 7.0
    assert union_length(ivs, 2.0, 8.5) == 4.5
    assert gaps(ivs, 0.0, 10.0) == [(6.0, 8.0), (9.0, 10.0)]


def test_a_dependent_inside_its_primary_reads_at_most_full():
    # a reduce launched early runs inside its primary's interval: a sum
    # would read 150% busy, the union reads 100%
    device = [("train_dw_kernel", 0.0, 2.0), ("train_fd_reduce_kernel", 0.5, 1.5)]
    tr = Trace(device, {"window": [(0.0, 2.0)], "step": [(0.0, 2.0)]}, [])
    assert tr.busy_s() == 2.0 == tr.window_s
    assert sum(e - s for _, s, e in device) / tr.window_s == 1.5
    assert tr.idle_gaps() == []


def test_idle_gaps_named_by_the_innermost_span_and_host_op():
    tr = Trace([("k", 0.0, 1.0), ("k", 3.0, 4.0)],
               {"window": [(0.0, 4.0)], "run": [(0.0, 4.0)], "admit": [(1.0, 3.0)]},
               [(1.5, 2.5, "aten::copy_")])
    assert tr.idle_gaps() == [["admit / aten::copy_", 2.0]]
    assert tr.device_ops() == [["k", 2.0]]
