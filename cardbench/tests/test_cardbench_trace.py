"""The device time of a profiled window: the union of its device operations,
and a trace cut short refused."""

from types import SimpleNamespace

import pytest

from cardbench.core.trace import profiled_device_seconds, union_length


def _profiler(events):
    """A stand-in for ``torch.profiler.profile`` after its window: events of
    (activity type, start ns, end ns)."""
    made = [
        SimpleNamespace(activity_type=lambda kind=kind: kind, start_ns=lambda start=start: start,
                        duration_ns=lambda start=start, end=end: end - start)
        for kind, start, end in events
    ]
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: made)))


def test_union_length_counts_overlaps_once():
    assert union_length([]) == 0.0
    assert union_length([(5, 7), (0, 2), (1, 3), (6, 6.5), (10, 11)]) == pytest.approx(3 + 2 + 1)


def test_profiled_device_seconds_are_the_union_of_device_operations():
    second = 10**9
    events = [
        ("kernel", 0, 4 * second),
        ("kernel", 3 * second, 5 * second),  # a side stream overlapping the first
        ("gpu_memcpy", 6 * second, 7 * second),
        ("gpu_memset", 9 * second, 10 * second),
        ("cuda_runtime", 0, 10 * second),  # host side: not device time
    ]
    busy, operations = profiled_device_seconds(_profiler(events), wall_s=10.0)
    assert busy == pytest.approx(7.0) and operations == 4


def test_a_trace_cut_short_or_empty_is_refused():
    second = 10**9
    with pytest.raises(RuntimeError, match="cut short"):
        profiled_device_seconds(_profiler([("kernel", 0, 5 * second)]), wall_s=10.0)
    with pytest.raises(RuntimeError, match="no device operation"):
        profiled_device_seconds(_profiler([("cuda_runtime", 0, 10 * second)]), wall_s=10.0)
