"""The trace reduction on made-up events."""

import pytest

from benchmark import trace


class Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_busy_gaps_and_spans():
    ms = 1_000_000
    evs = [Ev("bench.window", "CPU", 0, 100 * ms),
           Ev("bench.step", "CPU", 0, 40 * ms),
           Ev("bench.sync", "CPU", 40 * ms, 50 * ms),
           Ev("bench.step", "CPU", 90 * ms, 10 * ms),
           Ev("bench.step", "CUDA", 0, 40 * ms),       # an annotation copy
           Ev("gemm", "CUDA", 5 * ms, 20 * ms),
           Ev("gemm", "CUDA", 20 * ms, 15 * ms),       # overlaps the first
           Ev("Memcpy DtoH", "CUDA", 50 * ms, 10 * ms),
           Ev("gemm", "CUDA", 92 * ms, 20 * ms),       # runs past the end
           Ev("aten::mm", "CPU", 1 * ms, 1 * ms)]
    tr = trace.reduce(evs)
    assert tr.window_s == pytest.approx(0.1)
    # busy: [5, 35] + [50, 60] + [92, 100]
    assert tr.busy_s == pytest.approx(0.048)
    assert tr.ops["gemm"][0] == 3
    assert tr.time_of("gemm") == (3, pytest.approx(0.055))
    gaps = dict((round(s * 1e3), k) for k, s in tr.gaps)
    # [35, 50] and [60, 92] lie in the sync, [0, 5] in the step
    assert gaps == {15: "sync", 32: "sync", 5: "step"}
    assert tr.gaps[0] == ("sync", pytest.approx(0.032))
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["gemm", pytest.approx(0.055)]
    assert bd["idle_gaps"] == [["sync", pytest.approx(0.047)],
                               ["step", pytest.approx(0.005)],
                               ["sync.max", pytest.approx(0.032)],
                               ["sync.max", pytest.approx(0.015)],
                               ["step.max", pytest.approx(0.005)]]


def test_a_trace_without_a_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce([Ev("gemm", "CUDA", 0, 1)])


def test_percentile_interpolates():
    assert trace.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert trace.percentile([], 95) is None
