"""The reduction of the program's slp.* ranges against the card's trace
(`perfbench/program_trace.py`), on synthetic events: an idle gap is split
over the innermost ranges open along it, by length; the charged seconds
sum to the stretch's idle time; graph launches and the eager runs inside
a capture are not eager operations; and a trace or stats without the
program's ranges and counters read None, not 0.

Run: python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import types

import pytest

from perfbench import program_trace, trace


class Event:
    """A raw profiler event as the reductions read it."""

    def __init__(self, name, device, start, end, cid=0, linked=0):
        from torch.autograd import DeviceType

        self._v = (name, DeviceType.CUDA if device else DeviceType.CPU, start, end, cid, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def request(offset=0):
    """One request of one iteration in a stretch [0, 1000] (ns):
    the device busy over [40, 100] and [500, 600]; a host read ends at
    300, after which the step's Python runs until the next launch."""
    o = offset
    return [
        Event("slp.solve", False, o + 0, o + 1000, cid=1),
        Event("slp.iteration", False, o + 50, o + 950, cid=2),
        Event("slp.host_read", False, o + 100, o + 300, cid=3),
        Event("cudaLaunchKernel", False, o + 30, o + 35, cid=10),
        Event("kernel_a", True, o + 40, o + 100, cid=10),
        Event("cudaLaunchKernel", False, o + 480, o + 490, cid=11),
        Event("kernel_b", True, o + 500, o + 600, cid=11),
    ]


def test_a_gap_across_a_host_read_end_and_the_step_is_split_by_length():
    events = [Event(trace.STRETCH, False, 0, 1000)] + request()
    pt = program_trace.reduce(events)
    assert pt.idle_s == pytest.approx({
        "slp.solve": 40e-9 + 50e-9,  # [0, 40] and [950, 1000]
        "slp.host_read": 200e-9,  # [100, 300], the host blocked
        "slp.iteration": 200e-9 + 350e-9,  # [300, 500] and [600, 950], the step's own
    })
    # The existing reduction charges the whole [100, 500] gap to the span
    # open when it began; this one follows the host along it.
    assert pt.busy_s == pytest.approx(160e-9) and pt.window_s == pytest.approx(1000e-9)
    assert (pt.iterations, pt.solves, pt.eager_ops) == (1, 1, 1)
    values = program_trace.readings(pt, [], None)
    assert values["control_idle_ms"] == pytest.approx(1e3 * (90e-9 + 550e-9))
    assert values["eager_ops_per_iter"] == 1.0


def test_the_charged_seconds_sum_to_the_stretch_s_idle_time():
    events = [Event(trace.STRETCH, False, 0, 3000)] + request(100) + request(1500) + [
        # Outside every range, overlapping operations, ranges nested three
        # deep, one operation across the stretch's end.
        Event("slp.graph_replay|evaluate", False, 1700, 1800, cid=20),
        Event("slp.factor", False, 1850, 2300, cid=21),
        Event("slp.kkt_factor|4|101|13|float64", False, 1900, 2000, cid=22),
        Event("slp.host_read", False, 2100, 2250, cid=23),
        Event("cudaLaunchKernel", False, 1210, 1220, cid=30),
        Event("kernel_c", True, 1230, 1300, cid=30),
        Event("cudaLaunchKernel", False, 1905, 1910, cid=31),
        Event("kernel_d", True, 1920, 2050, cid=31),
        Event("cudaLaunchKernel", False, 1906, 1912, cid=32),
        Event("kernel_e", True, 2000, 2080, cid=32),
        Event("cudaLaunchKernel", False, 2900, 2910, cid=33),
        Event("kernel_f", True, 2950, 3400, cid=33),
    ]
    pt = program_trace.reduce(events)
    reduction = trace.reduce_events(events)
    assert pt.idle_total_s == pytest.approx(reduction.window_s - reduction.busy_s, rel=1e-12)
    assert pt.idle_total_s == pytest.approx(pt.window_s - pt.busy_s, rel=1e-12)
    assert pt.idle_s[program_trace.OUTSIDE] > 0
    assert pt.idle_s["slp.kkt_factor|4|101|13|float64"] == pytest.approx(20e-9)
    # kernel_c (launched at 1210) and kernel_f (at 2900) ran outside every
    # slp.solve: 70 ns and the 50 ns inside the stretch, of 2 × 160 + 70 +
    # 130 + 80 + 50.
    assert pt.device_s == pytest.approx(650e-9)
    assert pt.outside_solve_device_s == pytest.approx(120e-9)


def test_graph_launches_and_the_eager_runs_of_a_capture_are_not_eager():
    events = [
        Event(trace.STRETCH, False, 0, 1000),
        Event("slp.solve", False, 0, 1000, cid=1),
        Event("slp.iteration", False, 10, 990, cid=2),
        Event("slp.graph_capture|evaluate", False, 100, 300, cid=3),
        Event("cudaLaunchKernel", False, 110, 115, cid=10),  # the capture's warm-up
        Event("warm_up_kernel", True, 120, 130, cid=10),
        Event("slp.graph_replay|evaluate", False, 400, 500, cid=4),
        Event("cudaGraphLaunch", False, 410, 420, cid=11),
        Event("graph_kernel_1", True, 430, 440, cid=11),
        Event("graph_kernel_2", True, 440, 450, cid=11),
        Event("cudaMemcpyAsync", False, 600, 610, cid=12),  # eager
        Event("Memcpy DtoH", True, 615, 620, cid=12),
        Event("aten::add", False, 700, 720, cid=13),  # linked to its operator
        Event("elementwise", True, 730, 740, linked=13),
        Event("cudaLaunchKernel", False, 995, 998, cid=14),  # after the iteration
        Event("late_kernel", True, 999, 1000, cid=14),
        Event("slp.graph_replay|evaluate", True, 430, 450),  # a mirror, not an operation
    ]
    pt = program_trace.reduce(events)
    assert pt.eager_ops == 2 and pt.iterations == 1
    assert pt.busy_s == pytest.approx(10e-9 + 20e-9 + 5e-9 + 10e-9 + 1e-9)


def test_no_program_ranges_read_none_not_zero():
    events = [e for e in [Event(trace.STRETCH, False, 0, 1000)] + request()
              if not e.name().startswith("slp.")]
    assert program_trace.reduce(events) is None
    old_stats = types.SimpleNamespace(iterations=215, host_syncs=1519)
    values = program_trace.readings(None, [old_stats, old_stats], old_stats)
    assert values == dict.fromkeys(values) and len(values) == 6
    # With the program's ranges but no lanes, the lanes' figure stays None.
    pt = program_trace.reduce([Event(trace.STRETCH, False, 0, 1000)] + request())
    stats = types.SimpleNamespace(iterations=1, host_syncs=1, graph_captures=4, capture_s=0.5)
    values = program_trace.readings(pt, [stats, stats], stats)
    assert values["lane_scaling_ms"] is None
    assert values["graph_captures_per_call"] == 4 and values["capture_ms_per_call"] == 500.0
    assert values["setup_capture_s"] == 0.5
