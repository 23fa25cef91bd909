"""The roofline counts the mathematics, not the implementation: the span
around `BandedBackend._chain_factor` names the same (B, K, w) for the
chain, the partitioned form, BCR and the explicit inverse, so each form
is read against one count; and the reduction charges a device operation
to the spans open when it was launched.

Run: python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import types

import pytest
import torch

from perfbench import roofline, trace


def staged_system(B, K, w, seed=0):
    """Well-conditioned symmetric staged systems: D (B, K, w, w), E (B, K-1, w, w)."""
    g = torch.Generator().manual_seed(seed)
    D = torch.randn(B, K, w, w, generator=g, dtype=torch.float64)
    D = D + D.transpose(-1, -2) + 4.0 * w * torch.eye(w, dtype=torch.float64)
    E = 0.1 * torch.randn(B, K - 1, w, w, generator=g, dtype=torch.float64)
    return D, E


@pytest.mark.parametrize("form", ["chain", "partitioned", "bcr", "inv"])
def test_every_factor_form_is_read_against_one_count(form):
    from sleipnir_tpu_torch.optimization.solver.kkt_banded import EPS_INERTIA, BandedBackend

    B, K, w = 4, 33, 5
    backend = types.SimpleNamespace(
        mesh=None, use_bcr=form == "bcr", use_inv=form == "inv",
        use_partitioned=form == "partitioned", eps_inertia=EPS_INERTIA, K=K,
    )
    D, E = staged_system(B, K, w)
    with trace.Spans(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fac, (pos, neg, zero), _piv = BandedBackend._chain_factor(backend, D, E)
        b = torch.ones(B, K, w, dtype=torch.float64)
        BandedBackend.chain_solve(backend, fac, b)
    names = sorted({e.name() for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(trace.PREFIX + "kkt_")})
    assert names == [f"pb.kkt_factor|{B}|{K}|{w}|float64", f"pb.kkt_solve|{B}|{K}|{w}|1|float64"]
    assert (pos == K * w).all() and (neg == 0).all() and (zero == 0).all()
    least = roofline.least_seconds(*roofline.factor_work(B, K, w, "float64"), "float64")
    assert trace._least_seconds(names[0]) == least


def test_the_counts_follow_the_shape_alone():
    nbytes, ops = roofline.factor_work(4, 101, 13, "float64")
    assert nbytes == 2 * 4 * 201 * 169 * 8
    assert ops == 4 * (101 * 2 / 3 * 13**3 + 100 * 4 * 13**3)
    nbytes, ops = roofline.solve_work(1, 5001, 4, 1, "float64")
    assert nbytes == (10001 * 16 + 2 * 5001 * 4) * 8
    assert ops == 4 * 5001 * 16 + 4 * 5000 * 16
    # Every count at the cells' shapes (serial and 8 lanes) is bound by bytes.
    for shape in ((4, 101, 13), (32, 101, 13)):
        nbytes, ops = roofline.factor_work(*shape, "float64")
        assert nbytes / roofline.HBM_BYTES_PER_S > ops / roofline.PEAK_OPS_PER_S["float64"]


class Event:
    """A raw profiler event as `reduce_events` reads it."""

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


def test_the_reduction_charges_operations_to_their_spans():
    events = [
        Event(trace.STRETCH, False, 0, 1000, cid=1),
        Event("pb.factor", False, 100, 400, cid=2),
        Event("pb.kkt_factor|4|101|13|float64", False, 150, 250, cid=3),
        Event("aten::add", False, 160, 170, cid=4),
        Event("aten::mul", False, 350, 360, cid=5),
        Event("aten::sub", False, 600, 610, cid=6),
        Event("kernel_a", True, 200, 300, linked=4),  # inside kkt_factor and factor
        Event("kernel_b", True, 400, 450, linked=5),  # inside factor
        Event("kernel_c", True, 700, 800, linked=6),  # outside every span
        Event("pb.factor", True, 100, 450),  # the range mirrored on the device
        Event("cudaGraphLaunch", False, 380, 390, cid=77),
        Event("kernel_d", True, 460, 470, cid=77),  # a graph's, launched inside factor
    ]
    r = trace.reduce_events(events)
    assert r.span_s == pytest.approx({"factor": 160e-9, "kkt_factor": 100e-9})
    assert (r.device_events, r.attributed) == (4, 4)
    assert len(r.factor_calls) == 1
    assert r.factor_calls[0] == pytest.approx((trace._least_seconds(events[2].name()), 100e-9))
    assert r.busy_s == pytest.approx(260e-9) and r.window_s == pytest.approx(1000e-9)
    assert dict((n, s) for n, s in r.idle_gaps) == pytest.approx(
        {"outside_the_spans": 200e-9 + 10e-9 + 230e-9 + 200e-9, "factor": 100e-9})
    assert [n for n, _s in r.device_ops] == ["kernel_a", "kernel_c", "kernel_b", "kernel_d"]
