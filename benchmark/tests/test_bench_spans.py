"""The readers of the program's spans and counters: ``harness/spans.py``
on a trace built by hand, and the nine metrics in traced runs of the tiny
copy's cube and fit cells on the CPU."""
import math

import pytest

from benchmark.harness import core, spans
from benchmark.harness.trace import Trace

RUN, OUT = 'rajepy.rt.run', 'rajepy.rt.products_out'
RUN_METRICS = ('rt_dispatch_ms', 'rt_idle_dispatch_ms', 'rt_out_ms',
               'rt_idle_out_ms', 'rt_out_mb_per_run')
FIT_METRICS = ('fit_forward_ms', 'fit_backward_ms', 'fit_optimizer_ms',
               'fit_outside_steps_ms')


def test_host_and_idle_seconds_of_a_hand_built_trace():
    # window 0-100 us; the card busy 10-40 and 80-100 (an operation runs
    # past the window's end), idle 0-10 and 40-80
    device = [('k', 10.0, 30.0), ('k', 25.0, 40.0), ('k', 80.0, 120.0)]
    host = [(RUN, -20.0, 60.0),           # opened before the window
            (OUT, 30.0, 50.0), ('aten::copy_', 31.0, 49.0),
            (RUN, 70.0, 95.0), (OUT, 90.0, 95.0),
            (RUN, 120.0, 130.0)]          # after the window
    tr = Trace(device, host, (0.0, 100.0))
    assert spans.idle(tr) == [(0.0, 10.0), (40.0, 80.0)]
    assert spans.intervals(tr, RUN) == [(0.0, 60.0), (70.0, 95.0)]
    # the run less its copy-out: 0-30, 50-60, 70-90; idle 0-10, 50-60,
    # 70-80
    host_s, idle_s = spans.split(tr, RUN, (OUT,))
    assert host_s == pytest.approx(60e-6) and idle_s == pytest.approx(30e-6)
    # the copy-out: 30-50 and 90-95; idle 40-50
    host_s, idle_s = spans.split(tr, OUT)
    assert host_s == pytest.approx(25e-6) and idle_s == pytest.approx(10e-6)
    # the whole run: idle 0-10, 40-60 and 70-80
    assert spans.split(tr, RUN) == pytest.approx((85e-6, 40e-6))
    assert spans.split(tr, 'rajepy.fit.step') is None


def test_traced_tiny_cells_report_the_span_and_counter_metrics(
        tiny, monkeypatch):
    from rajepy_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, 'COUNTERS', {})
    cube = core.run_cell('example_jet_512.h58a_cube_runs', 2 ** 31 + 21,
                         0.2, True, 'cpu', spec=tiny)
    fits = core.run_cell('example_jet_shipped.h58a_fit', 2 ** 31 + 22, 0.2,
                         True, 'cpu', spec=tiny)
    for out, names in ((cube, RUN_METRICS), (fits, FIT_METRICS)):
        for n in names:
            v = out['metrics'][n]['value']
            assert math.isfinite(v) and v >= 0.0, (n, v)
    m = {n: cube['metrics'][n]['value'] for n in RUN_METRICS}
    # em, tau and flux maps of 24 x 24, 10 channels, in the CPU's float64
    assert m['rt_out_mb_per_run'] == 8 * 24 * 24 * (1 + 2 * 10) / 1e6
    # on the CPU nothing is on a card: the host's spans are all idle
    assert m['rt_idle_out_ms'] == pytest.approx(m['rt_out_ms'])
    assert m['rt_idle_dispatch_ms'] == pytest.approx(m['rt_dispatch_ms'])
    assert 0.0 < m['rt_dispatch_ms']
    assert not set(RUN_METRICS) & set(fits['metrics'])
    assert not set(FIT_METRICS) & set(cube['metrics'])
