"""The end-to-end metrics' arithmetic: a rate and a tail over all the
requests and all the time of the window, a fit's time per step."""
import statistics

import pytest

from benchmark.harness import core, stats


def test_rate_is_over_the_whole_window():
    assert stats.rate(30, 2.5) == 12.0
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


@pytest.mark.parametrize('n,want', [(100, 95), (20, 19), (1, 1), (21, 20),
                                    (200, 190)])
def test_p95_is_the_nearest_rank_over_all_values(n, want):
    values = list(range(n, 0, -1))
    assert stats.p95(values) == want


def test_p95_counts_every_slow_request():
    fast = [1.0] * 94
    assert stats.p95(fast + [50.0] * 6) == 50.0
    assert stats.p95(fast + [1.0] + [50.0] * 5) == 1.0


def test_fit_step_time_is_window_over_steps():
    win = {'window_s': 10.0, 'units': 40}
    assert core.END_TO_END['fit_step_ms'](win) == 250.0
    with pytest.raises(ValueError):
        stats.per_step_ms(1.0, 0)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 30.0, 9.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


class _Fake:
    unit = 'run'

    def __init__(self, fail_every=0):
        self.n, self.fail_every = 0, fail_every

    def request(self):
        self.n += 1
        if self.fail_every and self.n % self.fail_every == 0:
            raise RuntimeError("a failed request")
        return 1


def test_window_counts_all_requests_and_failures(capsys):
    win = core._serve(_Fake(fail_every=4), 0.0, n_requests=12)
    assert win['attempted'] == 12 and win['failed'] == 3
    assert win['done'] == len(win['latencies']) == 9
    assert win['units'] == 9
    assert win['window_s'] >= sum(win['latencies'])
    e2e = core.END_TO_END
    win['peak_bytes'] = 2 ** 31
    assert e2e['runs_per_s'](win) == pytest.approx(9 / win['window_s'])
    assert e2e['run_p95_ms'](win) == pytest.approx(
        stats.p95(win['latencies']) * 1e3)
    assert e2e['peak_mem_gib'](win) == 2.0


def test_window_runs_until_its_seconds_have_passed():
    win = core._serve(_Fake(), 0.05)
    assert win['window_s'] >= 0.05 and win['done'] == win['attempted'] > 1
