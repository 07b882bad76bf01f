"""The reader of ``rrl_flux_kernel_share``: on made-up counters, and in a
traced run of the tiny copy's cube cell on the CPU, where every channel
stage takes the plain version."""
import pytest

from benchmark.harness import core

NAME = 'rrl_flux_kernel_share'


@pytest.mark.parametrize('counters,want', [
    ({}, None),                              # a program without them
    ({'rt.rrl_flux_stages': 0}, None),
    ({'rt.rrl_flux_stages': 12}, 0.0),       # all plain (the CPU)
    ({'rt.rrl_flux_stages': 12, 'rt.rrl_flux_kernel': 12}, 100.0),
    ({'rt.rrl_flux_stages': 40, 'rt.rrl_flux_kernel': 30}, 75.0),
    ({'rt.runs': 3}, None),                  # runs, but no LTE line stage
])
def test_share_of_made_up_counters(monkeypatch, counters, want):
    from rajepy_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, 'COUNTERS', dict(counters))
    assert core.reader(NAME)(None) == want


def test_share_is_none_where_the_program_keeps_no_counters(monkeypatch):
    from rajepy_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, 'COUNTERS')
    assert core.reader(NAME)(None) is None


def test_traced_tiny_cube_on_the_cpu_reads_no_kernel(tiny, monkeypatch):
    from rajepy_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, 'COUNTERS', {})
    out = core.run_cell('example_jet_512.h58a_cube_runs', 2 ** 31 + 2301,
                        0.2, True, 'cpu', spec=tiny)
    assert out['metrics'][NAME] == {'value': 0.0, 'unit': '%'}
    assert profiling.COUNTERS['rt.rrl_flux_stages'] > 0
