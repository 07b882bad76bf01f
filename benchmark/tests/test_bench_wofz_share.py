"""The reader of ``fit_wofz_kernel_share``: on made-up counters, and in a
traced run of the tiny copy's fit cell on the CPU, where every Faddeeva
evaluation takes the plain version."""
import pytest

from benchmark.harness import core

NAME = 'fit_wofz_kernel_share'


@pytest.mark.parametrize('counters,want', [
    ({}, None),                              # a program without them
    ({'voigt.wofz_evals': 0}, None),
    ({'voigt.wofz_evals': 34}, 0.0),         # all plain (the CPU)
    ({'voigt.wofz_evals': 34, 'voigt.wofz_kernel': 34}, 100.0),
    ({'voigt.wofz_evals': 40, 'voigt.wofz_kernel': 30}, 75.0),
    ({'rt.runs': 3}, None),
])
def test_share_of_made_up_counters(monkeypatch, counters, want):
    from rajepy_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, 'COUNTERS', dict(counters))
    assert core.reader(NAME)(None) == want


def test_share_is_none_where_the_program_keeps_no_counters(monkeypatch):
    from rajepy_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, 'COUNTERS')
    assert core.reader(NAME)(None) is None


def test_traced_tiny_fit_on_the_cpu_reads_no_kernel(tiny, monkeypatch):
    from rajepy_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, 'COUNTERS', {})
    out = core.run_cell('example_jet_shipped.h58a_fit', 2 ** 31 + 2101, 0.2,
                        True, 'cpu', spec=tiny)
    assert out['metrics'][NAME] == {'value': 0.0, 'unit': '%'}
    assert profiling.COUNTERS['voigt.wofz_evals'] > 0
