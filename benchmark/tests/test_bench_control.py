"""The control of each cell (the reference computed in the precision
below the configuration's, put in the program's place) fails the cell's
limits.  On the card the same tool runs at the cell's own size:
``python3 benchmark/tools/readings.py --workload <cell>
--control-seeds a,b,c``."""
import pytest

from benchmark.tools.readings import control

CELLS = ('example_jet_512.sed16_runs', 'example_jet_512.h58a_cube_runs',
         'example_jet_shipped.h58a_fit', 'example_jet_shipped.sed16_runs')


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('seed', [5, 2 ** 31 + 77])
def test_control_fails_the_limits(tiny, cell, seed):
    limits = tiny.limits(tiny.cell(cell))
    gaps = control(cell, seed, 'cpu', spec=tiny)
    assert set(gaps) == set(limits)
    assert any(gaps[n] > limits[n] for n in limits)
