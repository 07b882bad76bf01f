"""The rooflines' work is counted from the cell's own inputs (its jet,
channels and map sizes), not from anything the program made."""
import inspect

import pytest
import torch

from benchmark.counts import epoch_maps, rrl_maps
from benchmark.harness.workloads import model_params
from benchmark.reference.jet import Jet, Line


def _params(tiny, name='example_jet_512'):
    return model_params(tiny.config({'config': name}))


def _jet_cells(params):
    jet = Jet(params)
    s = jet.slab(0, jet.nx, torch.float64, 'cpu')
    return jet, int(s['inside'].sum()), int((s['inside'] & s['red']).sum())


def test_k2_counts_the_jet_cells_and_maps(tiny):
    p = _params(tiny)
    jet, cells, red = _jet_cells(p)
    n_bytes, ops = epoch_maps.k2(p, 'cpu')
    assert n_bytes == 12 * cells + 8 * jet.nx * jet.nz
    n_red = sum(b[3] for b in jet.bursts)
    assert ops == red * (6 + 6 * n_red) + (cells - red) * (
        6 + 6 * (len(jet.bursts) - n_red))
    # nothing of the program enters the count
    assert 'rajepy_tpu_torch' not in inspect.getsource(epoch_maps)


def test_k2_follows_the_configuration(tiny):
    p = _params(tiny)
    wider = _params(tiny)
    wider['grid'] = dict(wider['grid'], n_x=32)
    assert epoch_maps.k2(wider, 'cpu')[0] > epoch_maps.k2(p, 'cpu')[0]


def test_k4_counts_pairs_channels_and_maps(tiny):
    p = _params(tiny)
    jet, cells, _ = _jet_cells(p)
    nu0 = Line('H58a').nu0
    few = [nu0 + d for d in (-2e6, 0.0, 2e6)]
    many = [nu0 + d * 1e5 for d in range(-30, 30)]
    for freqs in (few, many):
        n_bytes, ops = rrl_maps.k4(p, 'H58a', freqs, 3.0e7, 'cpu')
        n = len(freqs)
        assert n_bytes == 16 * cells + 4 * n + 4 * n * jet.nx * jet.nz
        pairs = cells * n
        assert pairs * 43 <= ops <= pairs * 108
    assert 'rajepy_tpu_torch' not in inspect.getsource(rrl_maps)


@pytest.mark.parametrize('epoch', [0.0, 6.3e7])
def test_k4_far_wings_cost_the_least(tiny, epoch):
    p = _params(tiny)
    _, cells, _ = _jet_cells(p)
    nu0 = Line('H58a').nu0
    _, core = rrl_maps.k4(p, 'H58a', [nu0], epoch, 'cpu')
    _, wing = rrl_maps.k4(p, 'H58a', [nu0 + 5e8], epoch, 'cpu')
    assert wing == cells * (10 + 33)
    assert cells * (10 + 98) >= core >= wing
