"""A run of each kind of cell, the harness's look for a card skipped and
the timed path broken underneath, comes out not correct: for each fault the
cell can have (a step that leaves its state unchanged, half of the batch
left out, an answer altered where it is produced; for the fit also a
wrong sign of one gradient and an optimizer that stops after its first
steps).  One card per cell: no
exchange between cards to leave out.  The unbroken run comes out
correct."""
import numpy as np
import pytest
import torch

from benchmark.harness import core

RUNS = ('example_jet_shipped.sed16_runs', 'example_jet_512.h58a_cube_runs')
FIT = 'example_jet_shipped.h58a_fit'


def _run(spec, cell, seed=7):
    return core.run_cell(cell, seed, 0.2, False, 'cpu', spec=spec)


def _stale_epoch(mp):
    from rajepy_tpu_torch import JetModel
    mp.setattr(JetModel, 'time', property(lambda s: s._time,
                                          lambda s, v: None))


def _altered_flux(mp):
    from rajepy_tpu_torch.ops import radtrans
    orig = radtrans.flux_ff_maps

    def flux(*a, **k):
        out = orig(*a, **k).clone()
        out[0] *= 1.05
        return out
    mp.setattr(radtrans, 'flux_ff_maps', flux)


def _half_channels(mp):
    from rajepy_tpu_torch import JetModel

    def half(orig):
        def call(self, *a, **k):
            a = list(a)
            i = 1 if orig.__name__ == 'rrl_rt_products' else 0
            f = a[i]
            a[i] = f[:len(f) // 2]
            em, tau, flux = orig(self, *a, **k)
            return em, np.concatenate([tau, tau]), np.concatenate([flux, flux])
        return call
    for name in ('continuum_rt_products', 'rrl_rt_products'):
        mp.setattr(JetModel, name, half(getattr(JetModel, name)))


def _adam_unchanged(mp):
    from rajepy_tpu_torch.fit import driver
    mp.setattr(driver.Adam, 'step', lambda self, closure=None: None)


def _adam_stops_late(mp):
    """Adam's state left unchanged from the fit's third step on."""
    from rajepy_tpu_torch.fit import driver
    orig = driver.Adam.step

    def step(self, closure=None):
        st = self.state[self.param_groups[0]['params'][0]]
        if st and st['count'] >= 2:
            return None
        return orig(self, closure)
    mp.setattr(driver.Adam, 'step', step)


def _flipped_velocity_gradient(mp):
    """The optimizer given v_lsr's gradient with the wrong sign."""
    from rajepy_tpu_torch.fit import driver
    orig = driver._grad

    def grad(value, theta):
        g = orig(value, theta).clone()
        g[1] = -g[1]
        return g
    mp.setattr(driver, '_grad', grad)


def _forward(mp, edit):
    from rajepy_tpu_torch.fit import rrl
    orig = rrl.build_rrl_spectrum_forward

    def build(*a, **k):
        fwd, th0 = orig(*a, **k)
        return (lambda theta: edit(fwd(theta))), th0
    mp.setattr(rrl, 'build_rrl_spectrum_forward', build)


def _altered_spectrum(mp):
    _forward(mp, lambda s: s * (1.0 + 1e-6))


def _half_spectrum(mp):
    def edit(s):
        n = s.shape[0] // 2
        return torch.cat([s[:n], s[:s.shape[0] - n]])
    _forward(mp, edit)


@pytest.mark.parametrize('cell', RUNS + (FIT,))
def test_unbroken_run_is_correct(tiny, cell):
    out = _run(tiny, cell)
    assert out['correct'] and out['failed'] == 0


@pytest.mark.parametrize('cell', RUNS)
@pytest.mark.parametrize('fault', [_stale_epoch, _altered_flux,
                                   _half_channels])
def test_broken_runs_are_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not _run(tiny, cell)['correct']


@pytest.mark.parametrize('fault', [_adam_unchanged, _altered_spectrum,
                                   _half_spectrum, _adam_stops_late,
                                   _flipped_velocity_gradient])
def test_broken_fits_are_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    assert not _run(tiny, FIT)['correct']


def test_fit_gradients_are_compared_with_their_sign():
    from benchmark.kinds.rrl_fit import leaf_gap
    want = np.array([[-2.0, 1e-3], [-1.5, -2e-3]])
    assert leaf_gap(want, want) == 0.0
    flipped = want * np.array([1.0, -1.0])
    assert leaf_gap(flipped, want) > 1e-3
