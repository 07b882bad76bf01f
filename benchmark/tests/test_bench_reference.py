"""The plain reference against scipy's Faddeeva function and against the
port at 16^3 in float64: the continuum and RRL maps, the Gaunt factor and
the RRL fit's loss and gradient."""
import copy

import numpy as np
import pytest
import scipy.special as sp
import torch

from benchmark.harness.workloads import channels, model_params
from benchmark.reference import faddeeva, gaunt
from benchmark.reference.jet import Jet, Line
from benchmark.reference.rrl_fit import LineFit, theta_of

YEAR = 31536000.0


@pytest.fixture(scope='module')
def params():
    from benchmark.harness.core import Spec
    p = model_params(Spec().config({'config': 'example_jet_shipped'}))
    p['grid'] = dict(p['grid'], n_x=16, n_y=16, n_z=16, l_z=None)
    return p


def _model(params):
    from rajepy_tpu_torch import JetModel
    from rajepy_tpu_torch.utils.logger import Log
    return JetModel(copy.deepcopy(params), log=Log('/dev/null', False),
                    device='cpu', dtype=torch.float64)


def _gap(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize('lo,hi,rtol', [(0.0, 3.0, 1e-11), (3.0, 12.0, 1e-6),
                                        (12.0, 200.0, 1e-13)])
def test_faddeeva_matches_scipy(lo, hi, rtol):
    rng = np.random.default_rng(1)
    x = rng.uniform(-hi, hi, 40000)
    y = 10 ** rng.uniform(-8, 1.2, 40000)
    keep = (np.abs(x) + y >= lo) & (np.abs(x) + y < hi)
    x, y = x[keep], y[keep]
    want = sp.wofz(x + 1j * y)
    wr, wi = faddeeva.wofz(torch.tensor(x), torch.tensor(y))
    assert np.max(np.abs(wr.numpy() - want.real) / np.abs(want.real)) < rtol
    assert np.max(np.abs(wi.numpy() - want.imag) / np.abs(want)) < 1e-12
    assert np.max(np.abs(wr.numpy() - want.real)) < 4e-15


def test_voigt_gradient_matches_differences():
    x = torch.tensor([0.3, 2.5, 7.0, 15.0], dtype=torch.float64,
                     requires_grad=True)
    y = torch.tensor([0.01, 0.2, 1.0, 0.5], dtype=torch.float64,
                     requires_grad=True)
    torch.autograd.gradcheck(faddeeva.re_w, (x, y), eps=1e-6, atol=1e-9)


def test_gaunt_matches_the_port():
    from rajepy_tpu_torch.ops import gaunt as port
    f = torch.as_tensor(np.geomspace(3e8, 3e11, 16), dtype=torch.float64)
    for t in (7000.0, 1e4, 2.3e4):
        assert torch.allclose(gaunt.gff(f, t), port.gff(f, t), rtol=1e-14)


@pytest.mark.parametrize('t_yr', [0.7, 2.0, 4.1])
def test_continuum_matches_the_port(params, t_yr):
    jm = _model(params)
    jm.time = t_yr * YEAR
    freqs = np.geomspace(3e8, 3e11, 16)
    got = jm.continuum_rt_products(freqs)
    want = Jet(params).continuum([t_yr * YEAR], freqs)[0]
    for g, w in zip(got, want):
        assert _gap(g, w) < 1e-13


@pytest.mark.parametrize('t_yr,contsub', [(0.7, False), (2.0, True),
                                          (4.1, False)])
def test_rrl_matches_the_port(params, t_yr, contsub):
    jm = _model(params)
    jm.time = t_yr * YEAR
    freqs = channels({'bandwidth_hz': 2e7, 'chanwidth_hz': 1e6},
                     Line('H58a').nu0)
    got = jm.rrl_rt_products('H58a', freqs, contsub=contsub)
    want = Jet(params).rrl('H58a', [t_yr * YEAR], freqs, contsub)[0]
    for g, w in zip(got, want):
        assert _gap(g, w) < 1e-11


def test_rrl_fit_loss_and_gradient_match_the_port(params):
    from rajepy_tpu_torch.fit.driver import _power_norm_loss
    from rajepy_tpu_torch.fit.rrl import build_rrl_spectrum_forward
    freqs = channels({'relative': [-4e-4, 4e-4, 17]}, Line('H58a').nu0)
    t = 2.0 * YEAR
    truth = {'properties.T_0': 7000.0, 'target.v_lsr': 25.0}
    start = {'properties.T_0': 1.1e4, 'target.v_lsr': 5.0}
    ref = LineFit(params, 'H58a', freqs, t)
    with torch.no_grad():
        obs = ref.spectrum(torch.as_tensor(theta_of(truth))).numpy()
    loss, grad = ref.loss_grad(theta_of(start), obs)
    p = copy.deepcopy(params)
    p['properties'] = dict(p['properties'], T_0=1.1e4)
    p['target'] = dict(p['target'], v_lsr=5.0)
    jm = _model(p)
    jm.time = t
    fwd, th0 = build_rrl_spectrum_forward(jm, 'H58a', freqs, tuple(start))
    th = th0.clone().requires_grad_(True)
    val = _power_norm_loss(obs, None, 'cpu')(fwd(th))
    g, = torch.autograd.grad(val, th)
    assert abs(float(val.detach()) - loss) / loss < 1e-12
    assert np.allclose(g.numpy(), grad, rtol=1e-10, atol=0)
