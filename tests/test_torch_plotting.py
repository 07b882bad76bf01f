"""The port's ``plotting`` and the figures of ``Pipeline.execute``, on the
CPU.

* every function of ``plotting/functions.py`` renders its figure from a
  port model (the JAX plotting tests' 16 x 40 x 16 jet) or a product and
  writes a file of more than 1,000 bytes, as tests/test_plotting.py checks
  the JAX package's; the module has the JAX module's functions;
* ``conservation_profiles``, the profile behind ``diagnostic_plot``,
  tracks the analytic steady state on an inclined, rotated burst-free jet
  (as the JAX test);
* ``Pipeline(jm, params).execute()`` with its defaults (``plot=True``,
  ``simobserve=True``) on one observed continuum epoch writes
  ``GridPlot.pdf``, ``JMLPlot.pdf``, ``ModelPlot.pdf`` and
  ``RadioSED0.0yrPlot.{png,pdf}`` beside the products of
  ``execute(plot=False)``, which are the same files with the same data;
  the figures' time is the stage ``plots``; ``radio_plot``, ``sed_plot``
  and ``timelapse_animation`` draw from the executed pipeline.
"""
import copy
import inspect
import os

import matplotlib
import numpy as np
import pytest

from rajepy_tpu.plotting import functions as jfunc
from rajepy_tpu_torch import JetModel, Pipeline
from rajepy_tpu_torch import constants as cnsts
from rajepy_tpu_torch.io.fits import read_fits
from rajepy_tpu_torch.plotting import functions as pfunc
from rajepy_tpu_torch.utils import profiling
from tests.torch_one_thread import one_thread  # noqa: F401

PLOT_PARAMS = {
    "target": {"name": "plot", "ra": "04:31:34.0", "dec": "+18:08:04.9",
               "epoch": "J2000", "dist": 120., "v_lsr": 6.2, "M_star": 0.55,
               "R_1": .25, "R_2": 2.5},
    "grid": {"n_x": 16, "n_y": 40, "n_z": 16, "l_z": None, "c_size": 0.5},
    "geometry": {"epsilon": 7. / 9., "opang": 25., "w_0": 1., "r_0": 1.,
                 "inc": 90., "pa": 0., "rotation": "CCW"},
    "power_laws": {"q_v": 0., "q_T": 0., "q_x": 0., "q^d_n": 0.,
                   "q^d_T": 0., "q^d_v": 0., "q^d_x": 0.},
    "properties": {"v_0": 150., "x_0": 0.1, "T_0": 1E4, "mu": 1.3,
                   "mlr_bj": 1e-7, "mlr_rj": 5e-8},
    "ejection": {"t_0": np.array([0.5]), "hl": np.array([0.15]),
                 "chi": np.array([5.]), "which": np.array(["B"])},
}
FIGURES = ('GridPlot.pdf', 'JMLPlot.pdf', 'Day0/ModelPlot.pdf',
           'RadioSED0.0yrPlot.png', 'RadioSED0.0yrPlot.pdf')
_PIPELINES = {}


@pytest.fixture(scope='module')
def jm():
    return JetModel(copy.deepcopy(PLOT_PARAMS), device='cpu')


def _check(path):
    assert os.path.exists(path), path
    assert os.path.getsize(path) > 1000, path


class _Run:
    freq = 6e9


def _saved_run(jm, dcy):
    run = _Run()
    run.fits_flux, run.fits_tau, run.fits_em = (
        str(dcy / n) for n in ('Flux.fits', 'Tau.fits', 'EM.fits'))
    jm.flux_ff(6e9, savefits=run.fits_flux)
    jm.optical_depth_ff(6e9, savefits=run.fits_tau)
    jm.emission_measure(savefits=run.fits_em)
    return run


def _uv_set(tmp_path):
    rng = np.random.default_rng(0)
    vis = {'uvw': rng.uniform(-3e4, 3e4, (600, 3)),
           'vis_re': rng.standard_normal((2, 600)),
           'vis_im': rng.standard_normal((2, 600)),
           'freqs': np.array([5e9, 6e9])}
    path = str(tmp_path / 'vis.npz')
    np.savez(path, sigma=0.1, **vis)
    return path, vis


def _gains():
    rng = np.random.default_rng(1)
    return (1 + 0.1 * rng.standard_normal((12, 8)),
            0.1 * rng.standard_normal((12, 8)))


def _colorbars(savefig):
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm
    fig, caxes = plt.subplots(1, 3, figsize=(6, 3))
    pfunc.make_colorbar(caxes[0], 10.0, position='left', numlevels=16,
                        maxticks=[0, 5, 10], minticks=True, hidespines=True)
    pfunc.make_colorbar(caxes[1], 1e3, cmin=1.0,
                        norm=LogNorm(vmin=1.0, vmax=1e3))
    pfunc.make_colorbar(caxes[2], 5.0, orientation='horizontal',
                        position='top', tickformat=lambda v, p: f'{v:.1f}x')
    pfunc.equalise_axes(caxes[0])
    fig.savefig(savefig)
    plt.close(fig)


RENDERS = {
    'model_plot': lambda jm, d: pfunc.model_plot(jm, savefig=d('m.pdf')),
    'rt_plot': lambda jm, d: pfunc.rt_plot(jm, 6e9, savefig=d('rt.pdf')),
    'rt_plot of a run': lambda jm, d: pfunc.rt_plot(
        _saved_run(jm, d.dcy), savefig=d('rt_run.pdf')),
    'rt_plot of (jm, run)': lambda jm, d: pfunc.rt_plot(
        jm, _saved_run(jm, d.dcy), savefig=d('rt_jm_run.pdf')),
    'geometry_plot': lambda jm, d: pfunc.geometry_plot(
        jm, savefig=d('geom.pdf')),
    'jml_profile_plot': lambda jm, d: pfunc.jml_profile_plot(
        jm, savefig=d('jml.pdf')),
    'diagnostic_plot': lambda jm, d: pfunc.diagnostic_plot(
        jm, savefig=d('diag.pdf')),
    'plot_mass_volume_slices': lambda jm, d: pfunc.plot_mass_volume_slices(
        jm, savefig=d('mv.pdf')),
    'radio_plot': lambda jm, d: pfunc.radio_plot(
        jm, _saved_run(jm, d.dcy), savefig=d('radio.pdf')),
    'uv_plot': lambda jm, d: pfunc.uv_plot(_uv_set(d.dcy)[0],
                                           savefig=d('uv.png')),
    'uv_plot of a mapping': lambda jm, d: pfunc.uv_plot(
        _uv_set(d.dcy)[1], max_points=100, savefig=d('uv2.png')),
    'gain_plot': lambda jm, d: pfunc.gain_plot(*_gains(),
                                               savefig=d('gains.png')),
    'gain_plot of a bandpass': lambda jm, d: pfunc.gain_plot(
        *(g[None].repeat(5, 0) for g in _gains()), savefig=d('bp.png')),
    'make_colorbar and equalise_axes': lambda jm, d: _colorbars(
        d('cbar.png')),
}


class _Dest:
    """``d(name)``: a path under the test's directory, remembered."""

    def __init__(self, dcy):
        self.dcy = dcy
        self.paths = []

    def __call__(self, name):
        self.paths.append(str(self.dcy / name))
        return self.paths[-1]


@pytest.mark.parametrize("name", list(RENDERS))
def test_plotting_function_writes_its_figure(jm, tmp_path, name):
    jm.time = 0.6 * cnsts.YEAR
    dest = _Dest(tmp_path)
    RENDERS[name](jm, dest)
    assert dest.paths
    for path in dest.paths:
        _check(path)
    if name == 'rt_plot':
        with pytest.raises(TypeError):
            pfunc.rt_plot(jm)       # no frequency and no products


def test_plotting_module_has_the_jax_modules_functions():
    """The copy draws with the Agg backend and keeps every function of the
    JAX module, with the same signature."""
    assert matplotlib.get_backend().lower() == 'agg'
    names = [n for n, f in inspect.getmembers(jfunc, inspect.isfunction)
             if f.__module__ == jfunc.__name__]
    assert len(names) > 15
    for name in names:
        assert inspect.signature(getattr(pfunc, name)) == \
            inspect.signature(getattr(jfunc, name)), name


def test_conservation_profiles_match_steady_state():
    """The r-binned mass profile behind diagnostic_plot tracks jml * dr /
    v(r) on an inclined, rotated jet (the JAX plotting test's case;
    tests/test_torch_diagnostics.py holds the profile against the JAX
    package's)."""
    params = copy.deepcopy(PLOT_PARAMS)
    params['ejection'] = {'t_0': np.array([]), 'hl': np.array([]),
                          'chi': np.array([]), 'which': np.array([])}
    params['grid'] = {'n_x': 32, 'n_y': 32, 'n_z': 96, 'l_z': None,
                      'c_size': 0.5}
    params['geometry'].update(inc=80.0, pa=10.0)
    m = JetModel(copy.deepcopy(params), device='cpu')
    prof = m.conservation_profiles()
    rs, mass = prof['r'], prof['mass']
    v0 = params['properties']['v_0']    # q_v == 0: constant speed
    for which, sgn in (('B', 1.0), ('R', -1.0)):
        expect = m.ss_jml(which) * m.csize * cnsts.AU / (v0 * 1e3)
        sel = (sgn * rs > 3 * params['geometry']['r_0']) & \
            (np.abs(rs) < 96 * 0.5 / 3)
        assert mass[sel].size > 10
        np.testing.assert_allclose(mass[sel], expect, rtol=0.15)
    assert np.all(prof['angmom'][mass > 0] > 0)


def _pipeline_params(dcy):
    return {
        'min_el': 20.,
        'dcys': {'model_dcy': str(dcy)},
        'continuum': {'times': np.array([0.]), 'freqs': np.array([6e9]),
                      't_obs': np.array([1800]),
                      'tscps': np.array([('VLA', 'A')]),
                      't_ints': np.array([120]), 'bws': np.array([1e8]),
                      'chanws': np.array([1e8])},
        'rrls': {'times': np.array([]), 'lines': None, 't_obs': None,
                 'tscps': None, 't_ints': None, 'bws': None,
                 'chanws': None},
    }


def _executed(which, root):
    """The observed one-epoch campaign executed with ``execute()``'s
    defaults ('defaults') or with ``plot=False``, kept for the module."""
    if which not in _PIPELINES:
        pl = Pipeline(JetModel(copy.deepcopy(PLOT_PARAMS), device='cpu'),
                      _pipeline_params(root / which))
        profiling.collect_stage_times(True)
        try:
            if which == 'defaults':
                pl.execute(verbose=False)
            else:
                pl.execute(verbose=False, plot=False)
            stages = profiling.stage_times()
        finally:
            profiling.collect_stage_times(False)
        _PIPELINES[which] = pl, stages
    return _PIPELINES[which]


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return tmp_path_factory.mktemp('plotting_pipeline')


def _files(dcy):
    return sorted(os.path.relpath(os.path.join(d, n), dcy)
                  for d, _, names in os.walk(dcy) for n in names
                  if not n.endswith('.log'))


def test_execute_with_its_defaults_writes_the_figures(root):
    pl, stages = _executed('defaults', root)
    pl_np, stages_np = _executed('no plots', root)
    assert all(r.completed and r.simobserve for r in pl.runs)
    for name in FIGURES:
        _check(os.path.join(pl.dcy, name))
    # beside the figures, the products of execute(plot=False)
    files = _files(pl.dcy)
    assert sorted(set(files) - set(FIGURES)) == _files(pl_np.dcy)
    fits = [n for n in files if n.endswith('.fits')]
    assert len(fits) == 4          # EM, Tau, Flux and the restored image
    for name in fits:
        np.testing.assert_array_equal(
            read_fits(os.path.join(pl.dcy, name))[0],
            read_fits(os.path.join(pl_np.dcy, name))[0])
    assert stages['plots'] > 0 and 'plots' not in stages_np
    assert pl.runs[0].results['imfit']['I']['val'] > 0


def test_radio_plot_sed_plot_and_timelapse(root, tmp_path):
    pl, _ = _executed('defaults', root)
    f = str(tmp_path / 'radio.pdf')
    pl.radio_plot(pl.runs[0], savefig=f)
    _check(f)
    f = str(tmp_path / 'sed.png')
    pfunc.sed_plot(pl, 0.0, savefig=f)
    _check(f)
    _check(f[:-4] + '.pdf')
    assert pfunc.sed_plot(pl, 7.0, savefig=str(tmp_path / 'none.png')) \
        is None
    f = str(tmp_path / 'movie.gif')
    pfunc.timelapse_animation(pl, savefig=f)
    assert os.path.exists(f) or os.path.isdir(str(tmp_path / 'movie'))
