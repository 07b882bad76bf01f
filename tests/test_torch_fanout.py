"""The port's run fan-out (``parallel.fanout``), ``Pipeline.execute``'s
``device_fanout``, channel-sharded cube imaging and ``fit``'s ``mesh=``,
on the CPU.

The device list (``parallel.sharding.available_devices``) is replaced for
a test with several CPU shards; some are ``torch.device('cpu', 0)``, which
torch treats as another device than ``'cpu'`` (``Tensor.to`` copies), so
the paths that copy a model's statics to a shard's device and build a
fit's forward there run too.  Products against the port's sequential path
bit for bit; the pipeline's against the JAX package's fanned pipeline on
the session's 8 virtual devices, to 1e-9 (continuum) and 1e-6 (RRL), the
parity contract of ``tests/test_torch_pipeline.py``.
"""
import copy
import os

import numpy as np
import pytest
import torch
import jax

import rajepy_tpu
import rajepy_tpu_torch
from rajepy_tpu.io.fits import read_fits
from rajepy_tpu.parallel import fanout as jfan
from rajepy_tpu_torch import fit, synthobs as tsyn
from rajepy_tpu_torch.ops import radtrans as trt
from rajepy_tpu_torch.parallel import fanout as tfan, sharding as tsh
from tests.torch_one_thread import one_thread  # noqa: F401

CPU, CPU0 = torch.device('cpu'), torch.device('cpu', 0)
SHARDS = [CPU, CPU0, CPU, CPU0]
YEAR = 31536000.0
PRODUCTS = ('fits_em', 'fits_tau', 'fits_flux')
TOL = (1e-9, 1e-6)          # continuum, RRL
QUIET = dict(simobserve=False, verbose=False, plot=False)


@pytest.fixture
def shards(monkeypatch):
    """Four shards on the CPU for the block of a test."""
    monkeypatch.setattr(tsh, 'available_devices', lambda device: SHARDS)
    return SHARDS


def _small(model_params, n=(16, 32, 16)):
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=n[0], n_y=n[1], n_z=n[2], l_z=None)
    return p


def _rel(got, want):
    got = np.nan_to_num(np.asarray(got, dtype=float))
    want = np.nan_to_num(np.asarray(want, dtype=float))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    return np.abs(got - want).max() / scale


def _logged(pl, text):
    return [str(e) for e in pl.log.entries.values() if text in str(e)]


# --------------------------------------------------------------------------- #
# the fan-out functions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_continuum_runs_fanout(model_params, shards, dtype):
    """3 runs over 4 shards: each run's continuum_rt_products bit for bit;
    in float64 the JAX package's fan-out within 1e-12."""
    p = _small(model_params)
    tm = rajepy_tpu_torch.JetModel(copy.deepcopy(p), device='cpu',
                                   dtype=getattr(torch, dtype))
    years = np.array([0.0, 0.5, 1.0])
    freqs_mat = np.stack([np.array([6e9, 1e10])] * 3)
    got = tfan.continuum_runs_fanout(tm, years, freqs_mat)
    assert got[0].shape == (3, 16, 16) and got[2].shape == (3, 2, 16, 16)
    assert set(tm._replicas) == {CPU, CPU0}
    for k, yr in enumerate(years):
        tm.time = yr * YEAR
        for g, w in zip(got, tm.continuum_rt_products(freqs_mat[k])):
            np.testing.assert_array_equal(g[k], w)
    if dtype == 'float64':
        want = jfan.continuum_runs_fanout(rajepy_tpu.JetModel(p), years,
                                          freqs_mat)
        for g, w in zip(got, want):
            assert _rel(g, w) < 1e-12


@pytest.mark.parametrize('lte', [True, False])
def test_rrl_runs_fanout(model_params, shards, lte):
    """LTE, and non-LTE with per-run departure coefficients: each run's
    rrl_rt_products bit for bit, and the JAX package's fan-out."""
    p = _small(model_params)
    tm = rajepy_tpu_torch.JetModel(copy.deepcopy(p), device='cpu')
    jm = rajepy_tpu.JetModel(p)
    nu0 = trt.RRLCoeffs('H58a').nu0
    years = np.array([0.0, 0.8])
    freqs_mat = np.stack([np.linspace(nu0 * 0.9999, nu0 * 1.0001, 4)] * 2)
    b_pairs = None
    if not lte:
        b_pairs = []
        for yr in years:
            tm.time = yr * YEAR
            b_pairs.append(tm.departure_coefficients('H58a'))
    got = tfan.rrl_runs_fanout(tm, 'H58a', years, freqs_mat,
                               b_pairs=b_pairs)
    want = jfan.rrl_runs_fanout(jm, 'H58a', years, freqs_mat,
                                b_pairs=b_pairs)
    for k, yr in enumerate(years):
        tm.time = yr * YEAR
        for g, w in zip(got, tm.rrl_rt_products('H58a', freqs_mat[k],
                                                lte=lte)):
            np.testing.assert_array_equal(g[k], w)
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL[1]
    with pytest.raises(ValueError, match='b_pairs shape'):
        tfan.rrl_runs_fanout(tm, 'H58a', years, freqs_mat,
                             b_pairs=[(1.0, 1.0)])


def test_run_mesh_and_defaults(model_params):
    """One CPU device: the run mesh holds it alone; the fan-out then runs
    every run on the model's statics, copying nothing."""
    mesh = tfan.run_mesh(device='cpu')
    assert mesh.axis_names == ('run',) and list(mesh.devices) == [CPU]
    two = tsh.make_mesh(n_los=2, n_chan=1, devices=[CPU, CPU0])
    assert list(tfan.run_mesh(two).devices) == [CPU, CPU0]
    tm = rajepy_tpu_torch.JetModel(_small(model_params), device='cpu')
    em, _, _ = tfan.continuum_runs_fanout(tm, [0.5], [[6e9]])
    rep = tm._replicas[CPU]
    assert rep._rt_static().a is tm._rt_static().a


@pytest.mark.parametrize('path', ['execute', 'continuum_runs_fanout',
                                  'rrl_runs_fanout'])
def test_each_run_is_copied_out_once_by_its_model(model_params, shards,
                                                 monkeypatch, tmp_path,
                                                 path):
    """The sequential ``Pipeline.execute`` and both fan-outs hand each
    run's maps to ``JetModel.products_to_host`` once, of the model (or of
    the shard's replica of it) that computed them, and write or return
    what it hands back: each run's direct products bit for bit."""
    tm = rajepy_tpu_torch.JetModel(_small(model_params), device='cpu')
    to_host = rajepy_tpu_torch.JetModel.products_to_host
    calls = []

    def spy(model, maps):
        out = to_host(model, maps)
        calls.append((model, [a.copy() for a in out]))
        return out

    monkeypatch.setattr(rajepy_tpu_torch.JetModel, 'products_to_host', spy)
    nu0 = trt.RRLCoeffs('H58a').nu0
    years = np.array([0.0, 0.5, 1.0])
    if path == 'execute':
        pl = rajepy_tpu_torch.Pipeline(tm, _pline(tmp_path / 'out'))
        pl.execute(device_fanout=False, **QUIET)
        runs = [(r.year, r.chan_freqs, r.line if r.obs_type != 'continuum'
                 else None, getattr(r, 'lte', True)) for r in pl.runs]
        assert all(model is tm for model, _ in calls)
    else:
        if path == 'continuum_runs_fanout':
            freqs_mat = np.stack([np.array([6e9, 1e10])] * 3)
            got = tfan.continuum_runs_fanout(tm, years, freqs_mat)
            runs = [(yr, f, None, True) for yr, f in zip(years, freqs_mat)]
        else:
            freqs_mat = np.stack(
                [np.linspace(nu0 * 0.9999, nu0 * 1.0001, 4)] * 3)
            got = tfan.rrl_runs_fanout(tm, 'H58a', years, freqs_mat)
            runs = [(yr, f, 'H58a', True) for yr, f in zip(years, freqs_mat)]
        assert [model for model, _ in calls] == \
            [tm._replicas[d] for d in SHARDS[:3]]
        for k, (_, out) in enumerate(calls):
            for g, a in zip(got, out):
                np.testing.assert_array_equal(g[k], a)
    monkeypatch.undo()
    assert len(calls) == len(runs)
    for (_, out), (yr, freqs, line, lte) in zip(calls, runs):
        tm.time = yr * YEAR
        want = (tm.continuum_rt_products(freqs) if line is None else
                tm.rrl_rt_products(line, freqs, lte=lte))
        for a, w in zip(out, want):
            np.testing.assert_array_equal(a, w)


# --------------------------------------------------------------------------- #
# Pipeline.execute(device_fanout)
# --------------------------------------------------------------------------- #
def _pline(dcy, cont_times=(0.0, 0.5, 1.0), rrl_times=(0.0, 0.8)):
    """Continuum runs of 2 channels, and H58a (LTE) and H59a (non-LTE)
    runs of 2 channels at each RRL epoch."""
    none = {'t_obs': None, 'tscps': None, 't_ints': None}
    rrl = dict(none, times=np.array(rrl_times), bws=np.array([4e6, 4e6]),
               chanws=np.array([2e6, 2e6]),
               lines=np.array(['H58a', 'H59a']),
               lte=np.array([True, False]))
    if not rrl_times:
        rrl.update(lines=None, bws=None, chanws=None, lte=None)
    return {'min_el': 20., 'dcys': {'model_dcy': str(dcy)},
            'continuum': dict(none, times=np.array(cont_times),
                              freqs=np.array([6e9]), bws=np.array([1e8]),
                              chanws=np.array([5e7])),
            'rrls': rrl}


_KEPT = {}


@pytest.fixture
def campaigns(model_params, tmp_path_factory):
    """The campaign through the JAX package (fanned over its 8 virtual
    devices) and through the port sequentially; kept for the module."""
    if jax.device_count() < 2:
        pytest.skip("needs xla_force_host_platform_device_count=8")
    if 'campaigns' in _KEPT:
        return _KEPT['campaigns']
    root = tmp_path_factory.mktemp('fanout')
    p = _small(model_params)
    pl_j = rajepy_tpu.Pipeline(rajepy_tpu.JetModel(copy.deepcopy(p)),
                               _pline(root / 'jax'))
    pl_j.execute(**QUIET)
    assert len(_logged(pl_j, 'Fanned')) == 3
    pl_s = rajepy_tpu_torch.Pipeline(
        rajepy_tpu_torch.JetModel(copy.deepcopy(p), device='cpu'),
        _pline(root / 'seq'))
    pl_s.execute(device_fanout=False, **QUIET)
    _KEPT['campaigns'] = p, root, pl_j, pl_s
    return _KEPT['campaigns']


@pytest.mark.parametrize('device_fanout', [None, True])
def test_pipeline_fanout(campaigns, monkeypatch, device_fanout):
    """With four shards, the three groups (continuum, LTE H58a, non-LTE
    H59a) fan out; every FITS product is the sequential port's bit for
    bit and the JAX package's fanned product within 1e-9 / 1e-6."""
    p, root, pl_j, pl_s = campaigns
    monkeypatch.setattr(tsh, 'available_devices', lambda device: SHARDS)
    pl = rajepy_tpu_torch.Pipeline(
        rajepy_tpu_torch.JetModel(copy.deepcopy(p), device='cpu'),
        _pline(root / f'fan_{device_fanout}'))
    pl.execute(device_fanout=device_fanout, **QUIET)
    fanned = _logged(pl, 'Fanned')
    assert [f.split('Fanned ')[1].split("'")[0] for f in fanned] == \
        ['3 continuum runs', '2 rrl runs', '2 rrl runs']
    assert all('across 4 devices' in f for f in fanned)
    for run, run_s, run_j in zip(pl.runs, pl_s.runs, pl_j.runs):
        assert run.completed
        for prod in PRODUCTS:
            data = read_fits(getattr(run, prod))[0]
            np.testing.assert_array_equal(
                data, read_fits(getattr(run_s, prod))[0])
            assert _rel(data, read_fits(getattr(run_j, prod))[0]) < \
                TOL[run.obs_type != 'continuum'], (str(run), prod)
        np.testing.assert_array_equal(run.results['flux'],
                                      run_s.results['flux'])


def test_pipeline_fanout_off_with_one_device(campaigns):
    """The defaults of the JAX package: with one device, None and True run
    the sequential loop (no fan-out)."""
    p, root, _, pl_s = campaigns
    for flag in (None, True):
        pl = rajepy_tpu_torch.Pipeline(
            rajepy_tpu_torch.JetModel(copy.deepcopy(p), device='cpu'),
            _pline(root / f'one_{flag}', rrl_times=()))
        pl.execute(device_fanout=flag, **QUIET)
        assert not _logged(pl, 'Fanned')
        for run, run_s in zip(pl.runs, pl_s.runs):
            np.testing.assert_array_equal(read_fits(run.fits_flux)[0],
                                          read_fits(run_s.fits_flux)[0])


def test_pipeline_resume_fans_only_pending_runs(model_params, shards,
                                                tmp_path):
    """A partly completed matrix resumed under fan-out: run 0 completed
    with its products, run 1 completed with its flux FITS missing, run 3
    not completed with all its products, runs 2 and 4 not completed with
    a product missing.  Only runs 2 and 4 are pending: they fan ("Fanned
    2"), are written and equal the sequential products; nothing else is
    rewritten.  ``clobber=True`` then fans all five."""
    p = _small(model_params)
    times = (0.0, 0.3, 0.6, 0.9, 1.2)
    pl = rajepy_tpu_torch.Pipeline(
        rajepy_tpu_torch.JetModel(copy.deepcopy(p), device='cpu'),
        _pline(tmp_path / 'out', cont_times=times, rrl_times=()))
    pl.execute(device_fanout=False, **QUIET)
    want = {i: read_fits(r.fits_tau)[0] for i, r in enumerate(pl.runs)}
    os.remove(pl.runs[1].fits_flux)
    os.remove(pl.runs[2].fits_flux)
    os.remove(pl.runs[4].fits_tau)
    for i in (2, 3, 4):
        pl.runs[i].completed = False
    stamps = {(i, prod): os.stat(getattr(r, prod)).st_mtime_ns
              for i, r in enumerate(pl.runs) for prod in PRODUCTS
              if os.path.exists(getattr(r, prod))}
    pl.save(pl.save_file)
    resumed = rajepy_tpu_torch.Pipeline.load_pipeline(pl.save_file,
                                                      device='cpu')
    resumed.execute(**QUIET)
    fanned = _logged(resumed, 'Fanned')
    assert len(fanned) == 1 and 'Fanned 2 continuum runs' in fanned[0]
    for (i, prod), stamp in stamps.items():
        assert os.stat(getattr(resumed.runs[i], prod)).st_mtime_ns == \
            stamp, (i, prod)
    assert not os.path.exists(resumed.runs[1].fits_flux)
    for i in (2, 4):
        run = resumed.runs[i]
        assert run.completed and all(os.path.exists(getattr(run, prod))
                                     for prod in PRODUCTS)
        np.testing.assert_array_equal(read_fits(run.fits_tau)[0], want[i])
    resumed.execute(clobber=True, **QUIET)
    assert 'Fanned 5 continuum runs' in _logged(resumed, 'Fanned')[-1]
    for i, run in enumerate(resumed.runs):
        np.testing.assert_array_equal(read_fits(run.fits_tau)[0], want[i])


# --------------------------------------------------------------------------- #
# channel-sharded cube imaging
# --------------------------------------------------------------------------- #
def test_shard_imaging_line_run(model_params, monkeypatch, tmp_path):
    """An observed 2-channel H58a run with two shards: ``shard_imaging=
    True`` images the cube channel-sharded (logged) and writes the cube
    that unsharded imaging writes, bit for bit."""
    monkeypatch.setattr(tsh, 'available_devices',
                        lambda device: [CPU, CPU0])
    observed = {'times': np.array([0.]), 't_obs': np.array([1800]),
                'tscps': np.array([('VLA', 'D')]), 't_ints': np.array([60]),
                'lines': np.array(['H58a']), 'bws': np.array([4e6]),
                'chanws': np.array([2e6])}
    empty = {'times': None, 'freqs': None, 't_obs': None, 'tscps': None,
             't_ints': None, 'bws': None, 'chanws': None}
    params = {'min_el': 20., 'dcys': {'model_dcy': str(tmp_path / 'out')},
              'continuum': dict(empty), 'rrls': observed,
              'synthobs': {'sefd': 0.0, 'niter': 50, 'shard_imaging': True}}
    pl = rajepy_tpu_torch.Pipeline(
        rajepy_tpu_torch.JetModel(_small(model_params, (16, 40, 16)),
                                  device='cpu'), params)
    pl.execute(verbose=False, plot=False)
    run = pl.runs[0]
    assert run.completed
    assert _logged(pl, 'Imaging 2 channels across 2 devices')
    sharded = read_fits(run.products['clean_image'])[0]
    assert sharded.shape == (2, 500, 500) and np.isfinite(sharded).all()
    tsyn.simulate_observation(pl, run, sefd=0.0, niter=50,
                              shard_imaging=False, reuse_vis=True)
    np.testing.assert_array_equal(
        read_fits(run.products['clean_image'])[0], sharded)


# --------------------------------------------------------------------------- #
# fit's mesh=
# --------------------------------------------------------------------------- #
@pytest.fixture
def fit_model(model_params):
    """A 16^3 CPU model at 0.5 yr, kept for the module."""
    if 'fit_model' not in _KEPT:
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=16, n_y=16, n_z=16, l_z=None)
        _KEPT['fit_model'] = rajepy_tpu_torch.JetModel(p, device='cpu')
        _KEPT['fit_model'].time = 0.5 * YEAR
    return _KEPT['fit_model']


FIT_FREQS = np.array([5e9, 2e10, 1e11])


@pytest.mark.parametrize('devices', [[CPU] * 4, [CPU, CPU0]])
def test_fit_sed_mesh(fit_model, devices):
    """n_starts=4 over the mesh's first axis: the chains, the kept chain
    and the fitted model equal those of mesh=None bit for bit (the jitter
    drawn once, on the model's device)."""
    obs = 1.2 * fit.build_sed_forward(fit_model, FIT_FREQS,
                                      ('properties.mlr_bj',))[0](
        torch.tensor([np.log(1e-7)], dtype=torch.float64)).numpy()
    kw = dict(free=('properties.mlr_bj', 'properties.T_0'), steps=3,
              n_starts=4, start_spread=0.3, seed=3)
    mesh = tsh.make_mesh(n_los=1, n_chan=len(devices), devices=devices)
    got = fit.fit_sed(fit_model, FIT_FREQS, obs, mesh=mesh, **kw)
    want = fit.fit_sed(fit_model, FIT_FREQS, obs, **kw)
    np.testing.assert_array_equal(got.theta, want.theta)
    np.testing.assert_array_equal(got.loss, want.loss)
    np.testing.assert_array_equal(got.model, want.model)
    assert got.grad_norm == want.grad_norm
    assert (CPU0 in fit_model._replicas) == (CPU0 in devices)


@pytest.mark.parametrize('batch_size', [None, 3])
@pytest.mark.parametrize('devices', [[CPU] * 4, [CPU, CPU0]])
def test_sweep_mesh(fit_model, devices, batch_size):
    """8 combos over the mesh's first axis, with and without batch_size:
    the values of mesh=None bit for bit."""
    grid = {'properties.mlr_bj': [5e-8, 1e-7, 2e-7, 4e-7],
            'properties.T_0': [8e3, 1.2e4]}
    mesh = tsh.make_mesh(n_los=1, n_chan=len(devices), devices=devices)
    got = fit.sweep(fit_model, FIT_FREQS, grid, mesh=mesh,
                    batch_size=batch_size)
    want = fit.sweep(fit_model, FIT_FREQS, grid)
    assert got.values.shape == (8, 3)
    np.testing.assert_array_equal(got.values, want.values)
