"""The port's Pipeline slice against the JAX package's, on the CPU.

The same model and pipeline params (the conftest 32 x 80 x 32 jet; two
epochs, one continuum run of 2 channels and one H58a run of 8 channels per
epoch) go through ``Pipeline.execute(simobserve=False, plot=False)`` of
both packages:

* float64: every FITS product to 1e-9 (continuum runs) and 1e-6 (RRL
  runs), the parity contract of docs/MIGRATION.md; headers equal card for
  card except ``AUTHOR``; the same paths under ``model_dcy``;
  ``results['flux']`` to the same tolerances;
* float32 (the compacted tile path through the kernels' plain versions,
  the JAX package in the Pallas interpreter): 2e-4 for continuum runs and
  1e-4 for RRL runs, as tests/test_torch_jetmodel.py and
  tests/test_torch_rrl.py hold the model's own products;
* resume, clobber, dryrun and the KeyboardInterrupt save; a CPU pipeline
  resumes on the CPU at its precision;
* ``pipeline.save``, ``jetmodel.save`` and the npz/JSON checkpoints of
  ``io/checkpoint`` written by each package load in the other;
* ``add_ejection_event`` (on a burst-free model it changes the path a
  float32 model takes), ``ss_jml``, ``jml_t``, ``los_axis``,
  ``EjectionSpec.jml``/``.chi``, and the ``.sig`` sidecar of ``save``;
* ``execute`` with each of its options and those of ``params['synthobs']``
  completes and writes the option's products.
"""
import copy
import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import rajepy_tpu
import rajepy_tpu_torch
from rajepy_tpu.io import checkpoint as jckpt
from rajepy_tpu.io.fits import read_fits
from rajepy_tpu.ops import pallas_kernels as pk
from rajepy_tpu_torch import pipeline as tpipe
from rajepy_tpu_torch.io import checkpoint as tckpt
from rajepy_tpu_torch.ops import kernels as kn
from tests.torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YEAR = 31536000.0
EPOCHS = np.array([0.6, 2.2])
N_RUNS = 4                  # continuum at both epochs, then H58a at both
PRODUCTS = ('fits_em', 'fits_tau', 'fits_flux')
# (continuum, RRL) tolerances of the FITS products and results['flux']
TOL = {'float64': (1e-9, 1e-6), 'float32': (2e-4, 1e-4)}
# device_fanout=False: the JAX package would otherwise fan the runs out over
# the 8 virtual devices the tests run with; the port accepts the flag
QUIET = dict(simobserve=False, verbose=False, plot=False,
             device_fanout=False)


def _pline_params(dcy, rrl=True, times=EPOCHS):
    none = {'t_obs': None, 'tscps': None, 't_ints': None}
    params = {
        'min_el': 20.,
        'dcys': {'model_dcy': str(dcy)},
        'continuum': dict(none, times=np.array(times),
                          freqs=np.array([6e9]), bws=np.array([4e8]),
                          chanws=np.array([2e8])),
        'rrls': dict(none, times=np.array([]), lines=None, bws=None,
                     chanws=None),
    }
    if rrl:
        params['rrls'].update(times=np.array(times),
                              lines=np.array(['H58a']),
                              bws=np.array([2e6]), chanws=np.array([2.5e5]))
    return params


def _small(params, n=(16, 40, 16), bursts=True):
    p = copy.deepcopy(params)
    p['grid'].update(n_x=n[0], n_y=n[1], n_z=n[2])
    if not bursts:
        p['ejection'] = {'t_0': np.array([]), 'hl': np.array([]),
                         'chi': np.array([]), 'which': np.array([])}
    return p


def _torch_model(params, dtype='parity'):
    return rajepy_tpu_torch.JetModel(copy.deepcopy(params), dtype=dtype,
                                     device='cpu')


def _rel(got, want):
    got = np.nan_to_num(np.asarray(got, dtype=float))
    want = np.nan_to_num(np.asarray(want, dtype=float))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    return np.max(np.abs(got - want)) / scale


# --------------------------------------------------------------------------- #
# (a), (b): the two-epoch campaign through both packages
# --------------------------------------------------------------------------- #
_CAMPAIGNS = {}


@pytest.fixture()
def campaign(request, model_params, tmp_path_factory):
    """(JAX pipeline, port pipeline), both executed, for ``request.param``
    in 'float64' / 'float32'; run once per precision and kept."""
    prec = request.param
    if prec not in _CAMPAIGNS:
        root = tmp_path_factory.mktemp('campaign_' + prec)
        jm_j = rajepy_tpu.JetModel(copy.deepcopy(model_params),
                                   dtype=getattr(jnp, prec))
        pl_j = rajepy_tpu.Pipeline(jm_j, _pline_params(root / 'jax'))
        pk.force_interpret(prec == 'float32')
        try:
            pl_j.execute(**QUIET)
        finally:
            pk.force_interpret(False)
        pl_t = rajepy_tpu_torch.Pipeline(
            _torch_model(model_params, getattr(torch, prec)),
            _pline_params(root / 'torch'))
        pl_t.execute(**QUIET)
        _CAMPAIGNS[prec] = (pl_j, pl_t)
    return _CAMPAIGNS[prec]


both_precisions = pytest.mark.parametrize(
    'campaign', ['float64', 'float32'], indirect=True)


@both_precisions
@pytest.mark.parametrize('product', PRODUCTS)
@pytest.mark.parametrize('idx', range(N_RUNS))
def test_pipeline_fits_products_match_jax(request, campaign, idx, product):
    pl_j, pl_t = campaign
    prec = request.node.callspec.params['campaign']
    run_j, run_t = pl_j.runs[idx], pl_t.runs[idx]
    assert run_t.obs_type == run_j.obs_type == \
        ('continuum' if idx < 2 else 'rrl')
    path_j, path_t = getattr(run_j, product), getattr(run_t, product)
    assert os.path.relpath(path_t, pl_t.dcy) == \
        os.path.relpath(path_j, pl_j.dcy)
    assert os.path.dirname(path_t) == os.sep.join(
        [pl_t.dcy, f'Day{int(run_t.year * 365.0)}',
         '6GHz' if idx < 2 else 'H58a'])
    data_j, hdr_j = read_fits(path_j)
    data_t, hdr_t = read_fits(path_t)
    assert data_t.dtype == data_j.dtype
    assert _rel(data_t, data_j) < TOL[prec][idx >= 2]
    cards_j = [c for c in hdr_j.cards() if c[0] != 'AUTHOR']
    cards_t = [c for c in hdr_t.cards() if c[0] != 'AUTHOR']
    assert cards_t == cards_j
    assert hdr_t['AUTHOR'] == 'rajepy_tpu_torch'
    assert hdr_t['BITPIX'] == (-64 if prec == 'float64' else -32)


@both_precisions
@pytest.mark.parametrize('idx', range(N_RUNS))
def test_pipeline_results_flux_match_jax(request, campaign, idx):
    pl_j, pl_t = campaign
    prec = request.node.callspec.params['campaign']
    run_j, run_t = pl_j.runs[idx], pl_t.runs[idx]
    assert run_t.completed and run_j.completed
    flux_j, flux_t = run_j.results['flux'], run_t.results['flux']
    assert np.shape(flux_t) == np.shape(flux_j) == (() if idx < 2 else (8,))
    assert isinstance(flux_t, float if idx < 2 else np.ndarray)
    assert _rel(flux_t, flux_j) < TOL[prec][idx >= 2]


@both_precisions
def test_pipeline_run_table_and_files_match_jax(campaign):
    pl_j, pl_t = campaign
    assert str(pl_t) == str(pl_j)
    assert [str(r) for r in pl_t.runs] == [str(r) for r in pl_j.runs]

    def tree(pl):
        found = set()
        for dirpath, _, names in os.walk(pl.dcy):
            found |= {os.path.relpath(os.path.join(dirpath, n), pl.dcy)
                      for n in names if not n.endswith('.log')}
        return found

    assert tree(pl_t) == tree(pl_j)
    assert {'jetmodel.save', 'jetmodel.save.sig', 'pipeline.save'} <= \
        tree(pl_t)


def test_f32_campaign_took_the_tile_kernels_plain_versions(model_params,
                                                           tmp_path):
    """A float32 CPU pipeline reaches the dual-base epoch wrapper once per
    run and the RRL tile wrapper once per RRL run, and launches nothing."""
    calls = []
    pl = rajepy_tpu_torch.Pipeline(_torch_model(model_params, torch.float32),
                                   _pline_params(tmp_path / 'out'))
    plain2, plain4 = kn.epoch_tile_partials2_plain, kn.rrl_tiles_plain
    kn.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kn, 'epoch_tile_partials2_plain',
                   lambda *a, **k: calls.append('K2') or plain2(*a, **k))
        mp.setattr(kn, 'rrl_tiles_plain',
                   lambda *a, **k: calls.append('K4') or plain4(*a, **k))
        pl.execute(**QUIET)
    assert calls.count('K2') == N_RUNS and calls.count('K4') == 2
    assert not any(kn.LAUNCHES.values())


# --------------------------------------------------------------------------- #
# (c), (d): resume, clobber, dryrun, interrupt; device and precision
# --------------------------------------------------------------------------- #
def _packages():
    return {'jax': (rajepy_tpu, {}),
            'torch': (rajepy_tpu_torch, {'device': 'cpu'})}


def _executed(pkg, model_params, dcy, **pline_kw):
    mod, dev = _packages()[pkg]
    jm = mod.JetModel(_small(model_params), **dev)
    pl = mod.Pipeline(jm, _pline_params(dcy, rrl=False, **pline_kw))
    pl.execute(**QUIET)
    return mod, dev, pl


def _mtimes(pl):
    return {p: os.stat(getattr(r, p)).st_mtime_ns
            for r in pl.runs for p in PRODUCTS}


@pytest.mark.parametrize('pkg', ['jax', 'torch'])
def test_resume_skips_completed_and_clobber_recomputes(pkg, model_params,
                                                       tmp_path):
    mod, dev, pl = _executed(pkg, model_params, tmp_path / 'out')
    assert all(r.completed for r in pl.runs)
    before = _mtimes(pl)
    flux = [r.results['flux'] for r in pl.runs]

    pl2 = mod.Pipeline.load_pipeline(pl.save_file, **dev)
    assert str(pl2) == str(pl) and all(r.completed for r in pl2.runs)
    computed = []
    model_cls = type(pl2.model)
    with pytest.MonkeyPatch.context() as mp:
        rt = model_cls.continuum_rt_products
        mp.setattr(model_cls, 'continuum_rt_products',
                   lambda self, *a, **k: computed.append(self.time) or
                   rt(self, *a, **k))
        pl2.execute(**QUIET)
        assert computed == [] and _mtimes(pl2) == before
        pl2.execute(clobber=True, **QUIET)
    assert computed == [t * YEAR for t in EPOCHS]
    after = _mtimes(pl2)
    assert all(after[p] > before[p] for p in before)
    assert [r.results['flux'] for r in pl2.runs] == flux


@pytest.mark.parametrize('pkg', ['jax', 'torch'])
def test_dryrun_writes_no_fits_and_completes_nothing(pkg, model_params,
                                                     tmp_path):
    mod, dev = _packages()[pkg]
    pl = mod.Pipeline(mod.JetModel(_small(model_params), **dev),
                      _pline_params(tmp_path / 'out', rrl=False))
    pl.execute(dryrun=True, **QUIET)
    assert not any(r.completed for r in pl.runs)
    assert not any(n.endswith('.fits')
                   for _, _, names in os.walk(pl.dcy) for n in names)
    assert all(os.path.isdir(r.rt_dcy) for r in pl.runs)
    # a later real execute is not poisoned by the dry one
    pl.execute(**QUIET)
    assert all(r.completed and os.path.exists(r.fits_flux) for r in pl.runs)


@pytest.mark.parametrize('pkg', ['jax', 'torch'])
def test_keyboard_interrupt_saves_both_files(pkg, model_params, tmp_path):
    mod, dev = _packages()[pkg]
    jm = mod.JetModel(_small(model_params), **dev)
    pl = mod.Pipeline(jm, _pline_params(tmp_path / 'out', rrl=False))
    calls = []

    def interrupted(self, *args, **kwargs):
        calls.append(self.time)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(self, *args, **kwargs)

    real = type(jm).continuum_rt_products
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(jm), 'continuum_rt_products', interrupted)
        with pytest.raises(KeyboardInterrupt, match='interrupted by user'):
            pl.execute(**QUIET)
    assert os.path.exists(pl.save_file) and os.path.exists(pl.model_file)
    assert [r.completed for r in pl.runs] == [True, False]
    pl2 = mod.Pipeline.load_pipeline(pl.save_file, **dev)
    assert [r.completed for r in pl2.runs] == [True, False]
    assert pl2.model.time == EPOCHS[1] * YEAR
    pl2.execute(**QUIET)
    assert all(r.completed and os.path.exists(r.fits_flux)
               for r in pl2.runs)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_cpu_pipeline_resumes_on_the_cpu_at_its_precision(
        dtype, model_params, tmp_path, monkeypatch):
    """``execute`` reloads the model from ``jetmodel.save`` when it resumes:
    on the device and at the precision of the model it replaces, not at
    ``JetModel``'s defaults (which need a GPU)."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    jm = _torch_model(_small(model_params), dtype)
    pl = rajepy_tpu_torch.Pipeline(
        jm, _pline_params(tmp_path / 'out', rrl=False, times=EPOCHS[:1]))
    pl.execute(**QUIET)
    pl.execute(**QUIET)                       # resumes: reloads the model
    assert pl.model is not jm
    assert pl.model.device.type == 'cpu' and pl.model.dtype == dtype
    pl2 = rajepy_tpu_torch.Pipeline.load_pipeline(pl.save_file, dtype=dtype,
                                                  device='cpu')
    assert pl2.model.device.type == 'cpu' and pl2.model.dtype == dtype
    pl2.execute(clobber=True, **QUIET)
    assert pl2.model.device.type == 'cpu' and pl2.model.dtype == dtype
    assert pl2.runs[0].results['flux'] == pytest.approx(
        pl.runs[0].results['flux'], rel=1e-12)
    with pytest.raises(RuntimeError, match='CUDA'):
        rajepy_tpu_torch.Pipeline.load_pipeline(pl.save_file)


# an RRL run configured for a synthetic observation (line-cube imaging)
_OBSERVED_RRL = {'rrls': dict(t_obs=np.array([3600]), t_ints=np.array([60]),
                              tscps=np.array([('VLA', 'A')]))}
# the calibration and export options, on observed continuum runs (VLA B,
# 1,200 s, noise-free), with the products each writes
_CALIBRATION = {'corruption': ('ms_noisy',),
                'selfcal': ('ms_selfcal', 'gains'),
                'applycal_gains': ('ms_noisy',),
                'export_uvfits': ('uvfits_clean', 'uvfits_noisy')}


@pytest.mark.parametrize('kwargs,option', [
    (dict(plot=False, pline=_OBSERVED_RRL), 'line cubes'),
    (dict(plot=False, pline={'synthobs': {'deconvolver': 'clark'}}),
     "deconvolver='clark'"),
    (dict(plot=False, pline={'synthobs': {'corruption': {'amp_rms': 0.1}}}),
     'corruption'),
    (dict(plot=False, pline={'synthobs': {'selfcal': 'phase'}}), 'selfcal'),
    (dict(plot=False, pline={'synthobs': {'applycal_gains': 'g.npz'}}),
     'applycal_gains'),
    (dict(plot=False, pline={'synthobs': {'export_uvfits': True}}),
     'export_uvfits'),
    (dict(simobserve=False), 'plotting'),
    (dict(simobserve=False, plot=False, device_fanout=True), 'fan-out'),
    (dict(simobserve=False, plot=False, device_fanout=2), 'fan-out'),
])
def test_execute_options_complete_and_write_their_products(
        kwargs, option, model_params, tmp_path):
    """``Pipeline.execute`` with each option completes every run and
    writes its products: observed RRL runs (line cubes), observed
    continuum runs with ``deconvolver='clark'``, with gain corruption,
    selfcal, gain transfer or UVFITS export (each option's products), the
    figures, and the device fan-out (on one CPU device, the sequential
    loop, which logs no fan-out)."""
    kwargs = dict(kwargs)
    pline = kwargs.pop('pline', {})
    params = _pline_params(tmp_path / 'out', rrl='rrls' in pline)
    params['rrls'].update(pline.get('rrls', {}))
    if 'synthobs' in pline:
        params['synthobs'] = dict(pline['synthobs'])
    if option in _CALIBRATION:
        params['continuum'].update(t_obs=np.array([1200]),
                                   t_ints=np.array([60]),
                                   tscps=np.array([('VLA', 'B')]))
        params['synthobs'].update(sefd=0.0, niter=20)
        if option == 'applycal_gains':
            # a gains product of the array's 27 antennas, unit modulus
            gains = str(tmp_path / 'g.npz')
            phase = np.linspace(0.0, 1.0, 27)[None]
            np.savez(gains, g_re=np.cos(phase), g_im=np.sin(phase))
            params['synthobs']['applycal_gains'] = gains
    pl = rajepy_tpu_torch.Pipeline(_torch_model(_small(model_params)), params)
    if option in _CALIBRATION:
        pl.execute(verbose=False, **kwargs)
        assert len(pl.runs) == len(EPOCHS)
        for run in pl.runs:
            assert run.completed and run.simobserve
            for key in _CALIBRATION[option] + ('clean_image', 'imfit'):
                assert os.path.isfile(run.products[key]), key
        assert ('selfcal' in pl.runs[0].results) == (option == 'selfcal')
        return
    if option == 'plotting':
        pl.execute(verbose=False, **kwargs)
        assert all(r.completed for r in pl.runs)
        figures = ['GridPlot.pdf', 'JMLPlot.pdf'] + [
            os.path.join(os.path.dirname(r.rt_dcy), 'ModelPlot.pdf')
            for r in pl.runs]
        assert len(set(figures)) == 2 + len(EPOCHS)
        for name in figures:
            path = os.path.join(pl.dcy, name)
            assert os.path.getsize(path) > 1000, path
        for run in pl.runs:
            assert all(os.path.isfile(getattr(run, p)) for p in PRODUCTS)
        return
    if option == 'fan-out':
        pl.execute(verbose=False, **kwargs)
        assert all(r.completed for r in pl.runs)
        for run in pl.runs:
            assert all(os.path.isfile(getattr(run, p)) for p in PRODUCTS)
        assert not any('Fanned' in str(e) for e in pl.log.entries.values())
        return
    # the line cubes and deconvolver='clark'
    pl.execute(verbose=False, **kwargs)
    assert all(r.completed for r in pl.runs)
    for run in pl.runs:
        assert all(os.path.isfile(getattr(run, p)) for p in PRODUCTS)
        if run.simobserve:
            img, hdr = read_fits(run.products['clean_image'])
            assert img.shape == (len(run.chan_freqs), 500, 500)
            assert hdr['CTYPE3'] == 'FREQ'
    assert sum(r.simobserve for r in pl.runs) == \
        (2 if option == 'line cubes' else 0)


def test_pipeline_refuses_a_model_of_the_jax_package(model_params,
                                                      tmp_path):
    with pytest.raises(TypeError, match='JetModel'):
        rajepy_tpu_torch.Pipeline(
            rajepy_tpu.JetModel(_small(model_params)),
            _pline_params(tmp_path / 'other', rrl=False))


# --------------------------------------------------------------------------- #
# (e): the saved states interchange
# --------------------------------------------------------------------------- #
def test_port_loads_the_jax_packages_pipeline_save(model_params, tmp_path,
                                                   monkeypatch):
    """The JAX package's ``pipeline.save`` names its run classes as
    ``rajepy_tpu.models.runs.*``; the port's unpickler maps them onto its
    own classes and never asks for a module of the JAX package."""
    _, _, pl_j = _executed('jax', model_params, tmp_path / 'out')
    with open(pl_j.save_file, 'rb') as f:
        assert b'rajepy_tpu.models.runs' in f.read()
    asked, resolved = [], []
    real = tpipe._PipelineUnpickler.find_class

    def spy(self, module, name):
        asked.append((module, name))
        found = real(self, module, name)
        resolved.append((found.__module__, found.__name__))
        return found

    monkeypatch.setattr(tpipe._PipelineUnpickler, 'find_class', spy)
    pl_t = rajepy_tpu_torch.Pipeline.load_pipeline(pl_j.save_file,
                                                   device='cpu')
    assert ('rajepy_tpu.models.runs', 'ContinuumRun') in asked
    assert ('rajepy_tpu_torch.models.runs', 'ContinuumRun') in resolved
    assert not [m for m, _ in resolved if m.split('.')[0] == 'rajepy_tpu']
    assert all(type(r) is rajepy_tpu_torch.ContinuumRun for r in pl_t.runs)
    assert str(pl_t) == str(pl_j) and all(r.completed for r in pl_t.runs)
    assert [r.results for r in pl_t.runs] == [r.results for r in pl_j.runs]
    assert pl_t.model.time == pl_j.model.time
    before = _mtimes(pl_t)
    pl_t.execute(**QUIET)                       # resumes the JAX campaign
    assert _mtimes(pl_t) == before


def test_port_loads_the_jax_pipeline_save_without_jax(model_params,
                                                      tmp_path):
    """The same in a process where ``import jax`` fails."""
    _, _, pl_j = _executed('jax', model_params, tmp_path / 'out',
                           times=EPOCHS[:1])
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from rajepy_tpu_torch import Pipeline\n"
        f"pl = Pipeline.load_pipeline({pl_j.save_file!r}, device='cpu')\n"
        "assert [type(r).__module__ for r in pl.runs] == "
        "['rajepy_tpu_torch.models.runs']\n"
        "assert pl.runs[0].completed\n"
        "assert not [m for m in sys.modules if m == 'rajepy_tpu' or "
        "m.startswith('rajepy_tpu.')]\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == 'ok'


def test_unpickler_refuses_other_modules():
    for obj in (os.getcwd, subprocess.run, eval):
        with pytest.raises(pickle.UnpicklingError, match='neither'):
            tpipe._PipelineUnpickler(io.BytesIO(pickle.dumps(obj))).load()


def test_jax_package_loads_the_ports_pipeline_save(model_params, tmp_path):
    _, _, pl_t = _executed('torch', model_params, tmp_path / 'out')
    pl_j = rajepy_tpu.Pipeline.load_pipeline(pl_t.save_file)
    assert isinstance(pl_j.model, rajepy_tpu.JetModel)
    assert str(pl_j) == str(pl_t) and all(r.completed for r in pl_j.runs)
    assert [r.results for r in pl_j.runs] == [r.results for r in pl_t.runs]
    assert pl_j.model.time == pl_t.model.time
    np.testing.assert_array_equal(np.asarray(pl_j.model.fill_factor),
                                  pl_t.model.fill_factor)
    before = _mtimes(pl_j)
    pl_j.execute(**QUIET)
    assert _mtimes(pl_j) == before


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_npz_json_checkpoints_interchange(writer, model_params, tmp_path):
    mod, dev, pl = _executed(writer, model_params, tmp_path / 'out',
                             times=EPOCHS[:1])
    save, load = ((jckpt, tckpt) if writer == 'jax' else (tckpt, jckpt))
    load_kw = {'device': 'cpu'} if writer == 'jax' else {}
    stem = str(tmp_path / 'model_ckpt')
    save.save_model_checkpoint(stem, pl.model)
    with open(stem + '.json') as f:
        assert '"rajepy_tpu.model/1"' in f.read()
    jm = load.load_model_checkpoint(stem, **load_kw)
    assert jm.time == pl.model.time == EPOCHS[0] * YEAR
    np.testing.assert_array_equal(np.asarray(jm.fill_factor),
                                  np.asarray(pl.model.fill_factor))
    assert _rel(jm.flux_ff(6e9), pl.model.flux_ff(6e9)) < 1e-9
    # the port's own round trip keeps device and precision
    if writer == 'torch':
        own = tckpt.load_model_checkpoint(stem, dtype=torch.float32,
                                          device='cpu')
        assert own.dtype == torch.float32 and own.device.type == 'cpu'

    path = str(tmp_path / 'pipeline_ckpt.json')
    save.save_pipeline_checkpoint(path, pl)
    state = load.load_pipeline_state(path)
    assert _states_equal(state, save.load_pipeline_state(path))
    assert state['format'] == 'rajepy_tpu.pipeline/1'
    assert state['model_file'] == pl.model_file
    (entry,) = state['runs']
    assert entry['completed'] is True and entry['obs_type'] == 'continuum'
    assert entry['results']['flux'] == pl.runs[0].results['flux']
    np.testing.assert_array_equal(state['params']['continuum']['freqs'],
                                  pl.params['continuum']['freqs'])


def _states_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_states_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_states_equal, a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


# --------------------------------------------------------------------------- #
# (g): add_ejection_event and the members the pipeline's log leans on
# --------------------------------------------------------------------------- #
BURST = dict(t_0=0.5 * YEAR, half_life=0.15 * YEAR, chi=5.0)


@pytest.mark.parametrize('bursts', [False, True])
def test_add_ejection_event_matches_jax_f64(bursts, model_params):
    p = _small(model_params, n=(24, 48, 24), bursts=bursts)
    jm_j = rajepy_tpu.JetModel(copy.deepcopy(p))
    jm_t = _torch_model(p)
    jm_j.time = jm_t.time = 0.6 * YEAR
    freqs = np.array([6e9, 1e11])
    before = jm_t.continuum_rt_products(freqs)       # fills every cache
    jm_j.continuum_rt_products(freqs)
    assert (jm_t._fields.ts != 0).any() == bursts
    for jm in (jm_j, jm_t):
        jm.add_ejection_event(BURST['t_0'], BURST['chi'] * jm.ss_jml('B'),
                              BURST['half_life'], 'B')
    assert jm_t._has_bursts and jm_t._rt_static_cache is None
    assert (jm_t._fields is None) == (not bursts)
    assert jm_t.ejections == jm_j.ejections
    got = jm_t.continuum_rt_products(freqs)
    want = jm_j.continuum_rt_products(freqs)
    for name, g, w, b in zip(('em', 'tau', 'flux'), got, want, before):
        assert _rel(g, w) < 1e-9, name
        assert np.nansum(g) > np.nansum(b) * 1.05, name    # the burst shows
    assert _rel(jm_t.rrl_rt_products('H58a', [3.2852e10])[2],
                jm_j.rrl_rt_products('H58a', [3.2852e10])[2]) < 1e-6


def test_first_burst_moves_a_float32_model_onto_the_tile_path(model_params):
    """A burst-free float32 model sums the full cubes; with its first
    burst it takes the epoch kernels over compacted tiles, with fields
    that hold travel times."""
    p = _small(model_params, n=(24, 48, 24), bursts=False)
    jm = _torch_model(p, torch.float32)
    jm.time = 0.6 * YEAR
    freqs = np.array([6e9, 1e11])
    jm.continuum_rt_products(freqs)
    jm.rrl_rt_products('H58a', [3.2852e10])
    jm.emergent_intensity_ff(freqs)
    assert not jm._use_tiles() and jm._rt_static().seg is None
    assert not bool(jm._fields.ts.any())
    jm.add_ejection_event(BURST['t_0'], BURST['chi'] * jm.ss_jml('B'),
                          BURST['half_life'], 'B')
    for cache in (jm._rt_static_cache, jm._tile_ids_cache,
                  jm._rrl_tiles_cache, jm._emergent_tiles_cache, jm._fields):
        assert cache is None
    assert jm._char_cond_cache == {} and jm._departure_cache == {}
    assert jm._use_tiles()
    got = jm.continuum_rt_products(freqs)
    assert jm._rt_static().seg is not None and bool(jm._fields.ts.any())

    p_ref = copy.deepcopy(p)
    p_ref['ejection'] = {'t_0': np.array([0.5]), 'hl': np.array([0.15]),
                         'chi': np.array([5.0]), 'which': np.array(['B'])}
    built = _torch_model(p_ref, torch.float32)
    jm_j = rajepy_tpu.JetModel(copy.deepcopy(p_ref))
    built.time = jm_j.time = 0.6 * YEAR
    for name, g, same, w in zip(('em', 'tau', 'flux'), got,
                                built.continuum_rt_products(freqs),
                                jm_j.continuum_rt_products(freqs)):
        np.testing.assert_array_equal(g, same, err_msg=name)
        assert _rel(g, w) < 2e-4, name
    for call in (lambda m: m.rrl_rt_products('H58a', [3.2852e10])[2],
                 lambda m: m.emergent_intensity_ff(freqs)):
        np.testing.assert_array_equal(call(jm), call(built))


def test_mass_loss_members_match_jax(model_params):
    p = _small(model_params)
    jm_j, jm_t = rajepy_tpu.JetModel(copy.deepcopy(p)), _torch_model(p)
    assert jm_t.los_axis == jm_j.los_axis == 1
    for which in ('R', 'B', 'RB'):
        assert jm_t.ss_jml(which) == jm_j.ss_jml(which)
    with pytest.raises(ValueError, match="'R', 'B', or 'RB'"):
        jm_t.ss_jml('X')
    t = np.random.default_rng(0).uniform(-0.5, 3.0, 64) * YEAR
    for which in ('R', 'B', 'RB'):
        got = jm_t.jml_t(which)(t)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_allclose(got, np.asarray(jm_j.jml_t(which)(t)),
                                   rtol=1e-12)
    assert float(jm_t.jml_t('B')(0.75 * YEAR)) == pytest.approx(
        2.5 * jm_t.ss_jml('B'), rel=1e-12)
    for spec_t, spec_j in ((jm_t._spec_r, jm_j._spec_r),
                           (jm_t._spec_b, jm_j._spec_b)):
        np.testing.assert_allclose(spec_t.jml(t), np.asarray(spec_j.jml(t)),
                                   rtol=1e-12)
        np.testing.assert_allclose(spec_t.chi(t), np.asarray(spec_j.chi(t)),
                                   rtol=1e-12)
        as_tensor = spec_t.chi(torch.as_tensor(t))
        assert isinstance(as_tensor, torch.Tensor)
        np.testing.assert_allclose(as_tensor.numpy(), spec_t.chi(t),
                                   rtol=1e-12)


# --------------------------------------------------------------------------- #
# (h): the .sig sidecar of JetModel.save
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize('filled', [True, False])
def test_save_rewrites_only_when_its_signature_changes(filled, model_params,
                                                       tmp_path):
    jm = _torch_model(_small(model_params))
    jm.time = 0.6 * YEAR
    if filled:
        jm.flux_ff(6e9)
    path = str(tmp_path / 'jetmodel.save')
    jm.save(path)
    with open(path + '.sig') as f:
        sig, size = f.read().split()
    assert sig == jm._save_signature(filled)
    assert int(size) == os.path.getsize(path)
    stamp = os.stat(path).st_mtime_ns
    jm.save(path)
    assert os.stat(path).st_mtime_ns == stamp           # left untouched
    if filled:
        areas = jm._host_ff_cache[0]
        assert areas is not None
    jm.time = 0.7 * YEAR
    jm.save(path)
    assert os.stat(path).st_mtime_ns > stamp            # time changed
    if filled:
        assert jm._host_ff_cache[0] is areas            # host copy reused
    with open(path, 'rb') as f:
        raw = pickle.load(f)
    assert raw['time'] == 0.7 * YEAR and (raw['ffs'] is not None) == filled
    # a truncated pickle or a damaged sidecar is rewritten
    stamp = os.stat(path).st_mtime_ns
    with open(path + '.sig', 'w') as f:
        f.write('garbage')
    jm.save(path)
    assert os.stat(path).st_mtime_ns > stamp
    loaded = rajepy_tpu_torch.JetModel.load_model(path, device='cpu')
    assert loaded.time == jm.time
    assert rajepy_tpu.JetModel.load_model(path).time == jm.time
