"""The port's ``Pipeline.execute(simobserve=True)`` against the JAX
package's, on the CPU, end to end.

The conftest jet at 24 x 60 x 24 cells, one continuum run (VLA A, 6 GHz,
3600 s of 60 s integrations), in float64:

* noise-free (``params['synthobs'] = {'sefd': 0.0}``, with the primary-beam
  corrected image and tclean's auxiliary images): the visibility sets to
  1e-12 of max |V|, the ``.estimates`` text equal, every image to 1e-9 of
  its peak, ``results['imfit']`` to 1e-6, the same products under the same
  names;
* with thermal noise, whose stream is torch's: the port's visibility sets
  carry the JAX package's signature, so the JAX package's
  ``simulate_observation(reuse_vis=True)`` over the same directory reuses
  them, and its restored image and imfit then match the port's (1e-9,
  1e-6);
* ``resume=True`` skips completed runs, ``clobber=True`` recomputes them;
  each option of ``simulate_observation`` (line cubes, the Clark and
  multiscale deconvolvers, gain corruption, selfcal, gain transfer, UVFITS
  export, ``shard_imaging``) runs and writes its products.
"""
import copy
import os
import shutil

import numpy as np
import pytest
import torch

import rajepy_tpu
import rajepy_tpu_torch
from rajepy_tpu import synthobs as jsyn
from rajepy_tpu.io.fits import read_fits
from rajepy_tpu_torch import synthobs as tsyn
from tests.torch_one_thread import one_thread  # noqa: F401

IMG_RTOL = 1e-9
IMFIT_RTOL = 1e-6
VIS_RTOL = 1e-12
AUX = ('psf', 'dirty', 'model', 'residual')


def _params(dcy, synthobs=None, rrl=False):
    empty = np.array([])
    params = {
        'min_el': 20.,
        'dcys': {'model_dcy': str(dcy)},
        'continuum': {'times': np.array([0.]), 'freqs': np.array([6e9]),
                      't_obs': np.array([3600]),
                      'tscps': np.array([('VLA', 'A')]),
                      't_ints': np.array([60]), 'bws': np.array([1e8]),
                      'chanws': np.array([1e8])},
        'rrls': {'times': empty, 'lines': empty, 't_obs': empty,
                 'tscps': empty, 't_ints': empty, 'bws': empty,
                 'chanws': empty},
    }
    if rrl:
        params['rrls'] = {'times': np.array([0.]),
                          'lines': np.array(['H58a']),
                          't_obs': np.array([3600]),
                          'tscps': np.array([('VLA', 'A')]),
                          't_ints': np.array([60]), 'bws': np.array([2e6]),
                          'chanws': np.array([5e5])}
    if synthobs is not None:
        params['synthobs'] = synthobs
    return params


def _small(model_params):
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=24, n_y=60, n_z=24)
    return p


QUIET = dict(verbose=False, plot=False)
NOISE_FREE = {'sefd': 0.0, 'pbcor': True, 'save_products': AUX}
_RUNS = {}


def _executed(which, model_params, root):
    """An executed pipeline, kept for the module: 'jax' and 'port' are
    the noise-free campaign, 'noisy' the port's with noise."""
    if which not in _RUNS:
        p = _small(model_params)
        if which == 'jax':
            pl = rajepy_tpu.Pipeline(rajepy_tpu.JetModel(p),
                                     _params(root / which, NOISE_FREE))
            pl.execute(resume=False, clobber=True, device_fanout=False,
                       **QUIET)
        else:
            so = NOISE_FREE if which == 'port' else None
            pl = rajepy_tpu_torch.Pipeline(
                rajepy_tpu_torch.JetModel(p, device='cpu'),
                _params(root / which, so))
            pl.execute(resume=False, clobber=True, **QUIET)
        _RUNS[which] = pl
    return _RUNS[which]


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return tmp_path_factory.mktemp('synthobs_pipeline')


def _rel(got, want):
    scale = np.nanmax(np.abs(want))
    assert scale > 0 and got.shape == want.shape
    return np.nanmax(np.abs(got - want)) / scale


def _imfit_close(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k]['unit'] == v['unit'], k
        assert got[k]['val'] == pytest.approx(v['val'], rel=IMFIT_RTOL,
                                              abs=1e-12), k


def test_noise_free_products_match(model_params, root):
    pl_j = _executed('jax', model_params, root)
    pl_t = _executed('port', model_params, root)
    run_j, run_t = pl_j.runs[0], pl_t.runs[0]
    assert run_t.completed and run_j.completed
    assert sorted(run_t.products) == sorted(run_j.products)
    rel_paths = {k: os.path.relpath(v, pl_t.dcy)
                 for k, v in run_t.products.items()}
    assert rel_paths == {k: os.path.relpath(v, pl_j.dcy)
                         for k, v in run_j.products.items()}
    assert rel_paths['ms_noisy'] == os.path.join(
        'Day0', '6GHz', 'SynObs', 'SynObs.vla.a.noisy.vis.npz')
    assert os.path.isfile(pl_t.ptgfile)
    assert open(pl_t.ptgfile).read() == open(pl_j.ptgfile).read()
    for key in ('ms_clean', 'ms_noisy'):
        with np.load(run_t.products[key]) as a, \
                np.load(run_j.products[key]) as b:
            assert sorted(a.files) == sorted(b.files) == [
                'freqs', 'resume_sig', 'sigma', 'uvw', 'vis_im', 'vis_re']
            for k in ('uvw', 'freqs', 'sigma'):
                np.testing.assert_array_equal(a[k], b[k])
            vis_t = a['vis_re'] + 1j * a['vis_im']
            vis_j = b['vis_re'] + 1j * b['vis_im']
            assert vis_t.dtype == np.complex128 and vis_t.shape == (1, 21060)
            assert _rel(vis_t, vis_j) < VIS_RTOL
    assert open(run_t.products['estimates']).read() == \
        open(run_j.products['estimates']).read()
    for key in ('clean_image', 'clean_image_pbcor') + AUX:
        img_t, hdr_t = read_fits(run_t.products[key])
        img_j, hdr_j = read_fits(run_j.products[key])
        assert img_t.shape == (500, 500)
        assert _rel(img_t, img_j) < IMG_RTOL, key
        for card in ('BUNIT', 'CRPIX1', 'CRPIX2', 'CDELT1', 'CDELT2',
                     'CRVAL1', 'CRVAL2', 'OBJECT'):
            assert hdr_t[card] == hdr_j[card], (key, card)
        for card in ('BMAJ', 'BMIN', 'BPA'):
            assert hdr_t[card] == pytest.approx(hdr_j[card], rel=1e-9,
                                                abs=1e-9), (key, card)
    _imfit_close(run_t.results['imfit'], run_j.results['imfit'])
    assert run_t.results['flux'] == pytest.approx(run_j.results['flux'],
                                                  rel=1e-9)


def test_noisy_sets_interchange(model_params, root, tmp_path):
    """The port's noisy products carry the JAX package's signature: the
    JAX package's simulate_observation(reuse_vis=True) over the same
    directory (reading the port's Flux FITS) reuses them without
    resampling, and images them as the port did."""
    pl_t = _executed('noisy', model_params, root)
    run_t = pl_t.runs[0]
    with np.load(run_t.products['ms_noisy']) as f:
        noisy = f['vis_re'] + 1j * f['vis_im']
        sigma = float(f['sigma'])
        sig_t = str(f['resume_sig'])
    with np.load(run_t.products['ms_clean']) as f:
        clean = f['vis_re'] + 1j * f['vis_im']
        assert str(f['resume_sig']) == sig_t
    d = noisy - clean
    for part in (d.real, d.imag):
        assert abs(part.std() / sigma - 1.0) < 0.03
    saved = tmp_path / 'port'
    shutil.copytree(run_t.rt_dcy, saved)
    stamps = {k: os.stat(run_t.products[k]).st_mtime_ns
              for k in ('ms_clean', 'ms_noisy')}

    pl_j = rajepy_tpu.Pipeline(rajepy_tpu.JetModel(_small(model_params)),
                               _params(pl_t.dcy))
    run_j = pl_j.runs[0]
    assert run_j.fits_flux == run_t.fits_flux
    prods = jsyn.simulate_observation(pl_j, run_j, reuse_vis=True)
    assert {k: os.stat(prods[k]).st_mtime_ns
            for k in ('ms_clean', 'ms_noisy')} == stamps
    with open(pl_j.log.filename) as f:
        assert 'Reusing sampled visibilities' in f.read()
    with np.load(prods['ms_noisy']) as f:
        assert str(f['resume_sig']) == sig_t
    name = os.path.basename(run_t.products['clean_image'])
    img_t, _ = read_fits(str(saved / name))
    img_j, _ = read_fits(prods['clean_image'])
    assert _rel(img_t, img_j) < IMG_RTOL
    assert open(str(saved / (name[:-5] + '.estimates'))).read() == \
        open(prods['estimates']).read()
    _imfit_close(run_t.results['imfit'], run_j.results['imfit'])
    # ... and the port reuses them too, signature for signature
    shutil.copytree(saved, run_t.rt_dcy, dirs_exist_ok=True)
    stamps = {k: os.stat(run_t.products[k]).st_mtime_ns
              for k in ('ms_clean', 'ms_noisy')}
    res = dict(run_t.results)
    tsyn.simulate_observation(pl_t, run_t, reuse_vis=True)
    assert {k: os.stat(run_t.products[k]).st_mtime_ns
            for k in ('ms_clean', 'ms_noisy')} == stamps
    assert run_t.results['imfit'] == res['imfit']


def test_resume_skips_and_clobber_recomputes(model_params, root):
    pl = _executed('noisy', model_params, root)
    run = pl.runs[0]
    files = sorted(run.products.values()) + [run.fits_flux]
    before = {p: os.stat(p).st_mtime_ns for p in files}
    pl.execute(resume=True, clobber=False, **QUIET)
    assert {p: os.stat(p).st_mtime_ns for p in files} == before
    assert run.completed
    pl.execute(resume=True, clobber=True, **QUIET)
    after = {p: os.stat(p).st_mtime_ns for p in files}
    assert all(after[p] > before[p] for p in files)
    assert pl.runs[0].completed
    # what the resumed pipeline reads back is the run it wrote
    loaded = rajepy_tpu_torch.Pipeline.load_pipeline(pl.save_file,
                                                     device='cpu')
    assert loaded.runs[0].completed
    assert loaded.runs[0].results['imfit'] == pl.runs[0].results['imfit']


@pytest.mark.parametrize('synthobs,rrl,option', [
    (None, True, 'line cubes'),
    ({'deconvolver': 'clark'}, False, "deconvolver='clark'"),
    ({'deconvolver': 'multiscale'}, False, "deconvolver='multiscale'"),
    ({'corruption': {'amp_rms': 0.1}}, False, 'corruption'),
    ({'selfcal': 'phase'}, False, 'selfcal'),
    ({'applycal_gains': 'gains.npz'}, False, 'applycal_gains'),
    ({'export_uvfits': True}, False, 'export_uvfits'),
    ({'shard_imaging': True}, False, 'shard_imaging'),
])
def test_simulate_observation_options_write_their_products(
        synthobs, rrl, option, model_params, tmp_path):
    """Called directly with each option, simulate_observation observes
    the run and writes its restored image and the option's products: an
    RRL run's line cube, deconvolver='clark' and 'multiscale', gain
    corruption, selfcal, gain transfer, UVFITS export, and shard_imaging
    (on one CPU device, unsharded)."""
    pl = rajepy_tpu_torch.Pipeline(
        rajepy_tpu_torch.JetModel(_small(model_params), device='cpu'),
        _params(tmp_path / 'out', rrl=rrl))
    run = pl.runs[-1]
    synthobs = dict(synthobs or {})
    if option == 'applycal_gains':
        # a gains product of the array's 27 antennas, unit modulus
        synthobs['applycal_gains'] = str(tmp_path / 'gains.npz')
        phase = np.linspace(0.0, 2.0, 27)[None]
        np.savez(synthobs['applycal_gains'], g_re=np.cos(phase),
                 g_im=np.sin(phase))
    pl.execute(simobserve=False, **QUIET)
    prods = tsyn.simulate_observation(pl, run, **synthobs)
    img, hdr = read_fits(prods['clean_image'])
    assert img.shape == ((len(run.chan_freqs), 500, 500) if rrl else
                         (500, 500))
    assert np.all(np.isfinite(img)) and hdr['BUNIT'] == 'Jy/beam'
    assert os.path.isfile(prods['ms_noisy'])
    with np.load(prods['ms_noisy']) as f:
        noisy = f['vis_re'] + 1j * f['vis_im']
    if option == 'selfcal':
        sc = run.results['selfcal']
        assert sc['mode'] == 'phase' and sc['n_sol'] == 1
        assert sc['gain_amp_rms'] < 1e-6
        with np.load(prods['gains']) as f:
            assert f['g_re'].shape == (1, 27)
        assert os.path.isfile(prods['ms_selfcal'])
    elif option == 'export_uvfits':
        for tag in ('uvfits_clean', 'uvfits_noisy'):
            back = tsyn.uvfits.read_uvfits(prods[tag])
            want = prods['ms_clean' if tag == 'uvfits_clean' else
                         'ms_noisy']
            with np.load(want) as f:
                np.testing.assert_array_equal(
                    back['vis_re'], f['vis_re'].astype(np.float32))
    elif option == 'applycal_gains':
        with open(pl.log.filename) as f:
            assert 'Applied transferred gain solutions from ' \
                'gains.npz' in f.read()
        assert np.all(np.isfinite(noisy))
    elif option == 'corruption':
        with np.load(prods['ms_clean']) as f:
            clean = f['vis_re'] + 1j * f['vis_im']
        # amplitude errors: the noisy set is far off the clean one
        assert _rel(noisy, clean) > 0.05


def test_synthobs_runs_on_the_models_device(model_params, root,
                                            monkeypatch):
    """Sampling, gridding, CLEAN and restore take the model's device: on a
    CPU model every tensor they make is a CPU tensor, and the chain is
    float64 whatever the model's precision."""
    pl = _executed('port', model_params, root)
    seen = set()
    real = tsyn.imaging.hogbom_clean

    def spy(dirty, psf, *a, **k):
        seen.add((dirty.device.type, dirty.dtype, psf.dtype))
        return real(dirty, psf, *a, **k)

    monkeypatch.setattr(tsyn.imaging, 'hogbom_clean', spy)
    tsyn.simulate_observation(pl, pl.runs[0], niter=5)
    assert seen == {('cpu', torch.float64, torch.float64)}
