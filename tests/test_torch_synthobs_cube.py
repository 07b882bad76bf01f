"""The port's line-cube imaging and mfs deconvolvers against the JAX
package's, on the CPU, in float64.

* ``hogbom_clean_batched`` on the JAX test's own inputs: residuals bit for
  bit and models to 1e-13 of the JAX batched loop, the same count; each
  channel bit for bit the port's serial ``hogbom_clean``;
* ``clean_cube`` (6 antennas, 64 x 64 pixels, 6 channels): restored and
  dirty cubes within 1e-9 of each channel's peak, and the same model and
  residual bits whatever the channel block;
* ``clark_clean``, ``multiscale_clean``, ``taylor_stacks`` and
  ``mtmfs_clean`` on the JAX tests' point-source inputs: the same iteration
  count, model and residual within 1e-9 of the dirty peak;
* ``simulate_observation`` and ``Pipeline.execute`` on a 2-channel H58a
  cube (the conftest jet at 16 x 40 x 16, VLA D): every product within
  1e-9, the FREQ cards, ``save_products``, ``pbcor``, the ``ValueError``s,
  visibility sets that each package reuses from the other; a continuum run
  imaged with mtmfs, its Taylor and spectral-index products.
"""
import copy
import os
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import rajepy_tpu
import rajepy_tpu_torch
from rajepy_tpu import synthobs as jsyn
from rajepy_tpu.io.fits import read_fits
from rajepy_tpu.synthobs import imaging as jimg
from rajepy_tpu_torch import synthobs as tsyn
from rajepy_tpu_torch.synthobs import imaging as timg, \
    observatories as tobs, uvgen as tuv
from tests.torch_one_thread import one_thread  # noqa: F401

RTOL = 1e-9


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want, scale=None):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.nanmax(np.abs(want)) if scale is None else scale
    assert scale > 0
    return np.nanmax(np.abs(got - want)) / scale


# --------------------------------------------------------------------------- #
# hogbom_clean_batched
# --------------------------------------------------------------------------- #
def _batched_inputs():
    """tests/test_synthobs.py's TestBatchedClean inputs."""
    rng = np.random.default_rng(11)
    nc, n = 3, 64
    psf = np.zeros((nc, n, n))
    yy, xx = np.mgrid[0:n, 0:n]
    r2 = (yy - n // 2) ** 2 + (xx - n // 2) ** 2
    for c in range(nc):
        psf[c] = np.exp(-r2 / (2.0 * (2.0 + c) ** 2))
    dirty = rng.normal(0, 0.01, (nc, n, n))
    dirty[0, 20, 30] += 2.0
    dirty[1, 40, 10] += 1.0
    dirty[2, 32, 32] += 3.0
    return dirty, psf, np.ones((n, n))


@pytest.mark.parametrize('thr,check_every', [
    ((0.05, 0.5, 0.02), 32), ((0.05, 0.5, 0.02), 7),
    ((0.05, 1e3, 0.0), 32)])
def test_hogbom_clean_batched_exact(thr, check_every, monkeypatch):
    """Against the JAX batched loop: residuals bit for bit, models to
    1e-13, the same count; each channel bit for bit the serial loop's,
    wherever the host's checks drop the finished channels (a channel above
    a huge threshold takes no iteration)."""
    monkeypatch.setattr(timg, 'HOGBOM_CHECK_EVERY', check_every)
    dirty, psf, mask = _batched_inputs()
    thr = np.asarray(thr)
    m_j, r_j, n_j = jimg.hogbom_clean_batched(
        jnp.asarray(dirty), jnp.asarray(psf), jnp.asarray(mask),
        jnp.asarray(thr), gain=0.2, niter=100)
    m_t, r_t, n_t = timg.hogbom_clean_batched(_t(dirty), _t(psf), mask, thr,
                                              gain=0.2, niter=100)
    assert n_t == int(n_j)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0,
                               atol=1e-13)
    counts = []
    for c in range(len(thr)):
        m_s, r_s, n_s = timg.hogbom_clean(_t(dirty[c]), _t(psf[c]), mask,
                                          gain=0.2, niter=100,
                                          threshold=float(thr[c]))
        assert torch.equal(m_s, m_t[c]) and torch.equal(r_s, r_t[c]), c
        counts.append(n_s)
    assert max(counts) == n_t
    if thr[1] == 1e3:
        assert counts[1] == 0 and torch.equal(r_t[1], _t(dirty[1]))


# --------------------------------------------------------------------------- #
# clean_cube
# --------------------------------------------------------------------------- #
def _cube_inputs(n_chan=6, n_pix=64, seed=5):
    """Six VLA A antennas for two hours at 60 s: 15 baselines x 120
    samples; a point source off centre and one on it with channel
    spectra, plus noise."""
    rng = np.random.default_rng(seed)
    xyz = tobs.read_antenna_config(tobs.cfg_file('VLA', 'A'))['xyz'][:6]
    bl, _ = tuv.baselines(xyz)
    uvw = tuv.uvw_tracks(bl, tuv.scan_hour_angles(0.0, 7200., 60.),
                         18.13, -107.6).reshape(-1, 3)
    freqs = 3.285e10 + 1e5 * (np.arange(n_chan) - n_chan // 2)
    lam = 299792458.0 / freqs
    u_max = np.abs(uvw[:, :2]).max() / lam.min()
    cell = 0.4 / u_max
    vis = np.empty((n_chan, uvw.shape[0]), complex)
    for c in range(n_chan):
        u, v = uvw[:, 0] / lam[c], uvw[:, 1] / lam[c]
        vis[c] = (1.0 + 0.3 * c) * np.exp(-2j * np.pi * (
            u * 6 * cell - v * 4 * cell)) + 0.5
        vis[c] += rng.normal(0, 0.3, vis.shape[1]) + \
            1j * rng.normal(0, 0.3, vis.shape[1])
    weights = rng.uniform(0.5, 1.0, uvw.shape[0])
    mask = np.zeros((n_pix, n_pix))
    mask[16:48, 16:48] = 1.0
    kern = timg.gaussian_beam_kernel(n_pix, cell, 3 * cell, 2 * cell, 20.0)
    return uvw, freqs, vis, weights, n_pix, cell, mask, kern


@pytest.mark.parametrize('weighting', ['briggs', 'uniform', 'natural'])
def test_clean_cube_matches_jax(weighting):
    uvw, freqs, vis, w, n_pix, cell, mask, kern = _cube_inputs()
    kw = dict(weighting=weighting, robust=0.5, gain=0.1, niter=200,
              nsigma=2.0)
    rest_j, dirty_j = jimg.clean_cube(
        jnp.asarray(uvw[:, :2]), jnp.asarray(freqs), jnp.asarray(vis.real),
        jnp.asarray(vis.imag), jnp.asarray(w), n_pix, cell,
        jnp.asarray(mask), jnp.asarray(kern), **kw)
    info = {}
    rest_t, dirty_t = timg.clean_cube(uvw, freqs, _t(vis), w, n_pix, cell,
                                      mask, kern, info=info, **kw)
    assert info['chan_block'] == len(freqs) and info['iterations'] > 10
    for c in range(len(freqs)):
        peak = np.abs(np.asarray(dirty_j[c])).max()
        assert _rel(dirty_t[c], np.asarray(dirty_j[c]), peak) < RTOL, c
        assert _rel(rest_t[c], np.asarray(rest_j[c]), peak) < RTOL, c


def test_clean_cube_does_not_depend_on_the_channel_block(monkeypatch):
    """chan_block = 1, 3 and all channels: the same CLEAN models and
    residuals, and the same restored and dirty cubes, bit for bit."""
    uvw, freqs, vis, w, n_pix, cell, mask, kern = _cube_inputs()
    real = timg._hogbom
    outs = {}
    for block in (1, 3, None):
        got = []

        def spy(*a, **k):
            res = real(*a, **k)
            got.append(res)
            return res

        monkeypatch.setattr(timg, '_hogbom', spy)
        info = {}
        cubes = timg.clean_cube(uvw, freqs, _t(vis), w, n_pix, cell, mask,
                                kern, niter=150, nsigma=2.0,
                                chan_block=block, info=info)
        assert info['n_blocks'] == len(got) == \
            -(-len(freqs) // (block or len(freqs)))
        outs[block] = [torch.cat([g[i] for g in got]) for i in range(3)] + \
            list(cubes)
    for block in (1, 3):
        assert all(torch.equal(a, b) for a, b in
                   zip(outs[block], outs[None])), block
    assert int(outs[None][2].sum()) > 0


# --------------------------------------------------------------------------- #
# the mfs deconvolvers
# --------------------------------------------------------------------------- #
_POINT = {}


def _point_source(n_pix=128, flux=3.0):
    """tests/test_synthobs.py's TestImaging point source, gridded once by
    the JAX package: both packages deconvolve the same dirty image and
    PSF."""
    if not _POINT:
        rng = np.random.default_rng(1)
        u = rng.uniform(-4e4, 4e4, 3000)
        v = rng.uniform(-4e4, 4e4, 3000)
        cell = 1.0 / (8e4 * 8)
        w = np.ones_like(u)

        def image(vis):
            d, p = jimg.grid_and_image(jnp.asarray(u), jnp.asarray(v),
                                       jnp.asarray(vis), jnp.asarray(w),
                                       n_pix, cell)
            return np.asarray(d), np.asarray(p)

        _POINT['point'] = image(np.full(u.size, flux, complex))
        # the extended source: a Gaussian of FWHM 10 px and 5 Jy, by DFT
        sig = 10.0 / 2.3548
        yy, xx = np.mgrid[0:n_pix, 0:n_pix] - n_pix // 2
        src = np.exp(-(xx ** 2 + yy ** 2) / (2 * sig ** 2))
        src *= 5.0 / src.sum()
        ll = (np.arange(n_pix) - n_pix // 2) * cell
        lg, mg = np.meshgrid(ll, ll)
        phase = -2.0 * np.pi * (u[:, None] * lg.reshape(-1)[None, :] +
                                v[:, None] * mg.reshape(-1)[None, :])
        _POINT['extended'] = image(np.exp(1j * phase) @ src.reshape(-1))
        # 8 and 5 channels of a point source, alpha = 1.5 and flat
        nu0 = 6e9
        for name, freqs, alpha in (
                ('alpha', np.linspace(0.9, 1.1, 8) * nu0, 1.5),
                ('flat', np.linspace(0.92, 1.08, 5) * nu0, 0.0)):
            planes = [image(np.full(u.size, flux * (f / nu0) ** alpha,
                                    complex)) for f in freqs]
            _POINT[name] = (np.stack([d for d, _ in planes]),
                            np.stack([p for _, p in planes]), freqs, nu0)
    return _POINT


def _same_clean(got, want, peak):
    (m_t, r_t, n_t), (m_j, r_j, n_j) = got, want
    assert n_t == int(n_j)
    assert _rel(m_t, np.asarray(m_j), peak) < RTOL
    assert _rel(r_t, np.asarray(r_j), peak) < RTOL


@pytest.mark.parametrize('kw', [
    dict(gain=0.2, niter=50, cycleniter=10, psf_patch=32),
    dict(gain=0.1, niter=120, threshold=0.05, cycleniter=20),
    dict(gain=0.2, niter=200, threshold=0.03)])
def test_clark_clean_matches_jax(kw):
    """On the JAX tests' point source.  With gain 0.2 and a 0.03 Jy stop
    (the setting of test_clark_matches_hogbom_point_source) the twentieth
    component has to choose between two mirror pixels of the centred
    source whose exact residuals are equal, and differ by 1e-16 after the
    first major cycle's FFTs: torch's FFT and XLA's break that tie
    differently, so there the two agree as the JAX test asks of Clark and
    Hogbom (count within one, models within 0.05 of the flux)."""
    d, p = _point_source()['point']
    mask = np.ones_like(d)
    got = timg.clark_clean(_t(d), _t(p), mask, **kw)
    want = jimg.clark_clean(jnp.asarray(d), jnp.asarray(p),
                            jnp.asarray(mask), **kw)
    if kw.get('threshold') != 0.03:
        _same_clean(got, want, np.abs(d).max())
        return
    assert abs(got[2] - int(want[2])) <= 1
    assert abs(float(got[0].sum()) - float(want[0].sum())) < 0.02 * 3.0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=0.05 * 3.0)
    # up to the tie the two are the same
    kw = dict(kw, niter=19)
    _same_clean(timg.clark_clean(_t(d), _t(p), mask, **kw),
                jimg.clark_clean(jnp.asarray(d), jnp.asarray(p),
                                 jnp.asarray(mask), **kw), np.abs(d).max())


@pytest.mark.parametrize('source,kw', [
    ('point', dict(scales=(0, 4), gain=0.2, niter=200, threshold=0.03)),
    ('point', dict(scales=(0, 3), gain=0.2, niter=50)),
    ('extended', dict(scales=(0, 5, 10), gain=0.1, niter=60)),
    ('extended', dict(scales=(0, 5, 10), gain=0.1, niter=60,
                      smallscalebias=0.6))])
def test_multiscale_clean_matches_jax(source, kw):
    d, p = _point_source()[source]
    mask = np.ones_like(d)
    _same_clean(timg.multiscale_clean(_t(d), _t(p), mask, **kw),
                jimg.multiscale_clean(jnp.asarray(d), jnp.asarray(p),
                                      jnp.asarray(mask), **kw),
                np.abs(d).max())


@pytest.mark.parametrize('source,niter', [('alpha', 300), ('flat', 200)])
def test_taylor_stacks_and_mtmfs_match_jax(source, niter):
    dirty_c, psf_c, freqs, nu0 = _point_source()[source]
    want = jimg.taylor_stacks(jnp.asarray(dirty_c), jnp.asarray(psf_c),
                              jnp.asarray(freqs), nu0, nterms=2)
    got = timg.taylor_stacks(_t(dirty_c), _t(psf_c), freqs, nu0, nterms=2)
    for g, w in zip(got, want):
        assert _rel(g, np.asarray(w)) < 1e-12
    dirty_t, psf_m = (np.asarray(w) for w in want)
    mask = np.ones(dirty_t.shape[1:])
    _same_clean(timg.mtmfs_clean(_t(dirty_t), _t(psf_m), mask, gain=0.2,
                                 niter=niter, threshold=0.03),
                jimg.mtmfs_clean(jnp.asarray(dirty_t), jnp.asarray(psf_m),
                                 jnp.asarray(mask), gain=0.2, niter=niter,
                                 threshold=0.03),
                np.abs(dirty_t[0]).max())


# --------------------------------------------------------------------------- #
# simulate_observation and Pipeline.execute on a cube
# --------------------------------------------------------------------------- #
_EMPTY = {'times': np.array([]), 'freqs': None, 't_obs': None, 'tscps': None,
          't_ints': None, 'bws': None, 'chanws': None}


def _params(dcy, synthobs=None, mtmfs=False):
    """tests/test_model_api.py's 2-channel H58a cube with VLA D; or a
    2-channel continuum run for mtmfs."""
    observed = {'times': np.array([0.]), 't_obs': np.array([1800]),
                'tscps': np.array([('VLA', 'D')]),
                't_ints': np.array([60])}
    params = {'min_el': 20., 'dcys': {'model_dcy': str(dcy)},
              'continuum': dict(_EMPTY), 'rrls': dict(_EMPTY, lines=None)}
    if mtmfs:
        params['continuum'] = dict(observed, freqs=np.array([2.2e10]),
                                   bws=np.array([4e9]),
                                   chanws=np.array([1e9]))
    else:
        params['rrls'] = dict(observed, lines=np.array(['H58a']),
                              bws=np.array([4e6]), chanws=np.array([2e6]))
    if synthobs is not None:
        params['synthobs'] = synthobs
    return params


def _small(model_params):
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=16, n_y=40, n_z=16, l_z=None)
    return p


NOISE_FREE = {'sefd': 0.0, 'pbcor': True,
              'save_products': ('psf', 'dirty', 'model')}
MTMFS = {'sefd': 0.0, 'deconvolver': 'mtmfs', 'nterms': 2, 'niter': 200}
_RUNS = {}


def _executed(which, model_params, root):
    """An executed pipeline, kept for the module: ('jax'|'port', 'cube')
    for the noise-free cube campaign, (.., 'mtmfs') for the continuum run
    imaged with mtmfs."""
    if which not in _RUNS:
        pkg, kind = which
        so = NOISE_FREE if kind == 'cube' else MTMFS
        params = _params(root / f'{pkg}_{kind}', so, mtmfs=kind == 'mtmfs')
        if pkg == 'jax':
            pl = rajepy_tpu.Pipeline(
                rajepy_tpu.JetModel(_small(model_params)), params)
            pl.execute(resume=False, clobber=True, device_fanout=False,
                       verbose=False, plot=False)
        else:
            pl = rajepy_tpu_torch.Pipeline(
                rajepy_tpu_torch.JetModel(_small(model_params),
                                          device='cpu'), params)
            pl.execute(resume=False, clobber=True, verbose=False,
                       plot=False)
        _RUNS[which] = pl
    return _RUNS[which]


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return tmp_path_factory.mktemp('synthobs_cube')


FREQ_CARDS = ('CTYPE3', 'CRPIX3', 'CRVAL3', 'CDELT3', 'CUNIT3')


def test_pipeline_cube_products_match_jax(model_params, root):
    """Pipeline.execute with an observed RRL run: completed, the JAX
    package's products under the same names, each within 1e-9, the FREQ
    axis; the port also writes the model cube, which the JAX package's
    cube imaging does not keep."""
    pl_j = _executed(('jax', 'cube'), model_params, root)
    pl_t = _executed(('port', 'cube'), model_params, root)
    run_j, run_t = pl_j.runs[0], pl_t.runs[0]
    assert run_t.completed and run_j.completed
    assert sorted(run_j.products) == [
        'clean_image', 'clean_image_pbcor', 'dirty', 'ms_clean',
        'ms_noisy', 'psf']
    assert sorted(run_t.products) == sorted(list(run_j.products) +
                                            ['model'])
    assert 'imfit' not in run_t.results
    for key, prod in run_j.products.items():
        prod = run_t.products[key]
        assert os.path.relpath(prod, pl_t.dcy) == \
            os.path.relpath(run_j.products[key], pl_j.dcy)
    assert os.path.basename(run_t.products['clean_image']) == \
        'SynObs.vla.d.noisy.imaging.fits'
    for key in ('clean_image', 'clean_image_pbcor', 'dirty', 'psf'):
        img_t, hdr_t = read_fits(run_t.products[key])
        img_j, hdr_j = read_fits(run_j.products[key])
        assert img_t.shape == ((500, 500) if key == 'psf' else
                               (2, 500, 500)), key
        assert _rel(img_t, img_j) < RTOL, key
        for card in ('BUNIT', 'CRPIX1', 'CDELT2', 'CRVAL1') + FREQ_CARDS:
            assert hdr_t.get(card) == hdr_j.get(card), (key, card)
        for card in ('BMAJ', 'BMIN', 'BPA'):
            assert hdr_t[card] == pytest.approx(hdr_j[card], rel=1e-9,
                                                abs=1e-9), (key, card)
    _, hdr = read_fits(run_t.products['clean_image'])
    freqs = np.asarray(run_t.chan_freqs)
    assert (hdr['CTYPE3'], hdr['CRPIX3'], hdr['CUNIT3']) == \
        ('FREQ', 1.0, 'Hz')
    assert hdr['CRVAL3'] == freqs[0] and \
        hdr['CDELT3'] == freqs[1] - freqs[0]
    np.testing.assert_allclose(run_t.results['flux'], run_j.results['flux'],
                               rtol=1e-9)


def test_cube_save_products_and_pbcor(model_params, root):
    """psf is the common-beam plane without the axis-3 cards, dirty and
    model the cubes with the restored cube's FREQ cards, with no warning
    logged; pbcor divides each channel by its own primary beam."""
    pl = _executed(('port', 'cube'), model_params, root)
    run = pl.runs[0]
    psf, hdr_p = read_fits(run.products['psf'])
    assert psf.ndim == 2 and not any(c in hdr_p for c in FREQ_CARDS)
    assert hdr_p['BUNIT'] == ''
    _, hdr_i = read_fits(run.products['clean_image'])
    for name, bunit in (('dirty', 'Jy/beam'), ('model', 'Jy/pixel')):
        cube, hdr_c = read_fits(run.products[name])
        assert cube.shape == (2, 500, 500) and hdr_c['BUNIT'] == bunit
        assert run.products[name] == \
            run.products['clean_image'][:-5] + f'.{name}.fits'
        for card in FREQ_CARDS:
            assert hdr_c[card] == hdr_i[card], (name, card)
    assert 'residual' not in run.products
    with open(pl.log.filename) as f:
        assert "save_products:" not in f.read()
    img, _ = read_fits(run.products['clean_image'])
    pbc, _ = read_fits(run.products['clean_image_pbcor'])
    mean_dish = float(np.mean(tobs.read_antenna_config(
        tobs.cfg_file('VLA', 'D'))['diam']))
    cell = abs(hdr_i['CDELT2']) * np.pi / 180.0
    for k, f in enumerate(run.chan_freqs):
        pb = tsyn.sampler.primary_beam(500, 500, cell, f, mean_dish)
        np.testing.assert_array_equal(
            pbc[k], np.where(pb >= 0.2, img[k] / pb, np.nan))


@pytest.mark.parametrize('kwargs,match', [
    (dict(deconvolver='clark'), 'continuum'),
    (dict(deconvolver='multiscale'), 'continuum'),
    (dict(deconvolver='mtmfs'), 'continuum'),
    (dict(selfcal='phase'), 'continuum'),
    (dict(deconvolver='maxent'), 'unknown deconvolver')])
def test_cube_value_errors_before_any_work(kwargs, match, model_params,
                                           tmp_path):
    """What the JAX package refuses on a cube, the port refuses alike,
    before it reads or writes anything."""
    pl = rajepy_tpu_torch.Pipeline(
        rajepy_tpu_torch.JetModel(_small(model_params), device='cpu'),
        _params(tmp_path / 'out'))
    run = pl.runs[0]
    with pytest.raises(ValueError, match=match):
        tsyn.simulate_observation(pl, run, **kwargs)
    assert not os.path.exists(run.rt_dcy)
    pl_j = rajepy_tpu.Pipeline(rajepy_tpu.JetModel(_small(model_params)),
                               _params(tmp_path / 'out'))
    pl.execute(simobserve=False, verbose=False, plot=False)
    with pytest.raises(ValueError, match=match):
        jsyn.simulate_observation(pl_j, pl_j.runs[0], sefd=0.0, niter=0,
                                  **kwargs)


def test_cube_visibility_sets_interchange(model_params, root, tmp_path):
    """With thermal noise (each package's own stream): the JAX package's
    simulate_observation(reuse_vis=True) reuses the port's cube sets and
    images them as the port did, and the port reuses the JAX package's."""
    pl_t = _executed(('port', 'cube'), model_params, root)
    run_t = pl_t.runs[0]
    pl_j = rajepy_tpu.Pipeline(rajepy_tpu.JetModel(_small(model_params)),
                               _params(pl_t.dcy))
    run_j = pl_j.runs[0]
    assert run_j.fits_flux == run_t.fits_flux
    for first in ('port', 'jax'):
        shutil.rmtree(os.path.join(run_t.rt_dcy, 'SynObs'),
                      ignore_errors=True)
        made = (tsyn if first == 'port' else jsyn).simulate_observation(
            pl_t if first == 'port' else pl_j,
            run_t if first == 'port' else run_j, niter=50)
        img_first, _ = read_fits(made['clean_image'])
        stamps = {k: os.stat(made[k]).st_mtime_ns
                  for k in ('ms_clean', 'ms_noisy')}
        with np.load(made['ms_noisy']) as f:
            sig = str(f['resume_sig'])
            assert f['vis_re'].shape == (2, 30 * 351)
        again = (jsyn if first == 'port' else tsyn).simulate_observation(
            pl_j if first == 'port' else pl_t,
            run_j if first == 'port' else run_t, niter=50, reuse_vis=True)
        assert {k: os.stat(again[k]).st_mtime_ns
                for k in ('ms_clean', 'ms_noisy')} == stamps, first
        with np.load(again['ms_noisy']) as f:
            assert str(f['resume_sig']) == sig
        img_again, _ = read_fits(again['clean_image'])
        assert _rel(img_again, img_first) < RTOL, first
    with open(pl_t.log.filename) as f:
        assert 'Reusing sampled visibilities' in f.read()


def test_mtmfs_products_match_jax(model_params, root):
    """A 4-channel continuum run imaged with deconvolver='mtmfs': tt0 (the
    restored image), tt1, alpha and alpha.error within 1e-9, with their
    BUNIT cards."""
    pl_j = _executed(('jax', 'mtmfs'), model_params, root)
    pl_t = _executed(('port', 'mtmfs'), model_params, root)
    run_j, run_t = pl_j.runs[0], pl_t.runs[0]
    assert run_t.completed and len(run_t.chan_freqs) == 4
    assert sorted(run_t.products) == sorted(run_j.products)
    units = {'clean_image': 'Jy/beam', 'clean_image_tt1': 'Jy/beam',
             'alpha': '', 'alpha_error': ''}
    for key, unit in units.items():
        img_t, hdr_t = read_fits(run_t.products[key])
        img_j, _ = read_fits(run_j.products[key])
        assert hdr_t['BUNIT'] == unit
        np.testing.assert_array_equal(np.isnan(img_t), np.isnan(img_j))
        assert _rel(img_t, img_j) < RTOL, key
    assert np.isfinite(read_fits(run_t.products['alpha'])[0]).any()
    assert run_t.results['imfit'].keys() == run_j.results['imfit'].keys()
