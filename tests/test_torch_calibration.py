"""The port's ``synthobs.calibration`` and the calibration branches of
``simulate_observation`` against the JAX package's, on the CPU.

* every function of the module on random sets (8 antennas, 5 time samples,
  2 channels, float64) at 1e-12 of the largest magnitude;
  ``simulate_gain_errors`` bit for bit;
* a campaign of one continuum run (VLA B, 22 GHz, 1,200 s of 60 s
  integrations, 2 channels) and one small H58a run on the conftest jet at
  16 x 40 x 16, with ``params['synthobs']`` asking for noise-free gain
  corruption and two rounds of self-calibration, through both packages'
  ``Pipeline.execute``: the cube run is imaged without selfcal, and the
  continuum run's noisy set (1e-12), selfcal set, gains product, restored
  image (1e-9) and ``results['selfcal']`` (1e-9) match;
* with thermal noise: the JAX package's corrupted noisy sets, reused by
  the port through ``reuse_vis=True``, give the JAX package's selfcal
  results (1e-9);
* gain transfer both ways: each package applies the other's gains product
  to its cube run;
* the ``ValueError``s of the JAX package.
"""
import copy
import os
import shutil

import numpy as np
import pytest
import torch

import rajepy_tpu
import rajepy_tpu_torch
from rajepy_tpu.io.fits import read_fits
from rajepy_tpu.synthobs import calibration as jcal
from rajepy_tpu.synthobs import simulate_observation as jobserve
from rajepy_tpu_torch.synthobs import calibration as tcal
from rajepy_tpu_torch.synthobs import simulate_observation as tobserve
from tests.torch_one_thread import one_thread  # noqa: F401

RTOL = 1e-12
OBS_RTOL = 1e-9
N_ANT, N_T, N_CHAN = 8, 5, 2
CORRUPTION = {'amp_rms': 0.1, 'phase_rms_deg': 50.0, 'coherence_s': 1e5,
              'seed': 99}
SYNTHOBS = {'sefd': 0.0, 'corruption': CORRUPTION, 'selfcal': 'amp+phase',
            'selfcal_rounds': 2}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.max(np.abs(want))
    assert scale > 0 and got.shape == want.shape
    return np.max(np.abs(got - want)) / scale


def _c(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _random_set(seed):
    """Random visibilities, model visibilities and gains on the full pair
    set of N_ANT antennas (time-major, baseline-minor)."""
    rng = np.random.default_rng(seed)
    pairs = np.stack(np.triu_indices(N_ANT, k=1), axis=1)
    a1, a2, ti = jcal.vis_metadata(N_T, pairs)
    shape = (N_CHAN, a1.size)
    mdl = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    g = _c(*jcal.simulate_gain_errors(seed + 1, N_T, N_ANT, amp_rms=0.2,
                                      phase_rms_deg=40.0))
    jr, ji = jcal.apply_gains(mdl.real, mdl.imag, g.real, g.imag, a1, a2, ti)
    vis = _c(jr, ji) + 0.05 * (rng.normal(size=shape) +
                               1j * rng.normal(size=shape))
    return vis, mdl, g, (a1, a2, ti)


@pytest.mark.parametrize('kw', [
    dict(amp_rms=0.15, phase_rms_deg=60.0, coherence_s=600.0, t_int_s=60.0),
    dict(amp_rms=0.3, phase_rms_deg=120.0),
    dict(phase_rms_deg=30.0, coherence_s=0.0, t_int_s=5.0),
    dict()])
def test_simulate_gain_errors_bit_for_bit(kw):
    got = tcal.simulate_gain_errors(7, 40, N_ANT, **kw)
    want = jcal.simulate_gain_errors(7, 40, N_ANT, **kw)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('invert', [False, True])
def test_apply_gains_and_bandpass_match_jax(invert):
    vis, _, g, meta = _random_set(0)
    got = tcal.apply_gains(torch.from_numpy(vis), torch.from_numpy(g),
                           *meta, invert=invert)
    assert got.dtype == torch.complex128 and got.shape == vis.shape
    want = _c(*jcal.apply_gains(vis.real, vis.imag, g.real, g.imag, *meta,
                                invert=invert))
    assert _rel(got.numpy(), want) < RTOL
    gb = np.stack([g, np.conj(g) * 1.1])
    got = tcal.apply_bandpass(vis, gb, *meta, invert=invert)
    want = _c(*jcal.apply_bandpass(vis.real, vis.imag, gb.real, gb.imag,
                                   *meta, invert=invert))
    assert _rel(got.numpy(), want) < RTOL


def test_apply_then_invert_roundtrip():
    vis, _, g, meta = _random_set(1)
    back = tcal.apply_gains(tcal.apply_gains(vis, g, *meta), g, *meta,
                            invert=True)
    assert _rel(back.numpy(), vis) < RTOL


@pytest.mark.parametrize('n_sol', [1, 3])
@pytest.mark.parametrize('mode', ['phase', 'amp+phase'])
def test_solve_gains_matches_jax(mode, n_sol):
    vis, mdl, _, meta = _random_set(2)
    got = tcal.solve_gains(torch.from_numpy(vis), torch.from_numpy(mdl),
                           *meta, n_ant=N_ANT, n_t=N_T, n_sol=n_sol,
                           mode=mode)
    assert got.shape == (n_sol, N_ANT) and got.dtype == torch.complex128
    want = _c(*jcal.solve_gains(vis.real, vis.imag, mdl.real, mdl.imag,
                                *meta, n_ant=N_ANT, n_t=N_T, n_sol=n_sol,
                                mode=mode))
    assert _rel(got.numpy(), want) < RTOL
    # the reference antenna has zero phase in every interval
    assert np.all(np.abs(np.angle(got.numpy()[:, 0])) < 1e-15)


@pytest.mark.parametrize('mode', ['phase', 'amp+phase'])
def test_bandpass_solve_matches_jax(mode):
    vis, mdl, _, meta = _random_set(3)
    got = tcal.solve_gains(vis, mdl, *meta, n_ant=N_ANT, n_t=N_T, n_sol=3,
                           mode=mode, per_channel=True)
    assert got.shape == (N_CHAN, 3, N_ANT)
    want = _c(*jcal.solve_gains(vis.real, vis.imag, mdl.real, mdl.imag,
                                *meta, n_ant=N_ANT, n_t=N_T, n_sol=3,
                                mode=mode, per_channel=True))
    assert _rel(got.numpy(), want) < RTOL


@pytest.mark.parametrize('n_iter', [1, 2, 3])
def test_phase_only_unit_modulus_unconverged(n_iter):
    """The projection after the ADI average keeps |g| = 1 even on the odd
    (averaged) steps of an unconverged solve, as the JAX package's does."""
    vis, mdl, _, meta = _random_set(4)
    got = tcal.solve_gains(vis, mdl, *meta, n_ant=N_ANT, n_t=N_T, n_sol=2,
                           mode='phase', n_iter=n_iter)
    np.testing.assert_allclose(got.abs().numpy(), 1.0, atol=1e-12)
    want = _c(*jcal.solve_gains(vis.real, vis.imag, mdl.real, mdl.imag,
                                *meta, n_ant=N_ANT, n_t=N_T, n_sol=2,
                                mode='phase', n_iter=n_iter))
    assert _rel(got.numpy(), want) < RTOL


def test_solver_guards_zero_denominators():
    """An antenna with no visibilities keeps its gain (the den > 0 guard)
    and a zero reference gain leaves the phases unreferenced, in both
    packages alike."""
    vis, mdl, _, (a1, a2, ti) = _random_set(5)
    dead = (a1 == 0) | (a2 == 0)
    vis[:, dead] = 0.0
    mdl[:, dead] = 0.0
    for mode in ('phase', 'amp+phase'):
        got = tcal.solve_gains(vis, mdl, a1, a2, ti, n_ant=N_ANT, n_t=N_T,
                               mode=mode).numpy()
        want = _c(*jcal.solve_gains(vis.real, vis.imag, mdl.real, mdl.imag,
                                    a1, a2, ti, n_ant=N_ANT, n_t=N_T,
                                    mode=mode))
        assert np.all(np.isfinite(got)) and got[0, 0] == 1.0
        assert _rel(got, want) < RTOL


@pytest.mark.parametrize('shape', ['G', 'B'])
def test_correct_vis_and_expand_match_jax(shape):
    vis, mdl, _, meta = _random_set(6)
    g = tcal.solve_gains(vis, mdl, *meta, n_ant=N_ANT, n_t=N_T, n_sol=2,
                         per_channel=shape == 'B')
    gj = (g.real.numpy(), g.imag.numpy())
    np.testing.assert_array_equal(
        tcal.expand_solutions(g, N_T).numpy(),
        _c(*jcal.expand_solutions(*gj, N_T)))
    got = tcal.correct_vis(torch.from_numpy(vis), g, *meta, N_T)
    want = _c(*jcal.correct_vis(vis.real, vis.imag, *gj, *meta, N_T))
    assert _rel(got.numpy(), want) < RTOL


@pytest.mark.parametrize('explicit', [False, True])
def test_closures_match_jax(explicit):
    vis, _, _, _ = _random_set(7)
    tri = [(0, 2, 5), (1, 3, 7), (4, 5, 6)] if explicit else None
    quad = [(0, 1, 2, 3), (2, 4, 5, 7)] if explicit else None
    got = tcal.bispectrum(torch.from_numpy(vis), N_ANT, N_T, tri)
    assert got.shape == (N_CHAN, N_T, 3 if explicit else 56)
    assert _rel(got.numpy(), _c(*jcal.bispectrum(
        vis.real, vis.imag, N_ANT, N_T, tri))) < RTOL
    cp = tcal.closure_phases(vis, N_ANT, N_T, tri).numpy()
    cp_j = jcal.closure_phases(vis.real, vis.imag, N_ANT, N_T, tri)
    assert np.max(np.abs(np.angle(np.exp(1j * (cp - cp_j))))) < RTOL * np.pi
    la = tcal.log_closure_amplitudes(vis, N_ANT, N_T, quad)
    assert la.shape == (N_CHAN, N_T, 2 if explicit else 70)
    assert _rel(la.numpy(), jcal.log_closure_amplitudes(
        vis.real, vis.imag, N_ANT, N_T, quad)) < RTOL


def test_closure_index_arrays_match_jax():
    got = tcal.closure_index_arrays(N_ANT, device='cpu')
    want = jcal.closure_index_arrays(N_ANT)
    for key in ('tri', 'quad'):
        for g, w in zip(got[key], want[key]):
            assert g.dtype == torch.int64 and g.device.type == 'cpu'
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tcal.baseline_index_table(N_ANT),
                                  jcal.baseline_index_table(N_ANT))
    assert tcal.closure_triangles(2).shape == (0, 3)
    assert tcal.closure_quads(3).shape == (0, 4)


def test_closures_are_gain_immune():
    vis, _, _, meta = _random_set(8)
    g = _c(*tcal.simulate_gain_errors(2, N_T, N_ANT, amp_rms=0.5,
                                      phase_rms_deg=90.0))
    bad = tcal.apply_gains(vis, g, *meta)
    d = tcal.closure_phases(bad, N_ANT, N_T) - \
        tcal.closure_phases(vis, N_ANT, N_T)
    assert float(torch.angle(torch.exp(1j * d)).abs().max()) < 1e-10
    np.testing.assert_allclose(
        tcal.log_closure_amplitudes(bad, N_ANT, N_T).numpy(),
        tcal.log_closure_amplitudes(vis, N_ANT, N_T).numpy(), atol=1e-9)


@pytest.mark.parametrize('n_wplanes', [0, 4])
def test_model_vis_matches_jax(n_wplanes):
    rng = np.random.default_rng(9)
    img = np.zeros((64, 64))
    img[20:40, 25:35] = rng.uniform(0.0, 1.0, (20, 10))
    u, v = rng.uniform(-4e3, 4e3, (2, 300))
    w = rng.uniform(-2e3, 2e3, 300)
    cell = 2e-5
    got = tcal.model_vis(torch.from_numpy(img), cell, u, v, w_wav=w,
                         n_wplanes=n_wplanes)
    assert got.dtype == torch.complex128
    want = _c(*jcal.model_vis(img, cell, u, v, w_wav=w,
                              n_wplanes=n_wplanes))
    assert _rel(got.numpy(), want) < RTOL
    if n_wplanes:
        flat = tcal.model_vis(torch.from_numpy(img), cell, u, v)
        assert _rel(flat.numpy(), got.numpy()) > 1e-6


def test_vis_metadata_and_bad_arguments():
    pairs = np.stack(np.triu_indices(N_ANT, k=1), axis=1)
    for g, w in zip(tcal.vis_metadata(N_T, pairs),
                    jcal.vis_metadata(N_T, pairs)):
        np.testing.assert_array_equal(g, w)
    z = np.zeros(6)
    with pytest.raises(ValueError, match='unknown mode'):
        tcal.solve_gains(z, z, z.astype(int), z.astype(int) + 1,
                         z.astype(int), n_ant=4, n_t=1, mode='bandpass')
    with pytest.raises(ValueError, match='per_channel'):
        tcal.solve_gains(z, z, z.astype(int), z.astype(int) + 1,
                         z.astype(int), n_ant=4, n_t=1, per_channel=True)


def test_solve_gains_recovers_true_gains():
    """Piecewise-constant gains over the solution intervals are recovered
    exactly (the JAX package's StEFCal test, through the port)."""
    rng = np.random.default_rng(10)
    pairs = np.stack(np.triu_indices(10, k=1), axis=1)
    a1, a2, ti = tcal.vis_metadata(8, pairs)
    mdl = rng.normal(size=(1, a1.size)) + 1j * rng.normal(size=(1, a1.size))
    true = _c(*tcal.simulate_gain_errors(11, 4, 10, amp_rms=0.15,
                                         phase_rms_deg=50.0))
    bad = tcal.apply_gains(mdl, tcal.expand_solutions(true, 8), a1, a2, ti)
    sol = tcal.solve_gains(bad, mdl, a1, a2, ti, n_ant=10, n_t=8, n_sol=4,
                           n_iter=60).numpy()
    ref = true[:, :1] / np.abs(true[:, :1])
    np.testing.assert_allclose(sol, true * np.conj(ref), atol=1e-9)
    fixed = tcal.correct_vis(bad, torch.from_numpy(sol), a1, a2, ti, 8)
    np.testing.assert_allclose(fixed.numpy(), mdl, atol=1e-8)


# --------------------------------------------------------------------------- #
# simulate_observation: the campaign through both packages
# --------------------------------------------------------------------------- #
def _pparams(dcy, synthobs=None):
    params = {
        'min_el': 20.,
        'dcys': {'model_dcy': str(dcy)},
        'continuum': {'times': np.array([0.]), 'freqs': np.array([2.2e10]),
                      't_obs': np.array([1200]),
                      'tscps': np.array([('VLA', 'B')]),
                      't_ints': np.array([60]), 'bws': np.array([1e8]),
                      'chanws': np.array([5e7])},
        'rrls': {'times': np.array([0.]), 'lines': np.array(['H58a']),
                 't_obs': np.array([1200]),
                 'tscps': np.array([('VLA', 'B')]),
                 't_ints': np.array([60]), 'bws': np.array([2e6]),
                 'chanws': np.array([5e5])},
    }
    if synthobs is not None:
        params['synthobs'] = copy.deepcopy(synthobs)
    return params


def _small(model_params):
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=16, n_y=40, n_z=16)
    return p


_CAMPAIGNS = {}


def _campaign(which, model_params, root):
    """Both packages' pipelines executed once for the module, with
    ``SYNTHOBS`` from the params file: 'jax' and 'port'."""
    if which not in _CAMPAIGNS:
        p = _small(model_params)
        params = _pparams(root / which, SYNTHOBS)
        if which == 'jax':
            pl = rajepy_tpu.Pipeline(rajepy_tpu.JetModel(p), params)
            pl.execute(resume=False, clobber=True, verbose=False,
                       plot=False, device_fanout=False)
        else:
            pl = rajepy_tpu_torch.Pipeline(
                rajepy_tpu_torch.JetModel(p, device='cpu'), params)
            pl.execute(resume=False, clobber=True, verbose=False,
                       plot=False)
        _CAMPAIGNS[which] = pl
    return _CAMPAIGNS[which]


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return tmp_path_factory.mktemp('calibration')


def _runs(pl):
    cont = next(r for r in pl.runs if r.obs_type == 'continuum')
    cube = next(r for r in pl.runs if r.obs_type != 'continuum')
    return cont, cube


def _vis(path):
    with np.load(path) as f:
        return f['vis_re'] + 1j * f['vis_im']


def _gains(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _selfcal_close(got, want):
    assert got.keys() == want.keys()
    for k in ('mode', 'n_sol', 'rounds'):
        assert got[k] == want[k], k
    for k in ('gain_amp_rms', 'gain_phase_rms_deg', 'dynamic_range_before',
              'dynamic_range_after'):
        assert got[k] == pytest.approx(want[k], rel=OBS_RTOL), k
    assert got['dynamic_range_rounds'] == pytest.approx(
        want['dynamic_range_rounds'], rel=OBS_RTOL)


def test_params_file_selfcal_skips_the_cube_run(model_params, root):
    """params['synthobs'] asks for corruption and selfcal in a campaign
    with an RRL run: both packages observe both runs, image the cube
    without selfcal, and self-calibrate the continuum run alike."""
    cont_j, cube_j = _runs(_campaign('jax', model_params, root))
    cont_t, cube_t = _runs(_campaign('port', model_params, root))
    for cont, cube in ((cont_j, cube_j), (cont_t, cube_t)):
        assert cont.completed and cube.completed
        assert 'selfcal' not in cube.results
        assert os.path.isfile(cube.products['clean_image'])
        assert 'ms_selfcal' not in cube.products
        for key in ('ms_selfcal', 'gains', 'imfit'):
            assert os.path.isfile(cont.products[key]), key
    assert sorted(cont_t.products) == sorted(cont_j.products)
    sc = cont_t.results['selfcal']
    assert sc['mode'] == 'amp+phase' and sc['n_sol'] == 1
    assert sc['rounds'] == 2 and len(sc['dynamic_range_rounds']) == 2
    # the corruption scatters flux; two rounds recover the dynamic range
    assert sc['dynamic_range_after'] > 2 * sc['dynamic_range_before']
    _selfcal_close(sc, cont_j.results['selfcal'])
    # the cube run was observed through the same corruption (no selfcal)
    assert _rel(_vis(cube_t.products['ms_noisy']),
                _vis(cube_j.products['ms_noisy'])) < RTOL


def test_noise_free_selfcal_products_match(model_params, root):
    cont_j, _ = _runs(_campaign('jax', model_params, root))
    cont_t, _ = _runs(_campaign('port', model_params, root))
    pj, pt = cont_j.products, cont_t.products
    # corrupted (noise-free) sets: gains times the clean set
    assert _rel(_vis(pt['ms_noisy']), _vis(pj['ms_noisy'])) < RTOL
    assert _rel(_vis(pt['ms_clean']), _vis(pj['ms_clean'])) < RTOL
    assert _rel(_vis(pt['ms_noisy']), _vis(pt['ms_clean'])) > 0.05
    assert _rel(_vis(pt['ms_selfcal']), _vis(pj['ms_selfcal'])) < OBS_RTOL
    gt, gj = _gains(pt['gains']), _gains(pj['gains'])
    assert sorted(gt) == sorted(gj) == ['g_im', 'g_re', 'mode', 'n_ant',
                                        't_obs']
    for k in ('mode', 'n_ant', 't_obs'):
        assert gt[k] == gj[k] and gt[k].dtype == gj[k].dtype, k
    assert gt['g_re'].shape == (1, 27)
    assert _rel(gt['g_re'] + 1j * gt['g_im'],
                gj['g_re'] + 1j * gj['g_im']) < OBS_RTOL
    img_t, hdr_t = read_fits(pt['clean_image'])
    img_j, hdr_j = read_fits(pj['clean_image'])
    assert _rel(img_t, img_j) < OBS_RTOL
    for card in ('BMAJ', 'BMIN', 'BPA'):
        assert hdr_t[card] == pytest.approx(hdr_j[card], rel=OBS_RTOL)
    # the stages of the selfcal rounds are logged as in the JAX package
    with open(_campaign('port', model_params, root).log.filename) as f:
        text = f.read()
    for stage in ('synthobs: gain corruption',
                  'synthobs: selfcal round 1 (phase, 1 solint)',
                  'synthobs: selfcal round 2 (amp+phase, 1 solint)',
                  'synthobs: mfs imaging (500px, selfcal 2)',
                  'synthobs: selfcal npz write'):
        assert f'[timing] {stage}:' in text, stage


def _over_copy(model_params, pl, dcy):
    """Both packages' pipelines over a copy of ``pl``'s directory (its RT
    products, read by both): constructed, not executed."""
    shutil.copytree(pl.dcy, dcy)
    return (rajepy_tpu.Pipeline(rajepy_tpu.JetModel(_small(model_params)),
                                _pparams(dcy)),
            rajepy_tpu_torch.Pipeline(rajepy_tpu_torch.JetModel(
                _small(model_params), device='cpu'), _pparams(dcy)))


def test_noisy_selfcal_reuses_the_jax_packages_sets(model_params, root,
                                                    tmp_path):
    """With thermal noise, whose stream differs between the packages, the
    JAX package's corrupted noisy set carries the signature the port
    computes: the port's simulate_observation(reuse_vis=True) over the
    same directory takes it and self-calibrates it as the JAX package
    did (phase-only, 240 s solution intervals)."""
    pj, pt = _over_copy(model_params, _campaign('jax', model_params, root),
                        tmp_path / 'noisy')
    kw = dict(corruption={'phase_rms_deg': 40.0, 'coherence_s': 600.0,
                          'seed': 5},
              selfcal='phase', selfcal_solint_s=240.0, niter=200)
    run_j, run_t = _runs(pj)[0], _runs(pt)[0]
    assert run_t.fits_flux == run_j.fits_flux
    prods_j = jobserve(pj, run_j, **kw)
    sc_j = dict(run_j.results['selfcal'])
    assert sc_j['n_sol'] == 5 and sc_j['gain_amp_rms'] < 1e-6
    want = {k: _vis(prods_j[k]) for k in ('ms_noisy', 'ms_selfcal')}
    gains_j = _gains(prods_j['gains'])
    img_j, _ = read_fits(prods_j['clean_image'])
    stamp = os.stat(prods_j['ms_noisy']).st_mtime_ns

    prods_t = tobserve(pt, run_t, reuse_vis=True, **kw)
    assert os.stat(prods_t['ms_noisy']).st_mtime_ns == stamp
    with open(pt.log.filename) as f:
        assert 'Reusing sampled visibilities' in f.read()
    np.testing.assert_array_equal(_vis(prods_t['ms_noisy']),
                                  want['ms_noisy'])
    sc_t = run_t.results['selfcal']
    _selfcal_close(sc_t, sc_j)
    assert sc_t['dynamic_range_after'] > sc_t['dynamic_range_before']
    assert _rel(_vis(prods_t['ms_selfcal']), want['ms_selfcal']) < OBS_RTOL
    gains_t = _gains(prods_t['gains'])
    assert gains_t['g_re'].shape == (5, 27)
    assert _rel(gains_t['g_re'] + 1j * gains_t['g_im'],
                gains_j['g_re'] + 1j * gains_j['g_im']) < OBS_RTOL
    assert _rel(read_fits(prods_t['clean_image'])[0], img_j) < OBS_RTOL


def test_gain_transfer_interchanges(model_params, root, tmp_path):
    """The continuum gains product of each package, applied by the other
    to the cube run observed through the same corruption: the files
    interchange, both give the same corrected set, and the transfer
    removes most of the corruption."""
    cont_j = _runs(_campaign('jax', model_params, root))[0]
    cont_t = _runs(_campaign('port', model_params, root))[0]
    pj, pt = _over_copy(model_params, _campaign('jax', model_params, root),
                        tmp_path / 'transfer')
    cube_j, cube_t = _runs(pj)[1], _runs(pt)[1]
    kw = dict(sefd=0.0, corruption=CORRUPTION, niter=50)
    bad = _vis(tobserve(pt, cube_t, **kw)['ms_noisy'])
    ref = _vis(tobserve(pt, cube_t, sefd=0.0, niter=50)['ms_noisy'])
    fixed_t = _vis(tobserve(pt, cube_t, applycal_gains=cont_j.products[
        'gains'], **kw)['ms_noisy'])
    with open(pt.log.filename) as f:
        assert 'Applied transferred gain solutions from ' \
            'SynObs.vla.b.selfcal.gains.npz' in f.read()
    fixed_j = _vis(jobserve(pj, cube_j, applycal_gains=cont_t.products[
        'gains'], **kw)['ms_noisy'])
    assert _rel(fixed_t, fixed_j) < OBS_RTOL
    err_bad = np.sqrt(np.mean(np.abs(bad - ref) ** 2))
    err_fix = np.sqrt(np.mean(np.abs(fixed_t - ref) ** 2))
    assert err_fix < err_bad / 2


@pytest.mark.parametrize('case', ['selfcal_rounds=0', 'mtmfs', 'cube',
                                  'bad mode', 'antennas', 'zero gain'])
def test_value_errors_as_in_the_jax_package(case, model_params, root,
                                            tmp_path):
    """Both packages refuse the same observations; the port before it
    samples or writes anything (gain transfer: before it writes)."""
    pj, pt = _over_copy(model_params, _campaign('jax', model_params, root),
                        tmp_path / 'errors')
    gains = str(tmp_path / 'g.npz')
    n_ant = 5 if case == 'antennas' else 27
    g_re = np.ones((1, n_ant))
    g_re[0, 3] = 0.0 if case == 'zero gain' else 1.0
    np.savez(gains, g_re=g_re, g_im=np.zeros((1, n_ant)))
    kw, match, which = {
        'selfcal_rounds=0': (dict(selfcal='phase', selfcal_rounds=0),
                             'selfcal_rounds', 0),
        'mtmfs': (dict(selfcal='phase', deconvolver='mtmfs'), 'mtmfs', 0),
        'cube': (dict(selfcal='phase'), 'continuum', 1),
        'bad mode': (dict(selfcal='bandpass'), 'selfcal', 0),
        'antennas': (dict(applycal_gains=gains), 'antennas', 0),
        'zero gain': (dict(applycal_gains=gains), 'zero gains', 0)}[case]
    run_t = _runs(pt)[which]
    synobs = os.path.join(run_t.rt_dcy, 'SynObs')
    shutil.rmtree(synobs)
    with pytest.raises(ValueError, match=match):
        tobserve(pt, run_t, sefd=0.0, niter=10, **kw)
    assert not os.path.exists(synobs)
    with pytest.raises(ValueError, match=match):
        jobserve(pj, _runs(pj)[which], sefd=0.0, niter=10, **kw)
