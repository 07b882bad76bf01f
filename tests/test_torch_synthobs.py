"""The port's synthobs modules against the JAX package's, on the CPU.

The same inputs, made from numpy seeds, go through each function of
``rajepy_tpu.synthobs`` and its counterpart in ``rajepy_tpu_torch.synthobs``
in float64:

* the host-only copies (``observatories``, ``uvgen``, ``atmosphere``,
  ``imfit``) and the bundled antenna configurations give equal results;
* the sampler (``sky_fft``, the Kaiser-Bessel degrid, ``sample_vis``,
  ``sample_vis_wstack``, ``sample_vis_cube``, ``primary_beam``) agrees to
  1e-12 of max |V|; ``add_noise`` draws another stream (torch's), so it is
  held by its statistics and by its own reproducibility;
* the imaging (``grid_weights``, ``briggs_weights``, ``grid_and_image``
  against both of the JAX function's branches, ``fit_psf_beam``,
  ``gaussian_beam_kernel``, ``restore``) agrees to 1e-12 of the peak, and
  ``hogbom_clean`` gives exactly the JAX while loop's model, residual and
  iteration count on the same inputs;
* ``physics.tau_r_from_params`` agrees to 1e-12.
"""
import copy
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu.ops import physics as jphys
from rajepy_tpu.synthobs import atmosphere as jatm, imaging as jimg, \
    imfit as jfit, observatories as jobs, sampler as jsam, uvgen as juv
from rajepy_tpu_torch.ops import physics as tphys
from rajepy_tpu_torch.synthobs import atmosphere as tatm, imaging as timg, \
    imfit as tfit, observatories as tobs, sampler as tsam, uvgen as tuv
from tests.torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_DIR = os.path.join(ROOT, 'rajepy_tpu_torch', 'data', 'antenna_configs')
RTOL = 1e-12


def _rel(got, want):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    return np.abs(got - want).max() / scale


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------- #
# the copies
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize('name', sorted(
    n for n in os.listdir(CFG_DIR) if n.endswith('.cfg')))
def test_read_antenna_config_equal(name):
    """Every bundled configuration parses to the same positions, dishes
    and names (or is refused alike), and gives the same longest
    baseline; the port reads its own copy of the file."""
    port_path = os.path.join(CFG_DIR, name)
    jax_path = os.path.join(ROOT, 'rajepy_tpu', 'data', 'antenna_configs',
                            name)
    try:
        want = jobs.read_antenna_config(jax_path)
    except ValueError as err:
        with pytest.raises(ValueError, match='coordsys'):
            tobs.read_antenna_config(port_path)
        assert 'coordsys' in str(err)
        return
    got = tobs.read_antenna_config(port_path)
    np.testing.assert_array_equal(got['xyz'], want['xyz'])
    np.testing.assert_array_equal(got['diam'], want['diam'])
    assert got['names'] == want['names']
    assert got['observatory'] == want['observatory']
    assert tobs.max_baseline(port_path) == jobs.max_baseline(jax_path)


def test_observatories_registry_equal():
    assert tobs.observatory_table() == jobs.observatory_table()
    assert tobs.EW_TELESCOPES == jobs.EW_TELESCOPES
    assert tobs.DEFAULT_SEFD == jobs.DEFAULT_SEFD
    assert tobs.CFG_FILES == jobs.CFG_FILES
    for tscop, cfgs in jobs.CFG_FILES.items():
        for cfg in cfgs:
            assert os.path.dirname(tobs.cfg_file(tscop, cfg)) == CFG_DIR
            assert os.path.basename(tobs.cfg_file(tscop, cfg)) == \
                os.path.basename(jobs.cfg_file(tscop, cfg))
        if tscop in ('VLA', 'ALMA', 'ATCA', 'EMERLIN', 'VLBA'):
            assert tobs.observatory_location(tscop) == \
                jobs.observatory_location(tscop)


@pytest.mark.parametrize('t_obs,time_up,ew', [
    (3600., 37282., False), (59400., 37282., False), (74564., 37282., False),
    (3600., 43200., True), (100000., 43200., True), (20., 86400., True)])
def test_uvgen_equal(t_obs, time_up, ew):
    xyz = tobs.read_antenna_config(tobs.cfg_file('VLA', 'A'))['xyz']
    bl_t, pairs_t = tuv.baselines(xyz)
    bl_j, pairs_j = juv.baselines(xyz)
    np.testing.assert_array_equal(bl_t, bl_j)
    np.testing.assert_array_equal(pairs_t, pairs_j)
    plan_t = tuv.plan_scans(t_obs, time_up, ew)
    plan_j = juv.plan_scans(t_obs, time_up, ew)
    for k in ('durations', 'ha_centres'):
        np.testing.assert_array_equal(plan_t[k], plan_j[k])
    for dur, ha_c in zip(plan_j['durations'], plan_j['ha_centres']):
        has = tuv.scan_hour_angles(ha_c, dur, 5.0, max_samples=512)
        np.testing.assert_array_equal(
            has, juv.scan_hour_angles(ha_c, dur, 5.0, max_samples=512))
        np.testing.assert_array_equal(
            tuv.uvw_tracks(bl_t, has, 18.13, -107.6),
            juv.uvw_tracks(bl_j, has, 18.13, -107.6))
        np.testing.assert_array_equal(
            tuv.elevation_track(has, 18.13, 34.08),
            juv.elevation_track(has, 18.13, 34.08))


@pytest.mark.parametrize('pwv', [0.5, 2.0, 8.0])
def test_atmosphere_equal(pwv):
    f = np.geomspace(1e9, 9e11, 257)
    np.testing.assert_array_equal(tatm.zenith_opacity(f, pwv),
                                  jatm.zenith_opacity(f, pwv))
    np.testing.assert_array_equal(tatm.receiver_temperature(f),
                                  jatm.receiver_temperature(f))
    for el in (25.0, 60.0, 90.0):
        np.testing.assert_array_equal(tatm.tsys(f, el, pwv, 270.0),
                                      jatm.tsys(f, el, pwv, 270.0))
        np.testing.assert_array_equal(tatm.sefd_scale(f, el, pwv, 280.0),
                                      jatm.sefd_scale(f, el, pwv, 280.0))


def _gauss_image(n, rng, x0=None, y0=None, sx=2.0, sy=3.0, peak=1.0):
    yy, xx = np.mgrid[0:n, 0:n]
    x0 = n / 2 + 0.3 if x0 is None else x0
    y0 = n / 2 - 0.2 if y0 is None else y0
    return peak * np.exp(-0.5 * (((xx - x0) / sx) ** 2 +
                                 ((yy - y0) / sy) ** 2))


def test_imfit_equal(tmp_path):
    rng = np.random.default_rng(5)
    img = _gauss_image(64, rng, sx=3.0, sy=2.0, peak=0.7) + \
        rng.normal(0, 0.01, (64, 64))
    est = {'peak': 0.5, 'x': 32.0, 'y': 32.0, 'maj_pix': 8.0,
           'min_pix': 5.0, 'pa_deg': 10.0}
    fits = [m.fit_gaussian(img, estimates=est, beam_area_pix=12.0)
            for m in (tfit, jfit)]
    assert fits[0].keys() == fits[1].keys()
    for k in fits[1]:
        assert fits[0][k] == pytest.approx(fits[1][k], rel=RTOL, abs=1e-15)
    paths = [str(tmp_path / f'{i}.imfit') for i in range(2)]
    tfit.write_imfit_summary(paths[0], fits[0], 0.07, 12.0)
    jfit.write_imfit_summary(paths[1], fits[1], 0.07, 12.0)
    assert open(paths[0]).read() == open(paths[1]).read()


# --------------------------------------------------------------------------- #
# physics
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize('freq', [1e9, 6e9, 4.4e10])
def test_tau_r_from_params(freq, model_params):
    import rajepy_tpu_torch
    p = rajepy_tpu_torch.JetModel(
        copy.deepcopy(model_params), device='cpu').params
    for r in (p['geometry']['r_0'], 3.7, 25.0):
        got = tphys.tau_r_from_params(p, freq, r)
        want = float(jphys.tau_r_from_params(p, freq, r))
        assert got == pytest.approx(want, rel=RTOL)
    class _JM:
        params = p
    assert tphys.tau_r_from_jm(_JM, freq, 3.7) == \
        tphys.tau_r_from_params(p, freq, 3.7)


# --------------------------------------------------------------------------- #
# the sampler
# --------------------------------------------------------------------------- #
def _sky(ny, nx, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((ny, nx)) * 1e-3
    img[ny // 2, nx // 2] += 1.0
    img[ny // 3, nx // 4] += 0.4
    return img


def _uv(n, lim, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-lim, lim, n), rng.uniform(-lim, lim, n)


@pytest.mark.parametrize('shape', [(32, 32), (33, 31)])
def test_sky_fft(shape):
    img = _sky(*shape)
    want = np.asarray(jsam.sky_fft(jnp.asarray(img), pad=4))
    assert _rel(tsam.sky_fft(_t(img), pad=4), want) < RTOL


def test_kb_degrid():
    img = _sky(40, 40)
    cell = 1e-7
    grid_j = jsam.sky_fft(jnp.asarray(img))
    u, v = _uv(700, 0.55 / cell)       # some beyond the model's Nyquist
    beta = jsam._kb_beta(jsam._KB_W, 4)
    want = np.asarray(jsam._kb_degrid(grid_j, cell, jnp.asarray(u),
                                      jnp.asarray(v), jsam._KB_W, beta))
    got = tsam._kb_degrid(_t(np.asarray(grid_j)), cell, _t(u), _t(v),
                          tsam._KB_W, beta)
    assert _rel(got, want) < RTOL
    assert np.count_nonzero(want == 0) > 0


@pytest.mark.parametrize('shape', [(32, 32), (33, 31)])
@pytest.mark.parametrize('degrid', ['kb', 'bilinear'])
@pytest.mark.parametrize('centre', ['pixel', 'fits'])
def test_sample_vis(shape, degrid, centre):
    img = _sky(*shape)
    cell = 1e-7
    u, v = _uv(500, 0.45 / cell)
    want = np.asarray(jsam.sample_vis(jnp.asarray(img), cell,
                                      jnp.asarray(u), jnp.asarray(v),
                                      degrid=degrid, centre=centre))
    got = tsam.sample_vis(_t(img), cell, u, v, degrid=degrid, centre=centre)
    assert got.dtype == torch.complex128
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize('n_wplanes', [1, 4])
def test_sample_vis_wstack(n_wplanes):
    img = _sky(32, 32)
    cell = 2e-5                         # a wide field: w matters
    u, v = _uv(300, 0.4 / cell)
    w = np.random.default_rng(3).uniform(-3e3, 3e3, 300)
    want = np.asarray(jsam.sample_vis_wstack(
        jnp.asarray(img), cell, jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(w), n_wplanes=n_wplanes, centre='fits'))
    got = tsam.sample_vis_wstack(_t(img), cell, u, v, w,
                                 n_wplanes=n_wplanes, centre='fits')
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize('pb_model,w_planes', [('gaussian', 0),
                                               ('airy', 0),
                                               ('gaussian', 2)])
def test_sample_vis_cube(pb_model, w_planes):
    sky = np.stack([_sky(32, 32, seed=s) for s in range(3)])
    cell = 2e-6
    xyz = tobs.read_antenna_config(tobs.cfg_file('VLA', 'A'))['xyz'][:6]
    bl, _ = tuv.baselines(xyz)
    uvw = tuv.uvw_tracks(bl, tuv.scan_hour_angles(0.0, 3600., 60.),
                         18.13, -107.6).reshape(-1, 3)
    freqs = np.array([5.8e9, 6.0e9, 6.2e9])
    kw = dict(apply_pb=True, dish_diameter_m=25.0, w_planes=w_planes,
              pb_model=pb_model, pb_blockage_m=2.0 * (pb_model == 'airy'),
              centre='fits')
    want = np.asarray(jsam.sample_vis_cube(jnp.asarray(sky), cell,
                                           jnp.asarray(uvw),
                                           jnp.asarray(freqs), **kw))
    got = tsam.sample_vis_cube(_t(sky), cell, uvw, freqs, **kw)
    assert got.shape == (3, uvw.shape[0])
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize('model', ['gaussian', 'airy'])
def test_primary_beam(model):
    args = (48, 40, 2e-5, 6e9, 25.0)
    want = jsam.primary_beam(*args, model=model, blockage_m=1.5)
    got = tsam.primary_beam(*args, model=model, blockage_m=1.5)
    assert isinstance(got, np.ndarray)
    assert _rel(got, want) < RTOL
    x = np.linspace(0.0, 20.0, 401)
    assert _rel(tsam._j1_over_x(_t(x)), jsam._j1_over_x(jnp.asarray(x))) \
        < RTOL


def test_sampler_host_helpers_equal():
    rng = np.random.default_rng(2)
    uvw = rng.normal(0, 2e4, (100, 3))
    for f in (1.4e9, 4.3e10):
        for r in (1e-5, 1e-3):
            assert tsam.w_term_max_phase_error(uvw, f, r) == \
                jsam.w_term_max_phase_error(uvw, f, r)
            assert tsam.n_wplanes_for(uvw, f, r) == \
                jsam.n_wplanes_for(uvw, f, r)
    assert tsam.thermal_noise_sigma(420., 2e8, 5.) == \
        jsam.thermal_noise_sigma(420., 2e8, 5.)


@pytest.mark.parametrize('sigma', [0.3, np.array([0.1, 0.5])])
def test_add_noise_statistics(sigma):
    """torch's stream is not jax.random's: each part's spread is sigma
    (3%), the noise is centred, and one seed gives the same draws."""
    vis = _t(np.zeros((2, 40000), complex) + (1.0 + 2.0j))
    noisy = tsam.add_noise(7, vis, sigma)
    again = tsam.add_noise(7, vis, sigma)
    other = tsam.add_noise(8, vis, sigma)
    assert torch.equal(noisy, again) and not torch.equal(noisy, other)
    d = (noisy - vis).numpy()
    sig = np.broadcast_to(np.asarray(sigma, float), (2,))
    for c in range(2):
        for part in (d[c].real, d[c].imag):
            assert abs(part.std() / sig[c] - 1.0) < 0.03
            assert abs(part.mean()) < 5 * sig[c] / np.sqrt(part.size)
    assert abs(np.corrcoef(d[0].real, d[0].imag)[0, 1]) < 0.03
    with pytest.raises(ValueError, match='per-channel'):
        tsam.add_noise(1, vis[0], np.array([0.1, 0.2]))


def test_sample_vis_cube_with_noise():
    sky = np.stack([_sky(16, 16, seed=s) for s in range(2)])
    uvw = np.random.default_rng(4).normal(0, 3e3, (400, 3))
    freqs = np.array([6e9, 6.2e9])
    clean, noisy = tsam.sample_vis_cube_with_noise(
        _t(sky), 1e-6, uvw, freqs, 11111, 0.25, apply_pb=True)
    assert torch.equal(clean, tsam.sample_vis_cube(_t(sky), 1e-6, uvw, freqs,
                                                   apply_pb=True))
    assert torch.equal(noisy, tsam.add_noise(11111, clean, 0.25))


# --------------------------------------------------------------------------- #
# imaging
# --------------------------------------------------------------------------- #
def _vis_set(n_vis=3000, lim=4e4, seed=13):
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(-lim, lim, n_vis), rng.uniform(-lim, lim, n_vis)
    vis = rng.normal(size=n_vis) + 1j * rng.normal(size=n_vis)
    w = rng.uniform(0.5, 2.0, n_vis)
    return u, v, vis, w


@pytest.mark.parametrize('chunk', [None, 257])
def test_grid_weights(chunk, monkeypatch):
    if chunk:
        monkeypatch.setattr(timg, '_GRID_CHUNK', chunk)
    u, v, _, w = _vis_set(lim=5e4)    # some beyond the grid
    cell = 1.0 / (8e4 * 4)
    want = np.asarray(jimg.grid_weights(jnp.asarray(u), jnp.asarray(v),
                                        jnp.asarray(w), 64, cell))
    assert _rel(timg.grid_weights(_t(u), _t(v), _t(w), 64, cell), want) \
        < RTOL


@pytest.mark.parametrize('robust', [-2.0, 0.5, 2.0])
def test_briggs_weights(robust):
    u, v, _, w = _vis_set()
    cell = 1.0 / (8e4 * 4)
    want = np.asarray(jimg.briggs_weights(jnp.asarray(u), jnp.asarray(v),
                                          jnp.asarray(w), 64, cell,
                                          robust=robust))
    got = timg.briggs_weights(_t(u), _t(v), _t(w), 64, cell, robust=robust)
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize('branch', ['matmul', 'scatter'])
@pytest.mark.parametrize('chunk', [None, 700])
def test_grid_and_image_both_branches(branch, chunk, monkeypatch):
    """The port's one gridding against each branch of the JAX function:
    its matmul form (n_vis * n_pix under _GRID_MATMUL_MAX) and its
    scatter form (above it; here by lowering the limit)."""
    u, v, vis, w = _vis_set(n_vis=2500, lim=5.5e3)
    cell = 1.0 / (1.2e4 * 4)
    n_pix = 96
    if chunk:
        monkeypatch.setattr(timg, '_GRID_CHUNK', chunk)
    if branch == 'scatter':
        monkeypatch.setattr(jimg, '_GRID_MATMUL_MAX', -1)
    jimg.grid_and_image.clear_cache()
    try:
        dirty_j, psf_j = jimg.grid_and_image(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(vis),
            jnp.asarray(w), n_pix, cell)
    finally:
        jimg.grid_and_image.clear_cache()
    dirty, psf = timg.grid_and_image(_t(u), _t(v), _t(vis), _t(w), n_pix,
                                     cell)
    assert _rel(dirty, np.asarray(dirty_j)) < RTOL
    assert _rel(psf, np.asarray(psf_j)) < RTOL
    assert float(psf[n_pix // 2, n_pix // 2]) == pytest.approx(1.0,
                                                               rel=1e-6)


def _clean_inputs(n=64, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    r2 = (yy - n // 2) ** 2 + (xx - n // 2) ** 2
    psf = np.exp(-r2 / 8.0) * np.cos(np.sqrt(r2) / 3.0)
    dirty = rng.normal(0, 0.01, (n, n))
    for (y, x, a) in ((20, 30, 2.0), (40, 10, 1.0), (32, 33, 3.0),
                      (33, 32, 3.0)):
        dirty += a * np.roll(np.roll(psf, y - n // 2, 0), x - n // 2, 1)
    mask = np.zeros((n, n))
    mask[8:56, 6:58] = 1.0
    return dirty, psf, mask


@pytest.mark.parametrize('niter,threshold,check_every', [
    (500, 0.0, 32), (500, 0.05, 32), (500, 0.05, 1), (137, 0.01, 7),
    (40, 0.0, 64), (500, 1e3, 32)])
def test_hogbom_clean_exact(niter, threshold, check_every, monkeypatch):
    """The same components, residual and count as the JAX while loop, bit
    for bit: the device-gated loop stops where the while loop stops
    (threshold or niter; at once when nothing is above the threshold),
    whatever the host's check interval."""
    monkeypatch.setattr(timg, 'HOGBOM_CHECK_EVERY', check_every)
    dirty, psf, mask = _clean_inputs()
    m_j, r_j, n_j = jimg.hogbom_clean(jnp.asarray(dirty), jnp.asarray(psf),
                                      jnp.asarray(mask), gain=0.1,
                                      niter=niter, threshold=threshold)
    m_t, r_t, n_t = timg.hogbom_clean(_t(dirty), _t(psf), mask, gain=0.1,
                                      niter=niter, threshold=threshold)
    assert n_t == int(n_j)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    if threshold == 1e3:
        assert n_t == 0 and torch.equal(r_t, _t(dirty))


def test_sub_product_rounds_once():
    """``_sub_product`` is ``r - v * x`` rounded once: exact rational
    arithmetic, rounded to the nearest float, gives the same bits."""
    from fractions import Fraction
    rng = np.random.default_rng(17)
    r, x = rng.normal(size=2000), rng.normal(size=2000)
    r[:500] = x[:500] * 0.37          # heavy cancellation
    v = _t(np.array([0.37]))
    got = timg._sub_product(_t(r), v, timg._split(v), _t(x),
                            timg._split(_t(x))).numpy()
    want = np.array([float(Fraction(a) - Fraction(0.37) * Fraction(b))
                     for a, b in zip(r, x)])
    np.testing.assert_array_equal(got, want)


def test_fit_psf_beam_kernel_and_restore():
    u, v, vis, w = _vis_set(n_vis=2500, lim=5.5e3)
    cell = 1.0 / (1.2e4 * 4)
    dirty, psf = timg.grid_and_image(_t(u), _t(v), _t(vis), _t(w), 96, cell)
    beam_t = timg.fit_psf_beam(psf, cell)
    beam_j = jimg.fit_psf_beam(psf.numpy(), cell)
    assert beam_t == pytest.approx(beam_j, rel=RTOL)
    kern_t = timg.gaussian_beam_kernel(96, cell, *beam_t)
    kern_j = jimg.gaussian_beam_kernel(96, cell, *beam_j)
    assert _rel(kern_t, kern_j) < RTOL
    rng = np.random.default_rng(9)
    model = np.zeros((96, 96))
    model[rng.integers(30, 66, 20), rng.integers(30, 66, 20)] = \
        rng.random(20)
    want = np.asarray(jimg.restore(jnp.asarray(model), jnp.asarray(dirty),
                                   jnp.asarray(kern_j)))
    assert _rel(timg.restore(_t(model), dirty, kern_t), want) < RTOL
