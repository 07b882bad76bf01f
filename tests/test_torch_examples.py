"""The port's examples (``rajepy_tpu_torch.examples``) against the JAX
package on the CPU, each at a reduced size that is the same in both.

Each example's ``main(device='cpu', ...)`` runs as shipped apart from its
size keywords; the JAX side is the same few ``rajepy_tpu`` calls on the
same inputs, written here (the JAX examples under ``examples/`` are only
read, by ``ast``).  Held:

* float64 to the parity contract of ``docs/MIGRATION.md``: 1e-9 on
  continuum and geometry numbers (SED, index and turnover maps, light
  curves, the sharded maps and fanned runs, the w-term bound and plane
  count, the DFT errors, the alpha table), 1e-6 on RRL and departure
  numbers (b_n, line-centre fluxes, their ratio);
* ``single_chip_production`` at 32^3 as shipped (float32, the kernels'
  plain versions) against the JAX package's float32 calls, and its
  continuum sections on float64 models of both packages;
* ``multi_chip_sharded`` on eight CPU shards against the session's
  8-device JAX mesh, with the same (2, 4) mesh shape;
* fit trajectories after a few steps to 1e-9, as the fit tests hold
  them; the Laplace sigmas to 1e-8;
* the outputs driven by torch's noise stream (MALA, the selfcal dynamic
  ranges, the fit to the noisy UVFITS file) by their statistics, and the
  UVFITS fit on the port's file through both packages;
* that each ``main()`` returns the numbers it prints, and that its size
  keywords default to the JAX example's values.

No float64 RRL cube runs here (the 9- and 17-channel spectra do).
"""
import ast
import copy
import inspect
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import rajepy_tpu
from rajepy_tpu import JetModel as JaxJetModel
from rajepy_tpu import fit as jfit
from rajepy_tpu.models import analysis as jana
from rajepy_tpu.ops import departure as jdep
from rajepy_tpu.parallel import fanout as jfan, sharding as jsh
from rajepy_tpu.synthobs import calibration as jcal, sampler as jsamp
from rajepy_tpu.synthobs import uvfits as juvfits
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.examples import (calibration_workflow,
                                       fit_parameters, multi_chip_sharded,
                                       nonlte_and_surveys,
                                       single_chip_production,
                                       uvfits_interchange, wide_field_vlbi)
from rajepy_tpu_torch.models import analysis as tana
from rajepy_tpu_torch.parallel import sharding as tsh
from rajepy_tpu_torch.synthobs import sampler as tsamp
from tests.test_torch_fit import jit_forwards
from tests.torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YEAR = 31536000.0
CONT, RRL = 1e-9, 1e-6          # docs/MIGRATION.md's parity contract
FIT = 1e-9                      # tests/test_torch_fit*.py's trajectories
F32 = 2e-4                      # float32 against float32 (chip_smoke MAP_RTOL)
EXAMPLES = ('single_chip_production', 'multi_chip_sharded',
            'nonlte_and_surveys', 'fit_parameters', 'calibration_workflow',
            'uvfits_interchange', 'wide_field_vlbi')


def _rel(got, want):
    got = np.nan_to_num(np.asarray(got, dtype=complex))
    want = np.nan_to_num(np.asarray(want, dtype=complex))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    return float(np.abs(got - want).max() / scale)


def _same_nan(got, want):
    np.testing.assert_array_equal(np.isnan(np.asarray(got, dtype=float)),
                                  np.isnan(np.asarray(want, dtype=float)))


def _printed(capsys, *pairs):
    """The text ``main`` printed, after checking that each (format, value)
    of what it returned appears in it."""
    text = capsys.readouterr().out
    for fmt, value in pairs:
        assert format(value, fmt) in text, (fmt, value)
    return text


def _jax_params(grid, **extra):
    p = JaxJetModel.py_to_dict(os.path.join(rajepy_tpu.cfg.dcys['files'],
                                            'example-model-params.py'))
    p['grid'].update(n_x=grid[0], n_y=grid[1], n_z=grid[2], l_z=None,
                     **extra)
    return p


def _same_fit(res_t, res_j, tol=FIT):
    np.testing.assert_allclose(res_t.loss, np.asarray(res_j.loss), rtol=tol)
    np.testing.assert_allclose(res_t.theta, np.asarray(res_j.theta),
                               rtol=tol)
    assert res_t.loss[-1] < res_t.loss[0]


# --------------------------------------------------------------------------- #
# the keywords' defaults are the JAX examples' values
# --------------------------------------------------------------------------- #
# keyword -> (the JAX example's call, its keyword(s)) that sets the value
DEFAULTS = {
    'single_chip_production': {'grid': ('update', ('n_x', 'n_y', 'n_z'))},
    'multi_chip_sharded': {},
    'nonlte_and_surveys': {'grid': ('update', ('n_x', 'n_y', 'n_z'))},
    'fit_parameters': {'grid': ('update', ('n_x', 'n_y', 'n_z')),
                       'sed_steps': ('fit_sed', 'steps'),
                       'mala_steps': ('sample_posterior', 'steps'),
                       'mala_burn': ('sample_posterior', 'burn'),
                       'chains': ('sample_posterior', 'chains'),
                       'lc_steps': ('fit_light_curve', 'steps'),
                       'rrl_steps': ('fit_rrl_spectrum', 'steps')},
    'calibration_workflow': {'closure_steps': ('fit_closures', 'steps')},
    'uvfits_interchange': {'steps': ('fit_uvfits', 'steps')},
    'wide_field_vlbi': {'steps': ('fit_visibilities', 'steps')},
}
OUT_DIR = ('calibration_workflow', 'uvfits_interchange')


def _calls(path):
    """(callee name, {keyword: literal}) of each call in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = getattr(node.func, 'attr', getattr(node.func, 'id', None))
            kws = {}
            for k in node.keywords:
                try:
                    kws[k.arg] = ast.literal_eval(k.value)
                except ValueError:
                    pass
            out.append((name, kws))
    return out


def _first(calls, name, keys):
    for callee, kws in calls:
        if callee == name and all(k in kws for k in keys):
            return tuple(kws[k] for k in keys)
    raise AssertionError(f"no call of {name} with {keys}")


@pytest.mark.parametrize('name', EXAMPLES)
def test_defaults_are_the_jax_examples_values(name):
    """Each ``main``'s keywords are ``device`` (default 'cuda'), the
    output directory where the example writes files, the grid size and the
    step and chain counts; each size and count defaults to the JAX
    example's value, read from its source; the temporary directory has
    the JAX example's prefix."""
    import importlib
    mod = importlib.import_module(f'rajepy_tpu_torch.examples.{name}')
    sig = inspect.signature(mod.main)
    assert all(p.kind == p.KEYWORD_ONLY for p in sig.parameters.values())
    assert sig.parameters['device'].default == 'cuda'
    want = set(DEFAULTS[name]) | {'device'} | (
        {'out'} if name in OUT_DIR else set())
    assert set(sig.parameters) == want
    jax_calls = _calls(os.path.join(ROOT, 'examples', f'{name}.py'))
    for kw, (callee, keys) in DEFAULTS[name].items():
        keys = (keys,) if isinstance(keys, str) else keys
        got = sig.parameters[kw].default
        value = _first(jax_calls, callee, keys)
        assert (tuple(got) if len(keys) > 1 else (got,)) == value, kw
    if name in OUT_DIR:
        assert sig.parameters['out'].default is None
        port_calls = _calls(mod.__file__)
        assert _first(port_calls, 'mkdtemp', ('prefix',)) == \
            _first(jax_calls, 'mkdtemp', ('prefix',))


# --------------------------------------------------------------------------- #
# single_chip_production
# --------------------------------------------------------------------------- #
PROD_GRID = (32, 32, 32)


def _production_sections(ana, jm, freqs):
    """The example's continuum sections, in either package."""
    prof = jm.conservation_profiles()
    return {'sed': ana.sed(jm, freqs),
            'alpha': ana.spectral_index_map(jm, 5e9, 1.5e10,
                                            min_flux_jy=1e-12),
            'turnover': ana.turnover_map(jm, freqs),
            'light_curve': ana.light_curve(jm, np.linspace(0., 3., 25),
                                           [6e9, 2.2e10]),
            'mass': prof['mass']}


@pytest.fixture(scope='module')
def production_jax():
    """The example's params at 32^3 and the JAX package's float64
    continuum sections of them."""
    p = _jax_params(PROD_GRID, c_size=0.25)
    freqs = np.logspace(np.log10(3e8), np.log10(3e11), 24).astype(
        np.float32)
    return p, _production_sections(jana, JaxJetModel(copy.deepcopy(p)),
                                   freqs)


def test_single_chip_production_float32(capsys, production_jax):
    """As shipped (float32, the kernels' plain versions on the CPU) at
    32^3: its SED, maps, light curve and jet mass against the JAX
    package's float64 sections (float32's 2e-4), its H58a cube against the
    JAX package's float32 cube (1e-3, the float32 Faddeeva path); the
    numbers it prints are those it returns."""
    p, want = production_jax
    out = single_chip_production.main(device='cpu', grid=PROD_GRID)
    _printed(capsys, ('.3e', out['lc_6GHz_min']), ('.3e', out['lc_6GHz_max']),
             ('.3e', out['total_mass']), ('d', out['n_rbins']),
             ('.1f', out['times']['fill']), ('.1f', out['times']['rrl_cube']))
    jm = out['model']
    assert jm.dtype == torch.float32 and jm.nx == 32
    assert out['tau_cube'].shape == (128, 32, 32)
    for key in ('sed', 'alpha', 'turnover', 'light_curve'):
        assert _rel(out[key], want[key]) < F32, key
    _same_nan(out['alpha'], want['alpha'])
    _same_nan(out['turnover'], want['turnover'])
    assert _rel(out['profiles']['mass'], want['mass']) < F32
    assert out['n_rbins'] == int((want['mass'] > 0).sum())
    tau_j = JaxJetModel(copy.deepcopy(p), dtype=jnp.float32).optical_depth_rrl(
        'H58a', out['chans'])
    assert _rel(out['tau_cube'], tau_j) < 1e-3
    assert out['S_1.5GHz'] == out['sed'][8]
    assert out['S_44GHz'] == out['sed'][18]
    assert set(out['times']) == {'fill', 'sed_maps', 'rrl_cube',
                                 'light_curve', 'diagnostics'}


def test_single_chip_production_float64_sections(production_jax):
    """The example's continuum sections on float64 models of both
    packages at 32^3, c_size 0.25: 1e-9."""
    p, want = production_jax
    jm = JetModel(copy.deepcopy(p), device='cpu')
    got = _production_sections(tana, jm, np.logspace(
        np.log10(3e8), np.log10(3e11), 24).astype(np.float32))
    for key in want:
        assert _rel(got[key], want[key]) < CONT, key
    _same_nan(got['alpha'], want['alpha'])
    _same_nan(got['turnover'], want['turnover'])


# --------------------------------------------------------------------------- #
# multi_chip_sharded
# --------------------------------------------------------------------------- #
def test_multi_chip_sharded_on_eight_cpu_shards(capsys, monkeypatch):
    """Eight CPU shards, a (2, 4) mesh, against the session's 8-device JAX
    mesh: the sharded EM and flux maps, the light curve's epochs and the
    fanned runs to 1e-9."""
    if jax.device_count() < 8:
        pytest.skip("needs xla_force_host_platform_device_count=8")
    monkeypatch.setattr(tsh, 'available_devices',
                        lambda device: [torch.device('cpu')] * 8)
    out = multi_chip_sharded.main(device='cpu')
    text = _printed(capsys, ('.3e', out['total']))
    assert "mesh: {'chan': 2, 'los': 4}" in text
    assert out['mesh'] == {'chan': 2, 'los': 4}
    assert str(tuple(out['fanned'][2].shape)) in text
    assert out['fluxes'].shape == (8, 64, 64)
    jm = out['model']
    assert (jm.nx, jm.ny, jm.nz) == (64, 64, 64)

    mesh = jsh.make_mesh(n_los=4, n_chan=2)
    jj = JaxJetModel(_jax_params((64, 64, 64)))
    freqs = jnp.linspace(1e9, 5e10, 4 * 2)
    with mesh:
        step = jsh.sharded_rt_products(
            mesh, jj.params['properties']['T_0'], False, jj.csize,
            jj.params['target']['dist'])
        fs = jsh.sharded_static_fields(
            mesh, jj._static_params(), jj._ss_jml_rb_frac, jj.nx, jj.ny,
            jj.nz, jj.csize, with_time=jj._has_bursts)
        em, taus, fluxes = step(
            jax.device_put(freqs, jsh.chan_sharding(mesh)), fs.nd, fs.xi,
            fs.temp, fs.ff, fs.area, fs.inside)
    assert _rel(out['em'], em) < CONT
    assert _rel(out['taus'], taus) < CONT
    assert _rel(out['fluxes'], fluxes) < CONT
    assert out['total'] == pytest.approx(float(jnp.sum(fluxes[0])), rel=CONT)
    lc = jsh.light_curve_sharded(jj, out['lc_years'], freqs[:2])
    assert _rel(out['light_curve'], lc) < CONT
    fanned = jfan.continuum_runs_fanout(jj, out['years'], out['freqs_mat'])
    for got, want in zip(out['fanned'], fanned):
        assert _rel(got, want) < CONT
    np.testing.assert_array_equal(
        out['totals'], np.round(np.asarray(fanned[2]).sum(axis=(1, 2, 3)), 6))


# --------------------------------------------------------------------------- #
# nonlte_and_surveys
# --------------------------------------------------------------------------- #
NONLTE_GRID = (16, 40, 16)


def test_nonlte_and_surveys(capsys):
    """At 16x40x16: the conditions, b_n and the systematic, the LTE,
    non-LTE and per-sightline line-centre fluxes and their ratio to 1e-6;
    the sweep's alpha table to 1e-9."""
    out = nonlte_and_surveys.main(device='cpu', grid=NONLTE_GRID)
    text = _printed(capsys, ('.0f', out['T_e']), ('.2e', out['n_e']),
                    ('.4f', out['b_58']), ('.4f', out['b_59']),
                    ('.3e', out['s_lte'][4]), ('.3e', out['s_nonlte'][4]),
                    ('.3f', out['ratio']), ('.3e', out['s_map'][4]),
                    ('.1e', out['systematic'][0]),
                    ('.1e', out['systematic'][1]))
    assert f"n=58 -> {out['b_n58']}  n=100 -> {out['b_n100']}" in text
    assert np.array_str(out['alpha'], precision=3) in text
    assert text.rstrip().endswith('OK')

    jj = JaxJetModel(_jax_params(NONLTE_GRID))
    jj.time = 2.0 * YEAR
    t_c, ne_c = jj.characteristic_conditions()
    assert out['T_e'] == pytest.approx(t_c, rel=RRL)
    assert out['n_e'] == pytest.approx(ne_c, rel=RRL)
    assert (out['b_58'], out['b_59']) == pytest.approx(
        jj.departure_coefficients('H58a'), rel=RRL)
    freqs = out['freqs']
    s_lte = np.nansum(jj.flux_rrl('H58a', freqs), axis=(1, 2))
    s_nl = np.nansum(jj.flux_rrl('H58a', freqs, lte=False), axis=(1, 2))
    assert _rel(out['s_lte'], s_lte) < RRL
    assert _rel(out['s_nonlte'], s_nl) < RRL
    assert out['ratio'] == pytest.approx(s_nl[4] / s_lte[4], rel=RRL)
    b1m, b2m = jj.departure_coefficient_maps('H58a')
    assert _rel(out['b1_map'], b1m) < RRL
    assert _rel(out['b2_map'], b2m) < RRL
    s_map = np.nansum(jj.flux_rrl('H58a', freqs, lte=False,
                                  departure_coeffs=(b1m, b2m)), axis=(1, 2))
    assert _rel(out['s_map'], s_map) < RRL
    assert _rel(out['b_n'], jdep.solve_bn(1e4, 1e6)) < RRL
    assert out['systematic'] == pytest.approx(
        jdep.b_n_pair_systematic(58, 1, t_c, ne_c), rel=RRL)
    res = jfit.sweep(jj, out['sed_freqs'], out['sweep_grid'])
    assert _rel(out['sweep'], res.values) < CONT
    cube = res.reshaped()
    alpha = (np.log10(cube[..., 1] / cube[..., 0]) /
             np.log10(out['sed_freqs'][1] / out['sed_freqs'][0]))
    assert _rel(out['alpha'], alpha) < CONT


# --------------------------------------------------------------------------- #
# fit_parameters
# --------------------------------------------------------------------------- #
FIT_GRID = (16, 16, 16)
FIT_STEPS = dict(sed_steps=10, mala_steps=20, mala_burn=5, chains=2,
                 lc_steps=5, rrl_steps=5)


def test_fit_parameters(capsys):
    """At 16^3 and a few steps: the synthetic SED, light curve and H58a
    spectrum against the JAX package's (1e-9, 1e-9, 1e-6); each fit's
    trajectory on the same observations to 1e-9; the Laplace sigmas to
    1e-8; MALA by its statistics."""
    out = fit_parameters.main(device='cpu', grid=FIT_GRID, **FIT_STEPS)
    res, res_lc, res_l = out['sed'], out['light_curve'], out['rrl']
    post, q = out['posterior'], out['posterior_mlr_bj']
    _printed(capsys, ('.3e', res.values['properties.mlr_bj']),
             ('.1e', out['sigma']['properties.mlr_bj']),
             ('.1f', res.values['properties.T_0']),
             ('.1f', out['sigma']['properties.T_0']),
             ('.3e', res.loss[0]), ('.3e', res.loss[-1]), ('.3e', q[1]),
             ('.2f', post.acceptance),
             ('.3f', post.r_hat['properties.mlr_bj']),
             ('.4f', res_lc.t_0[0]), ('.4f', res_lc.hl[0]),
             ('.4f', res_lc.chi[0]),
             ('.1f', res_l.values['properties.T_0']),
             ('.3f', res_l.values['target.v_lsr']))
    base = _jax_params(FIT_GRID)
    free = ('properties.mlr_bj', 'properties.T_0')

    # 1. SED: the synthetic SED, the fit, the Laplace sigmas, MALA
    true = copy.deepcopy(base)
    true['properties'].update(mlr_bj=2.5e-7, T_0=6000.0)
    jt = JaxJetModel(true)
    jt.time = 2.0 * YEAR
    freqs = out['sed_freqs']
    observed = out['sed_observed']
    assert _rel(observed, np.nansum(jt.flux_ff(freqs), axis=(1, 2))) < CONT
    jg = JaxJetModel(copy.deepcopy(base))
    jg.time = 2.0 * YEAR
    res_j = jfit.fit_sed(jg, freqs, observed, free=free,
                         steps=FIT_STEPS['sed_steps'], learning_rate=0.05)
    _same_fit(res, res_j)
    fwd, _ = jit_forwards(jfit.build_sed_forward)(jg, freqs, free)
    sig, cov = jfit.laplace_uncertainties(fwd, res_j.theta, observed, free)
    np.testing.assert_allclose(out['cov'], cov, rtol=1e-8)
    for p in free:
        assert out['sigma'][p] == pytest.approx(sig[p], rel=1e-8)
    n = FIT_STEPS['chains'] * (FIT_STEPS['mala_steps'] -
                               FIT_STEPS['mala_burn'])
    for p in free:
        smp = post.samples[p]
        assert smp.shape == (n,) and np.all(np.isfinite(smp))
        assert abs(np.median(smp) - res.values[p]) < 5 * out['sigma'][p]
    assert 0.0 < post.acceptance <= 1.0
    assert np.isfinite(post.r_hat['properties.mlr_bj'])

    # 2. the light curve's observations and the burst fit
    burst = copy.deepcopy(base)
    burst['ejection'] = {'t_0': np.array([1.2]), 'hl': np.array([0.4]),
                         'chi': np.array([4.0]), 'which': np.array(['B'])}
    jb = JaxJetModel(burst)
    lc = []
    for t in out['lc_times']:
        jb.time = t
        lc.append(np.nansum(jb.flux_ff(np.array([4.4e10])), axis=(1, 2)))
    assert _rel(out['lc_observed'], np.asarray(lc)) < CONT
    guess = copy.deepcopy(base)
    guess['ejection'] = {'t_0': np.array([1.8]), 'hl': np.array([0.7]),
                         'chi': np.array([2.0]), 'which': np.array(['B'])}
    lc_j = jfit.fit_light_curve(JaxJetModel(guess), out['lc_times'],
                                np.array([4.4e10]), out['lc_observed'],
                                steps=FIT_STEPS['lc_steps'],
                                learning_rate=0.03)
    np.testing.assert_allclose(res_lc.loss, np.asarray(lc_j.loss), rtol=FIT)
    for k in ('t_0', 'hl', 'chi'):
        np.testing.assert_allclose(getattr(res_lc, k), getattr(lc_j, k),
                                   rtol=FIT)
    assert res_lc.loss[-1] < res_lc.loss[0]

    # 3. the H58a line profile and its fit
    line = copy.deepcopy(base)
    line['properties']['T_0'] = 7000.0
    line['target']['v_lsr'] = 25.0
    jl = JaxJetModel(line)
    jl.time = 2.0 * YEAR
    spectrum = np.nansum(jl.flux_rrl('H58a', out['rrl_chans'], contsub=True),
                         axis=(1, 2))
    assert _rel(out['rrl_observed'], spectrum) < RRL
    jg = JaxJetModel(copy.deepcopy(base))
    jg.time = 2.0 * YEAR
    res_lj = jfit.fit_rrl_spectrum(jg, 'H58a', out['rrl_chans'],
                                   out['rrl_observed'],
                                   steps=FIT_STEPS['rrl_steps'],
                                   learning_rate=0.2)
    _same_fit(res_l, res_lj)


# --------------------------------------------------------------------------- #
# calibration_workflow
# --------------------------------------------------------------------------- #
def test_calibration_workflow(capsys, tmp_path):
    """As shipped but 10 closure steps: the selfcal dynamic range (torch's
    noise) rises every round and at least 1.5 times in all (the JAX
    example: 33.5 -> 72.4 -> 74.9); the noise-free visibilities, the
    gain-corrupted ones and the closure fit's trajectory against the JAX
    package (1e-9)."""
    out = calibration_workflow.main(device='cpu', out=str(tmp_path),
                                    closure_steps=10)
    dr = [out['dynamic_range_before']] + out['dynamic_range_rounds']
    text = _printed(capsys, *(('.1f', d) for d in dr),
                    ('.4e', out['mlr_bj']))
    assert f"({out['selfcal']['rounds']} rounds, " \
           f"{out['selfcal']['n_sol']} solints)" in text
    assert out['selfcal']['rounds'] == 2 and len(dr) == 3
    assert all(b > a for a, b in zip(dr, dr[1:])), dr
    assert dr[-1] > 1.5 * dr[0], dr
    if out['figure'] is not None:
        assert os.path.isfile(out['figure'])
    for key in ('ms_noisy', 'ms_selfcal', 'gains'):
        assert os.path.isfile(out['products'][key])
        assert out['products'][key].startswith(str(tmp_path))

    p = _jax_params((16, 16, 16))
    true = copy.deepcopy(p)
    true['properties'].update(mlr_bj=2e-7)
    jt = JaxJetModel(true)
    jt.time = 0.0
    fwd, th = jit_forwards(jfit.build_vis_forward)(
        jt, out['freqs'], out['uvw'], ('properties.mlr_bj',))
    vis = np.asarray(fwd(th))
    assert _rel(out['vis'], vis) < CONT
    n_ant, n_t = 8, 6
    g_re, g_im = jcal.simulate_gain_errors(7, n_t, n_ant, amp_rms=0.3,
                                           phase_rms_deg=80.0)
    np.testing.assert_array_equal(out['gains'], g_re + 1j * g_im)
    pairs = np.stack(np.triu_indices(n_ant, k=1), axis=1)
    a1, a2, tix = jcal.vis_metadata(n_t, pairs)
    cr, ci = jcal.apply_gains(vis.real, vis.imag, g_re, g_im, a1, a2, tix)
    vis_corr = np.asarray(cr) + 1j * np.asarray(ci)
    assert _rel(out['vis_corr'], vis_corr) < CONT
    jf = JaxJetModel(p)
    jf.time = 0.0
    res_j = jfit.fit_closures(jf, out['freqs'], out['uvw'], out['vis_corr'],
                              n_ant=n_ant, n_t=n_t,
                              free=('properties.mlr_bj',), steps=10)
    _same_fit(out['closure'], res_j)


# --------------------------------------------------------------------------- #
# uvfits_interchange
# --------------------------------------------------------------------------- #
def test_uvfits_interchange(capsys, tmp_path):
    """As shipped but 10 fit steps: the exported file reads back the same
    through both packages' readers, with the JAX example's sizes (7,020
    visibilities x 2 channels, 27 antennas, |uv| 234-11,128 m); its
    weights are one sigma's; the fit off the file (torch's noise) follows
    the JAX package's fit of the same file to 1e-9, and its chi-squared
    per visibility sits near the noise floor of 2."""
    out = uvfits_interchange.main(device='cpu', out=str(tmp_path), steps=10)
    text = _printed(capsys, ('.4g', out['fitted']), ('.3f', out['chi2_first']),
                    ('.3f', out['chi2_last']), ('.0f', out['uv_min']),
                    ('.0f', out['uv_max']))
    assert f"{out['n_vis']} visibilities x {out['n_chan']} channels" in text
    assert (out['n_vis'], out['n_chan'], out['n_ant']) == (7020, 2, 27)
    assert round(out['uv_min']) == 234 and round(out['uv_max']) == 11128
    path = out['products']['uvfits_noisy']
    assert path.startswith(str(tmp_path))
    obs_j = juvfits.read_uvfits(path)
    for key in ('uvw', 'vis_re', 'vis_im', 'weights', 'freqs', 'ant1',
                'ant2'):
        np.testing.assert_array_equal(out['obs'][key], obs_j[key])
    assert np.ptp(obs_j['weights']) == 0
    jj = JaxJetModel(_jax_params((16, 40, 16)))
    jj.time = 0.0
    res_j = jfit.fit_uvfits(jj, path, free=('properties.mlr_bj',), steps=10,
                            learning_rate=0.05)
    _same_fit(out['fit'], res_j)
    assert 1.8 < out['chi2_last'] < 2.2
    assert out['truth'] == 1e-7


# --------------------------------------------------------------------------- #
# wide_field_vlbi
# --------------------------------------------------------------------------- #
def test_wide_field_vlbi(capsys):
    """As shipped but 10 fit steps: the w-term bound and plane counts, the
    sky, the exact, coplanar and w-stacked visibilities and their errors
    to 1e-9 (the w-stacked error below 1e-3 of the total flux, the
    coplanar one above), and the w-stacked error of the float32 sky the
    card samples; the fit's trajectory to 1e-9."""
    out = wide_field_vlbi.main(device='cpu', steps=10)
    _printed(capsys, ('.2f', out['bound']), ('d', out['n_wplanes']),
             ('.2e', out['coplanar_error']), ('.2e', out['wstack_error']),
             ('d', out['n_wplanes_demo']), ('.3e', out['mlr_bj']))
    assert out['wstack_error'] < 1e-3 < out['coplanar_error']

    p = _jax_params((24, 48, 24), c_size=2.0)
    p['target'] = dict(p['target'], dist=2.0)
    jj = JaxJetModel(p)
    jj.time = 0.0
    flux = np.asarray(jj.flux_ff(np.array([5e9])))[0]
    sky = jnp.asarray(np.nan_to_num(flux).T)
    assert _rel(out['sky'], sky) < CONT
    field = 0.5 * max(sky.shape) * out['cell_rad']
    assert out['bound'] == pytest.approx(
        jsamp.w_term_max_phase_error(out['uvw'], 5e9, field), rel=CONT)
    assert out['n_wplanes'] == jsamp.n_wplanes_for(out['uvw'], 5e9, field)
    assert out['n_wplanes_demo'] == jsamp.n_wplanes_for(out['uvw_demo'],
                                                        5e9, field)
    lam = 299792458.0 / 5e9
    u, v, w = (out['uvw_demo'][:, i] / lam for i in range(3))
    exact = np.asarray(jsamp.sample_vis_dft_w(sky, out['cell_rad'], u, v, w))
    cop = np.asarray(jsamp.sample_vis_dft(sky, out['cell_rad'], u, v))
    wst = np.asarray(jsamp.sample_vis_wstack(
        sky, out['cell_rad'], u, v, w, n_wplanes=out['n_wplanes_demo']))
    for key, want in (('vis_exact', exact), ('vis_coplanar', cop),
                      ('vis_wstack', wst)):
        assert _rel(out[key], want) < CONT, key
    tot = float(np.abs(np.asarray(sky)).sum())
    # a float32 sky, as on the card: the w-stacked screens keep their
    # float64 geometry (n - 1 vanishes in float32 at this field size)
    vis32 = tsamp.sample_vis_wstack(
        torch.as_tensor(out['sky']).float(), out['cell_rad'], u, v, w,
        n_wplanes=out['n_wplanes_demo'])
    assert vis32.dtype == torch.complex64
    err32 = np.max(np.abs(vis32.numpy() - exact)) / tot
    assert err32 == pytest.approx(out['wstack_error'], rel=1e-2)
    assert out['coplanar_error'] == pytest.approx(
        np.max(np.abs(cop - exact)) / tot, rel=CONT)
    assert out['wstack_error'] == pytest.approx(
        np.max(np.abs(wst - exact)) / tot, rel=1e-6)
    true = copy.deepcopy(p)
    true['properties'] = dict(p['properties'], mlr_bj=2e-7)
    jt = JaxJetModel(true)
    jt.time = 0.0
    freqs_fit = np.array([1e11, 3e11])
    fwd, th = jit_forwards(jfit.build_vis_forward)(
        jt, freqs_fit, out['uvw_demo'], ('properties.mlr_bj',),
        w_planes=out['n_wplanes_demo'])
    assert _rel(out['vis_obs'], np.asarray(fwd(th))) < CONT
    res_j = jfit.fit_visibilities(jj, freqs_fit, out['uvw_demo'],
                                  out['vis_obs'], free=('properties.mlr_bj',),
                                  steps=10, learning_rate=0.05,
                                  w_planes=out['n_wplanes_demo'])
    _same_fit(out['fit'], res_j)
