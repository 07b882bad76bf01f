"""The port's JetModel field views and diagnostic reductions, the analytic
formulas of ``ops/physics`` and the leftovers of ``ops/gaunt``,
``utils/profiling``, ``models/grid`` and ``ops/hyp2f1``, against the JAX
package's, on the CPU.

The models are the conftest disc-wind jet (inc 60, pa 30, every power law
set) with its two bursts and without them, on the conftest 32 x 80 x 32
grid, in both packages from the same params:

* float64: every field view (``indices``, ``grid``, ``xs``/``ys``/``zs``,
  ``grid_rwp``, ``rreff``, ``ts``, ``chi_xyz``, ``number_density``,
  ``mass_density``, ``ion_fraction``, ``temperature``, ``pressure``,
  ``vel``) and every reduction (``diagnostic_maps``,
  ``occupancy_projections``, ``conservation_profiles``,
  ``velocity_midplane``, ``_rt_inputs``) to 1e-9 of the JAX value's
  largest magnitude, with NaN in the same cells;
* float32 (both packages fill their own float32 grids): 1e-5;
* the azimuth ``pp`` is held only farther than 3 degrees from +-90 deg:
  there asin(y/rho) turns the last bit of its argument into ~1e-8 rad at
  float64 and ~1e-4 rad at float32, in either package;
* a burst-free model fills its fields without travel times; its ``ts``
  is evaluated on demand and equals the model's with bursts;
* the analytic formulas to 1e-9, the gaunt uncertainty lookup, the grid's
  cell centres and the Pfaff product exactly or to 1e-12.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu import JetModel as JaxJetModel
from rajepy_tpu.models import grid as jgrid
from rajepy_tpu.ops import gaunt as jgaunt
from rajepy_tpu.ops import hyp2f1 as jhyp
from rajepy_tpu.ops import physics as jphys
from rajepy_tpu.utils import profiling as jprof
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.models import grid as tgrid
from rajepy_tpu_torch.ops import gaunt as tgaunt
from rajepy_tpu_torch.ops import hyp2f1 as thyp
from rajepy_tpu_torch.ops import physics as tphys
from rajepy_tpu_torch.utils import profiling as tprof
from tests.torch_one_thread import one_thread  # noqa: F401

YEAR = 31536000.0
RTOL = {'float64': 1e-9, 'float32': 1e-5}
DTYPES = {'float64': (jnp.float64, torch.float64),
          'float32': (jnp.float32, torch.float32)}
FIELDS = ('indices', 'grid', 'xs', 'ys', 'zs', 'grid_rwp', 'rreff', 'ts',
          'chi_xyz', 'number_density', 'mass_density', 'ion_fraction',
          'temperature', 'pressure', 'vel')
REDUCTIONS = ('diagnostic_maps', 'occupancy_projections',
              'conservation_profiles', 'velocity_midplane', '_rt_inputs')
NO_BURSTS = {'t_0': np.array([]), 'hl': np.array([]), 'chi': np.array([]),
             'which': np.array([])}
_PAIRS = {}


def _pair(params, dtype, bursts):
    """(JAX model, port model) at 1.1 yr, kept for the module."""
    key = (dtype, bursts)
    if key not in _PAIRS:
        p = copy.deepcopy(params)
        if not bursts:
            p['ejection'] = copy.deepcopy(NO_BURSTS)
        jdt, tdt = DTYPES[dtype]
        jm_j = JaxJetModel(copy.deepcopy(p), dtype=jdt)
        jm_t = JetModel(copy.deepcopy(p), dtype=tdt, device='cpu')
        jm_j.time = jm_t.time = 1.1 * YEAR
        _PAIRS[key] = jm_j, jm_t
    return _PAIRS[key]


def _leaves(x):
    """The arrays of a view: an array, or a tuple or dict of arrays."""
    if isinstance(x, dict):
        return [np.asarray(x[k]) for k in sorted(x)]
    if isinstance(x, tuple):
        return [np.asarray(a) for a in x]
    return [np.asarray(x)]


def _rel(got, want, mask=None):
    """max |got - want| / max |want| over finite cells (the same cells NaN
    in both), optionally only where ``mask``."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = np.abs(want).max()
    diff = np.abs(got - want).max() if want.size else 0.0
    return diff / scale if scale > 0 else diff


@pytest.mark.parametrize("bursts", [True, False],
                         ids=['bursts', 'burst-free'])
@pytest.mark.parametrize("dtype", ['float64', 'float32'])
def test_field_views_match_jax(disc_wind_params, dtype, bursts):
    jm_j, jm_t = _pair(disc_wind_params, dtype, bursts)
    for name in FIELDS:
        got, want = _leaves(getattr(jm_t, name)), \
            _leaves(getattr(jm_j, name))
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            mask = None
            if name == 'grid_rwp' and i == 2:
                mask = np.broadcast_to(np.abs(np.cos(w)) > np.sin(
                    np.radians(3.0)), w.shape)
            err = _rel(g, w, mask)
            assert err < RTOL[dtype], f"{name}[{i}]: rel err {err:.2e}"


@pytest.mark.parametrize("bursts", [True, False],
                         ids=['bursts', 'burst-free'])
@pytest.mark.parametrize("dtype", ['float64', 'float32'])
def test_device_reductions_match_jax(disc_wind_params, dtype, bursts):
    jm_j, jm_t = _pair(disc_wind_params, dtype, bursts)
    for name in REDUCTIONS:
        got, want = getattr(jm_t, name)(), getattr(jm_j, name)()
        if name == '_rt_inputs':
            got, want = got[1:], tuple(np.asarray(a) for a in want[1:])
        got, want = _leaves(got), _leaves(want)
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.abs(np.nan_to_num(w)).max() > 0, (name, i)
            err = _rel(g, w)
            assert err < RTOL[dtype], f"{name}[{i}]: rel err {err:.2e}"
    prof = jm_t.conservation_profiles()
    assert set(prof) == {'r', 'mass', 'angmom'}
    assert np.all(prof['angmom'][prof['mass'] > 0] > 0)


def test_ts_of_a_burst_free_model(disc_wind_params):
    """The burst-free model's fields hold no travel times; its ``ts`` view
    evaluates them and equals the burst model's (the same geometry)."""
    jm_j, jm_t = _pair(disc_wind_params, 'float64', False)
    _, jm_b = _pair(disc_wind_params, 'float64', True)
    f = jm_t._ensure_fields()
    assert not jm_t._has_bursts and not torch.any(f.ts)
    ts = jm_t.ts
    assert ts.shape == (jm_t.nx, jm_t.ny, jm_t.nz)
    np.testing.assert_array_equal(ts, jm_b.ts)
    assert _rel(ts, jm_j.ts) < 1e-9
    assert np.ptp(ts) > 0
    # no cell bursts, and the fields are left as they were
    np.testing.assert_array_equal(jm_t.chi_xyz, 1.0)
    assert not torch.any(jm_t._ensure_fields().ts)


# --------------------------------------------------------------------------- #
# ops/physics: the analytic formulas
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("which", ["model_params", "disc_wind_params"])
def test_analytic_physics_matches_jax(request, which):
    params = JetModel(copy.deepcopy(request.getfixturevalue(which)),
                      device='cpu').params
    g, p, pl = params['geometry'], params['properties'], params['power_laws']
    freqs = np.geomspace(1e8, 1e12, 9)
    rb = p['mlr_rj'] / p['mlr_bj']
    pairs = []
    for dist in (None, 120.0):
        args = (g['r_0'], g['w_0'], p['n_0'], p['x_0'], p['T_0'], freqs,
                g['inc'], g['epsilon'], pl['q_n'], pl['q_x'], pl['q_T'],
                g['opang'])
        pairs.append((tphys.r_tau1(*args, dist=dist),
                      jphys.r_tau1(*args, dist=dist)))
    for side in ('B', 'R'):
        pairs.append((tphys.approx_flux_expected_r86(params, freqs, side, rb),
                      jphys.approx_flux_expected_r86(params, freqs, side,
                                                     rb)))
        for y_min in (None, 0.02):
            pairs.append((
                [tphys.flux_expected_r86(params, f, 0.4, y_min, side, rb)
                 for f in freqs],
                [jphys.flux_expected_r86(params, f, 0.4, y_min, side, rb)
                 for f in freqs]))
    # random (z, x, y) points, and points on or near the jet axis of both
    # sides (the integrand is monopolar: zero on the red side)
    rng = np.random.default_rng(3)
    i_rad = np.radians(g['inc'] - 90.0)
    axis = [(r * np.cos(i_rad), x, r * np.sin(i_rad))
            for r in (-5.0, 2.5, 5.0, 10.0) for x in (0.0, 0.2)]
    pts = np.vstack([rng.uniform(-8.0, 8.0, (40, 3)), axis]) * 1.496e13
    func_t = tphys.flux_int_wrapped(6e9, params)
    func_j = jphys.flux_int_wrapped(6e9, params)
    pairs.append(([func_t(*pt) for pt in pts], [func_j(*pt) for pt in pts]))
    mlr_args = (p['n_0'], p['v_0'], g['w_0'], p['mu'], pl['q^d_n'],
                pl['q^d_v'], params['target']['R_1'],
                params['target']['R_2'])
    pairs.append((tphys.mlr_from_n_0(*mlr_args),
                  jphys.mlr_from_n_0(*mlr_args)))
    assert tphys.mlr_from_n_0(*mlr_args) == pytest.approx(p['mlr_bj'],
                                                          rel=1e-9)
    radii = np.geomspace(5.0, 500.0, 7)
    for fn in ('u0_ss73', 'temp_ss73', 'z0_ss73', 'n_ss73', 'tau_ss73',
               'vr_ss73', 'h_ss73'):
        pairs.append((getattr(tphys, fn)(0.1, 1e-6, 0.55, radii),
                      getattr(jphys, fn)(0.1, 1e-6, 0.55, radii)))
    for s in (-2.0, -1.3, 0.0, 0.5, 2.5):
        pairs.append((tphys._gamma_upper(s, freqs / 1e10),
                      jphys._gamma_upper(s, freqs / 1e10)))
    for got, want in pairs:
        got = np.asarray(got, dtype=float)
        want = np.asarray(want, dtype=float)
        assert np.all(np.isfinite(want)) and np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    with pytest.raises(ValueError, match='zone'):
        tphys.u0_ss73(0.1, 1e-6, 0.55, radii, zone='a')


# --------------------------------------------------------------------------- #
# leftovers: gaunt uncertainties, profiling, grid centres, Pfaff product
# --------------------------------------------------------------------------- #
def test_gaunt_uncertainties_match_jax():
    np.testing.assert_array_equal(tgaunt.load_vanhoof_uncertainties(),
                                  jgaunt.load_vanhoof_uncertainties())
    rng = np.random.default_rng(4)
    freqs = 10 ** rng.uniform(7.0, 13.0, 200)
    temps = 10 ** rng.uniform(2.0, 5.0, 200)
    got = tgaunt.gff_uncertainty(torch.as_tensor(freqs), torch.as_tensor(
        temps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jgaunt.gff_uncertainty(freqs, temps)))
    v_t, s_t = tgaunt.gff_with_uncertainty(torch.tensor([6e9, 2.2e10],
                                                        dtype=torch.float64),
                                           1e4)
    v_j, s_j = jgaunt.gff_with_uncertainty(np.array([6e9, 2.2e10]), 1e4)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-12)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert v_t.dtype == s_t.dtype == torch.float64
    assert np.all((s_t.numpy() > 0) & (s_t.numpy() < 1e-2 * v_t.numpy()))


def test_stage_split_trace_and_timed_call(tmp_path):
    """The stage registry as the JAX package's; spans and KernelTimer
    stages in ``trace``'s Chrome trace; a span with no profiler is one
    shared no-op; the counters add up."""
    for prof in (tprof, jprof):
        prof.collect_stage_times(True)
        try:
            prof.record_stage('a write', 1.0)
            prof.record_stage('plots', 2.0)
            prof.record_stage('a write', 0.5)
        finally:
            prof.collect_stage_times(False)
    assert tprof.stage_times() == jprof.stage_times() == {'a write': 1.5,
                                                          'plots': 2.0}
    assert tprof.span('rajepy.a') is tprof.span('rajepy.b')

    logdir = str(tmp_path / 'trace')
    x = torch.arange(1000, dtype=torch.float64)
    with tprof.trace(logdir):
        with tprof.KernelTimer('squares') as kt:
            with tprof.span('rajepy.sum'):
                y = torch.cumsum(x * x, 0)
            kt.set_result(y)
    with open(os.path.join(logdir, 'trace.json')) as f:
        events = json.load(f)['traceEvents']
    names = [e.get('name', '') for e in events]
    assert any('cumsum' in n for n in names)
    (outer,), (inner,) = ([e for e in events if e.get('name') == n]
                          for n in ('rajepy.squares', 'rajepy.sum'))
    assert outer['ts'] <= inner['ts'] and (inner['ts'] + inner['dur'] <=
                                           outer['ts'] + outer['dur'])
    assert kt.elapsed > 0.0

    before = tprof.COUNTERS.get('test.items', 0)
    tprof.count('test.items')
    tprof.count('test.items', 4)
    assert tprof.COUNTERS['test.items'] == before + 5


def test_grid_centres_and_pfaff_product_match_jax():
    for got, want in zip(tgrid.grid_centre_coords(6, 10, 4, 0.5),
                         jgrid.grid_centre_coords(6, 10, 4, 0.5)):
        assert got.shape == want.shape and got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(1)
    z = -np.abs(rng.lognormal(0, 3, 300))
    for a, b in ((0.5, 9 / 7), (-1.3, 2.4), (1.5, 3.7)):
        got = thyp.hyp2f1_pfaff_product(a, b, torch.as_tensor(z)).numpy()
        want = np.asarray(jhyp.hyp2f1_pfaff_product(a, b, jnp.asarray(z)))
        np.testing.assert_allclose(got, want, rtol=1e-12)
