"""2-D elliptical-Gaussian source fitting — the CASA ``imfit`` replacement.

The reference shells out to CASA's imfit task with an estimates file
(classes.py:2790-2808) and parses the text summary back
(classes.py:2817-2840), keeping CASA's flux-density uncertainty for the
SED error bars (plotting/functions.py:1143: ``results['imfit']['Ierr']``).
Here the fit is a direct Gauss-Newton least squares (scipy) on the
restored image, parameter uncertainties come from the Gauss-Newton
covariance at the optimum (inflated for beam-correlated noise), and the
summary file uses the same '# units / # headers / values' layout so
``rajepy_tpu_torch.utils.misc.casa_imfit_file_to_dict`` (and the
reference's own parser) read it unchanged — including CASA's
``I``/``Ierr`` integrated flux-density keys the reference SED plot
consumes.

A copy of rajepy_tpu.synthobs.imfit, which holds no JAX.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.optimize import least_squares


def _gauss2d(params, xx, yy):
    peak, x0, y0, smaj, smin, th = params
    ct, st = np.cos(th), np.sin(th)
    xr = (xx - x0) * ct + (yy - y0) * st
    yr = -(xx - x0) * st + (yy - y0) * ct
    return peak * np.exp(-0.5 * ((xr / smaj) ** 2 + (yr / smin) ** 2))


def _gauss2d_terms(params, xx, yy):
    """Model plane plus the intermediates its Jacobian shares."""
    peak, x0, y0, smaj, smin, th = params
    ct, st = np.cos(th), np.sin(th)
    xr = (xx - x0) * ct + (yy - y0) * st
    yr = -(xx - x0) * st + (yy - y0) * ct
    u, v = xr / smaj, yr / smin
    env = np.exp(-0.5 * (u * u + v * v))
    return peak * env, env, xr, yr, u, v, ct, st


def _gauss2d_jac(params, terms):
    """Analytic (n_pix, 6) Jacobian of the raveled model plane.

    scipy's default is forward finite differences — 6 extra full-image
    model evaluations per step; sharing one exponential across all six
    closed-form columns makes the whole imfit ~3x faster at identical
    optima (and the Gauss-Newton covariance uses the exact J)."""
    peak, x0, y0, smaj, smin, th = params
    g, env, xr, yr, u, v, ct, st = terms
    J = np.empty((g.size, 6))
    J[:, 0] = env.ravel()
    # d xr/d x0 = -ct, d yr/d x0 = st; chain through u, v
    J[:, 1] = (g * (u * ct / smaj - v * st / smin)).ravel()
    J[:, 2] = (g * (u * st / smaj + v * ct / smin)).ravel()
    J[:, 3] = (g * u * u / smaj).ravel()
    J[:, 4] = (g * v * v / smin).ravel()
    # d xr/d th = yr, d yr/d th = -xr
    J[:, 5] = (g * (v * xr / smin - u * yr / smaj)).ravel()
    return J


def _covariance(sol, beam_area_pix: Optional[float]):
    """Gauss-Newton parameter covariance at the optimum.

    cov = s^2 (J^T J)^-1 with s^2 = RSS / (n_eff - p).  Restored-image
    noise is correlated over the synthesised beam, so the pixels are not
    independent samples: with ``beam_area_pix`` (pixels per beam) given,
    the covariance is inflated by that factor — the number of independent
    noise samples is ~n_pix / beam_area (the Condon 1997 correlated-noise
    correction at the leading order CASA's imfit errors follow).
    Returns None when the problem is degenerate (singular J^T J or no
    residual degrees of freedom).
    """
    J = sol.jac
    n, p = J.shape
    if n <= p:
        return None
    rss = float(np.dot(sol.fun, sol.fun))
    jtj = J.T @ J
    try:
        cov = np.linalg.inv(jtj)
    except np.linalg.LinAlgError:
        return None
    if not np.isfinite(cov).all():
        return None
    s2 = rss / (n - p)      # per-pixel residual variance estimate
    infl = 1.0
    if beam_area_pix is not None and beam_area_pix > 1.0:
        infl = float(beam_area_pix)
    return cov * s2 * infl


def fit_gaussian(image: np.ndarray,
                 estimates: Optional[Dict[str, float]] = None,
                 beam_area_pix: Optional[float] = None
                 ) -> Optional[Dict[str, float]]:
    """Fit one elliptical Gaussian to ``image`` (2-D, Jy/beam).

    ``estimates``: optional dict with peak, x, y, maj_pix, min_pix, pa_deg
    (the role of the reference's imfit estimates file,
    classes.py:2793-2804).  ``beam_area_pix``: pixels per synthesised
    beam, used to inflate the parameter covariance for beam-correlated
    noise (see :func:`_covariance`).  Returns fitted parameters in pixel
    units with 1-sigma uncertainties (``*_err`` keys; 0 when the
    covariance is degenerate, e.g. a noise-free exact fit), or None if
    the fit fails (the reference logs imfit failures and stores None,
    classes.py:2833-2840).
    """
    image = np.asarray(image, dtype=float)
    ny, nx = image.shape
    yy, xx = np.mgrid[0:ny, 0:nx]

    if not np.isfinite(image).any():
        # a fully-blanked plane is a failed fit, not a crash
        # (nanmax/nanargmax raise on all-NaN slices)
        return None

    if estimates is None:
        peak0 = float(np.nanmax(image))
        iy, ix = np.unravel_index(np.nanargmax(image), image.shape)
        estimates = {'peak': peak0, 'x': float(ix), 'y': float(iy),
                     'maj_pix': max(nx / 20.0, 2.0),
                     'min_pix': max(nx / 30.0, 2.0), 'pa_deg': 0.0}

    fwhm = 2.0 * np.sqrt(2.0 * np.log(2.0))
    # pa_deg is CASA-convention (east of north); _gauss2d's theta is the
    # image-frame angle from +x on the x=West/y=North basis: theta =
    # PA + 90 (seeding with raw PA put the major axis ~90 deg off)
    p0 = np.array([estimates['peak'], estimates['x'], estimates['y'],
                   max(estimates['maj_pix'] / fwhm, 0.5),
                   max(estimates['min_pix'] / fwhm, 0.5),
                   np.radians(estimates['pa_deg'] + 90.0)])

    img = np.nan_to_num(image, nan=0.0)

    # LM evaluates fun and jac at the same point back to back: a
    # one-slot cache shares the exponential between them
    cache = {'key': None, 'terms': None}

    def _terms(p):
        key = p.tobytes()
        if cache['key'] != key:
            cache['key'] = key
            cache['terms'] = _gauss2d_terms(p, xx, yy)
        return cache['terms']

    def resid(p):
        return (_terms(p)[0] - img).ravel()

    def jac(p):
        return _gauss2d_jac(p, _terms(p))

    try:
        sol = least_squares(resid, p0, jac=jac, method='lm',
                            max_nfev=2000)
    except Exception:
        return None
    if not np.isfinite(sol.x).all() or sol.x[0] <= 0:
        return None

    cov = _covariance(sol, beam_area_pix)
    if cov is None:
        errs = np.zeros(6)
        cov = np.zeros((6, 6))
    else:
        errs = np.sqrt(np.maximum(np.diag(cov), 0.0))

    peak, x0, y0, smaj, smin, th = sol.x
    peak_e, x_e, y_e, smaj_e, smin_e, th_e = errs
    smaj, smin = abs(smaj), abs(smin)
    if smin > smaj:
        smaj, smin = smin, smaj
        smaj_e, smin_e = smin_e, smaj_e
        th += np.pi / 2
    total_flux = 2.0 * np.pi * peak * smaj * smin
    # delta-method flux variance: F = 2 pi * peak * |s3| * |s4|, with
    # the peak/width covariances included (they anti-correlate strongly,
    # so diagonal-only propagation overestimates Ierr ~2x).  The
    # gradient is built in the SIGNED basis of sol.x/cov — the fit may
    # converge to negative widths (abs-folded above), and abs-valued
    # gradient components would flip the sign of the cross terms
    g = np.zeros(6)
    s3, s4 = sol.x[3], sol.x[4]
    g[0] = 2.0 * np.pi * abs(s3 * s4)
    g[3] = 2.0 * np.pi * peak * np.sign(s3) * abs(s4)
    g[4] = 2.0 * np.pi * peak * np.sign(s4) * abs(s3)
    flux_var = float(g @ cov @ g)
    flux_err = np.sqrt(max(flux_var, 0.0))
    return {'peak': float(peak), 'x': float(x0), 'y': float(y0),
            'maj_pix': float(smaj * fwhm), 'min_pix': float(smin * fwhm),
            # back to CASA convention: PA = theta - 90, east of north
            'pa_deg': float((np.degrees(th) - 90.0) % 180.0),
            'flux_pixsum': float(total_flux),
            'peak_err': float(peak_e), 'x_err': float(x_e),
            'y_err': float(y_e), 'maj_pix_err': float(smaj_e * fwhm),
            'min_pix_err': float(smin_e * fwhm),
            'pa_deg_err': float(np.degrees(th_e)),
            'flux_pixsum_err': float(flux_err)}


def write_imfit_summary(filename: str, fit: Dict[str, float],
                        cell_arcsec: float, beam_area_pix: float):
    """Write a CASA-imfit-style summary (units line, header line, values) —
    parseable by utils.misc.casa_imfit_file_to_dict and by the reference's
    own parser (classes.py:2821-2832).  Carries CASA's integrated
    flux-density columns ``I``/``Ierr`` (what the reference SED plot reads,
    plotting/functions.py:1141-1145) alongside the legacy ``Flux`` column
    and per-parameter uncertainty columns from the Gauss-Newton
    covariance (zeros when :func:`fit_gaussian` ran without them)."""
    flux_jy = fit['flux_pixsum'] / max(beam_area_pix, 1e-30)
    flux_jy_err = fit.get('flux_pixsum_err', 0.0) / max(beam_area_pix,
                                                        1e-30)
    # CASA's summary format: the units line has one fewer token than the
    # header line (the leading count column is unitless) — both the
    # reference's parser (classes.py:2821-2832) and
    # utils.misc.casa_imfit_file_to_dict compensate with a leading ''.
    units = ['Jy/beam', 'Jy/beam', 'Jy', 'Jy', 'Jy', 'pix', 'pix', 'pix',
             'pix', 'arcsec', 'arcsec', 'arcsec', 'arcsec', 'deg', 'deg']
    headers = ['N', 'Peak', 'Peakerr', 'Flux', 'I', 'Ierr', 'X', 'Xerr',
               'Y', 'Yerr', 'Maj', 'Majerr', 'Min', 'Minerr', 'PA',
               'PAerr']
    values = [0, fit['peak'], fit.get('peak_err', 0.0), flux_jy, flux_jy,
              flux_jy_err, fit['x'], fit.get('x_err', 0.0), fit['y'],
              fit.get('y_err', 0.0),
              fit['maj_pix'] * cell_arcsec,
              fit.get('maj_pix_err', 0.0) * cell_arcsec,
              fit['min_pix'] * cell_arcsec,
              fit.get('min_pix_err', 0.0) * cell_arcsec,
              fit['pa_deg'], fit.get('pa_deg_err', 0.0)]
    with open(filename, 'wt') as f:
        f.write('# ' + '  '.join(units) + '\n')
        f.write('# ' + '  '.join(headers) + '\n')
        f.write('  '.join(f'{v:.8g}' for v in values) + '\n')
