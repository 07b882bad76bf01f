"""Diagnostic plotting — matplotlib figures for models, RT products, mass
loss profiles, SEDs and synthetic observations (the JAX package's
rajepy_tpu.plotting.functions, copied: it holds no JAX; the figures read
host numpy arrays, and the model's LOS maps and profiles come from its
device reductions).

Covers the reference's plotting/functions.py surface (SURVEY §1 L6):
``equalise_axes`` (functions.py:20), ``make_colorbar`` (106),
``plot_mass_volume_slices`` (182), ``diagnostic_plot`` (368),
``model_plot`` (461), ``rt_plot`` (695), ``jml_profile_plot`` (864),
``geometry_plot`` (996), ``sed_plot`` (1123), ``timelapse_animation``
(1274).  Layouts are redesigned (the scientific content — which quantities
appear on which figure — matches the reference).
"""
from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple, Union

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib.colors import LogNorm, Normalize  # noqa: E402

from .. import _config as cfg  # noqa: E402
from .. import constants as cnsts  # noqa: E402


def _finish(fig, show_plot: bool, savefig: Union[bool, str]):
    if savefig:
        fig.savefig(savefig, bbox_inches='tight', dpi=150)
        if isinstance(savefig, str) and savefig.endswith('.png'):
            fig.savefig(savefig[:-4] + '.pdf', bbox_inches='tight')
    if show_plot:  # pragma: no cover — interactive only
        plt.show()
    plt.close(fig)


def equalise_axes(ax, fix_x: bool = False, fix_y: bool = False,
                  fix_z: bool = False):
    """Make axis ranges equal (functions.py:20-103).

    Full reference semantics: auto-detects 2-D vs 3-D axes and linear vs
    log scaling per axis; at most one of ``fix_x``/``fix_y``/``fix_z`` may
    be True, in which case that axis's span is imposed on the others
    (potentially clipping data).  Returns ``(xlims, ylims)`` for 2-D axes
    and ``(xlims, ylims, zlims)`` for 3-D ones.

    One reference defect is NOT replicated: its 3-D log detection tests
    the truthiness of ``get_zscale()`` (functions.py:40-44), which is the
    string ``'linear'`` for linear axes — so every 3-D z axis was treated
    as logarithmic.  We compare against ``'log'`` like the x/y branches.
    """
    if sum((fix_x, fix_y, fix_z)) not in (0, 1):
        raise ValueError("Only 1 of fix_x, fix_y or fix_z can be set to "
                         "True as a maximum")
    logx = ax.get_xscale() == 'log'
    logy = ax.get_yscale() == 'log'
    try:
        logz = ax.get_zscale() == 'log'
        ndims = 3
    except AttributeError:
        ndims = 2
        logz = False

    def _span(lims, log):
        lims = np.log10(lims) if log else np.asarray(lims, dtype=float)
        return float(np.ptp(lims))

    def _centred(lims, log, r):
        lims = np.log10(lims) if log else np.asarray(lims, dtype=float)
        mid = float(np.mean(lims))
        lo, hi = mid - r / 2.0, mid + r / 2.0
        return (10 ** lo, 10 ** hi) if log else (lo, hi)

    spans = [_span(ax.get_xlim(), logx), _span(ax.get_ylim(), logy)]
    if ndims == 3:
        spans.append(_span(ax.get_zlim(), logz))
    r = max(spans)
    if fix_x:
        r = spans[0]
    elif fix_y:
        r = spans[1]
    elif ndims == 3 and fix_z:
        r = spans[2]

    xlims = _centred(ax.get_xlim(), logx, r)
    ax.set_xlim(xlims)
    ylims = _centred(ax.get_ylim(), logy, r)
    ax.set_ylim(ylims)
    if ndims == 3:
        zlims = _centred(ax.get_zlim(), logz, r)
        ax.set_zlim(zlims)
        return xlims, ylims, zlims
    return xlims, ylims


def make_colorbar(cax, cmax, cmin=0, position='right',
                  orientation='vertical', numlevels=50, colmap='viridis',
                  norm=None, maxticks=None, minticks=False, tickformat=None,
                  hidespines=False):
    """Standalone colourbar drawn onto a provided axes
    (functions.py:106-179), honouring the full reference signature:
    ``position`` places the tick labels (left/right for vertical,
    top/bottom for horizontal), ``numlevels`` sets the contourf level
    count, ``maxticks``/``minticks`` accept a tick-value list or a
    matplotlib Locator (``maxticks=None`` means AutoLocator, the
    reference's default; ``minticks=True`` means AutoMinorLocator),
    ``tickformat`` is a FuncFormatter callable and ``hidespines`` removes
    the left/bottom/top spines.
    """
    from matplotlib.ticker import (AutoLocator, AutoMinorLocator,
                                   FuncFormatter, Locator)
    try:
        from matplotlib.colors import SymLogNorm
    except ImportError:  # pragma: no cover
        SymLogNorm = ()
    if isinstance(norm, SymLogNorm):
        raise NotImplementedError(
            "SymLogNorm colourbars are not supported (reference "
            "functions.py:118-119)")
    log = isinstance(norm, LogNorm)
    if log:
        levs = np.logspace(np.log10(cmin) if cmin > 0 else np.log10(cmax) - 3,
                           np.log10(cmax), numlevels + 1)
    else:
        if norm is None:
            norm = Normalize(vmin=cmin, vmax=cmax)
        levs = np.linspace(cmin, cmax, numlevels + 1)
    if np.ptp(levs) == 0:  # degenerate range guard (functions.py:135-141)
        levs = (np.logspace(np.log10(levs[0]) - 1, np.log10(levs[0]),
                            numlevels + 1) if log and levs[0] > 0
                else np.linspace(levs[0] - 0.5, levs[0] + 0.5,
                                 numlevels + 1))
    ramp = np.stack([levs, levs])
    across = np.stack([np.zeros_like(levs), np.ones_like(levs)])
    if orientation == 'vertical':
        cax.contourf(across, ramp, ramp, cmap=colmap, levels=levs, norm=norm)
        cax.yaxis.set_ticks_position(position)
        cax.xaxis.set_ticks([])
        axis = cax.yaxis
        if log:
            cax.set_yscale('log')
    elif orientation == 'horizontal':
        cax.contourf(ramp, across, ramp, cmap=colmap, levels=levs, norm=norm)
        cax.xaxis.set_ticks_position(position)
        cax.yaxis.set_ticks([])
        axis = cax.xaxis
        if log:
            cax.set_xscale('log')
    else:
        raise ValueError("Orientation must be 'vertical' or 'horizontal'")

    if not log:
        if isinstance(maxticks, list):
            axis.set_ticks(maxticks)
        elif isinstance(maxticks, Locator):
            axis.set_major_locator(maxticks)
        elif maxticks is None:
            axis.set_major_locator(AutoLocator())
        if isinstance(minticks, list):
            axis.set_ticks(minticks, minor=True)
        elif isinstance(minticks, Locator):
            axis.set_minor_locator(minticks)
        elif minticks:
            axis.set_minor_locator(AutoMinorLocator())
    if tickformat:
        axis.set_major_formatter(FuncFormatter(tickformat))
    if hidespines:
        for spine in ('left', 'bottom', 'top'):
            cax.spines[spine].set_visible(False)
    return axis


def _los_mean(arr, axis):
    with np.errstate(invalid='ignore'):
        return np.nanmean(arr, axis=axis)


def model_plot(jm, show_plot: bool = False,
               savefig: Union[bool, str] = False):
    """4 panels: number density, temperature, ionisation fraction, LOS
    velocity (functions.py:461-692)."""
    fig, axes = plt.subplots(
        2, 2, figsize=[cfg.plots['dims']['column'] * 2.2] * 2,
        sharex=True, sharey=True, constrained_layout=True)
    extent = (float(np.min(jm.xx)), float(np.max(jm.xx)) + jm.csize,
              float(np.min(jm.zz)), float(np.max(jm.zz)) + jm.csize)

    if hasattr(jm, 'diagnostic_maps'):
        # device-side LOS reductions: only (nx, nz) maps cross the host
        # boundary (full-cube pulls cost seconds through remote tunnels)
        m = jm.diagnostic_maps()
        maps = (m['n_e'], m['T'], m['x_i'], m['v_los'])
    else:
        maps = (_los_mean(jm.number_density, jm.los_axis),
                _los_mean(jm.temperature, jm.los_axis),
                _los_mean(jm.ion_fraction, jm.los_axis),
                _los_mean(jm.vel[1], jm.los_axis))
    # the reference displays the LOS velocity in the source frame
    # (v_lsr subtracted, functions.py:580-582), the ionisation fraction
    # in per cent on a fixed 0-100 scale (functions.py:566-576) and the
    # temperature on a fixed 100 K - max(1e4, T_max) log scale
    # (functions.py:654-660)
    v_los = maps[3] - jm.params['target']['v_lsr']
    v_lim = np.nanmax(np.abs(v_los[np.isfinite(v_los)])) \
        if np.isfinite(v_los).any() else 1.0
    t_max = max(1e4, float(np.nanmax(maps[1][np.isfinite(maps[1])]))
                if np.isfinite(maps[1]).any() else 1e4)
    panels = [
        (axes[0, 0], maps[0],
         r'$n_{\rm e}\,[{\rm cm^{-3}}]$', 'viridis_r', 'log', 'a'),
        (axes[0, 1], maps[1],
         r'$T\,[{\rm K}]$', 'plasma', LogNorm(vmin=100.0, vmax=t_max),
         'b'),
        (axes[1, 0], maps[2] * 100.0,
         r'$\chi_{\rm i}\,[\%]$', 'cividis',
         Normalize(vmin=0.0, vmax=100.0), 'c'),
        (axes[1, 1], v_los,
         r'$v_{\rm LOS}\,[{\rm km\,s^{-1}}]$', 'coolwarm',
         Normalize(vmin=-v_lim, vmax=v_lim), 'd'),
    ]
    for ax, img, label, cmap, norm, letter in panels:
        if norm == 'log':
            finite = img[np.isfinite(img)]
            if finite.size and np.nanmax(finite) > 0:
                norm = LogNorm(vmin=max(np.nanmin(finite[finite > 0]),
                                        1e-30),
                               vmax=np.nanmax(finite))
            else:
                norm = None
        im = ax.imshow(img.T, origin='lower', extent=extent, norm=norm,
                       cmap=cmap, aspect='equal')
        fig.colorbar(im, ax=ax, label=label, shrink=0.9)
        ax.text(0.9, 0.92, letter, ha='center', va='center',
                transform=ax.transAxes)
        ax.tick_params(which='both', direction='in', top=True,
                       right=True)
        ax.minorticks_on()

    # velocity-field quiver on the v_LOS panel: mid-LOS-plane (v_x, v_z),
    # subsampled.  The reference's own quiver overlay is commented out as
    # broken (functions.py:594-637, "TODO: This is broken"); this is the
    # working equivalent, with the reference's scale-arrow annotation.
    if hasattr(jm, 'velocity_midplane'):
        vx, vz = jm.velocity_midplane()
        step = max(1, max(vx.shape) // 12)
        xs_c = np.asarray(jm.xs) + jm.csize / 2.0
        zs_c = np.asarray(jm.zs) + jm.csize / 2.0
        xq, zq = np.meshgrid(xs_c[::step], zs_c[::step], indexing='ij')
        uq = vx[::step, ::step]
        wq = vz[::step, ::step]
        spd = np.sqrt(uq ** 2 + wq ** 2)
        if np.isfinite(spd).any() and np.nanmax(spd) > 0:
            v_scale = float(np.nanmax(spd))
            v_scale = (np.ceil(v_scale / 10 ** np.floor(np.log10(v_scale)))
                       * 10 ** np.floor(np.log10(v_scale)))
            ax = axes[1, 1]
            # max arrow length = 0.1 of the subplot height
            ax.quiver(xq, zq, uq, wq, color='k', scale=v_scale / 0.1,
                      scale_units='height', width=3e-3)
            ax.annotate(f'{v_scale:.3g} km/s', (0.05, 0.05),
                        xycoords='axes fraction', fontsize=6, va='bottom')

    fig.supxlabel(r'$\Delta x\,[{\rm au}]$')
    fig.supylabel(r'$\Delta z\,[{\rm au}]$')
    _finish(fig, show_plot, savefig)


def _load_run_map(path):
    """A 2-D map from a pipeline-product FITS file (central channel of a
    cube)."""
    from ..io import fits as fitsio
    data, hdr = fitsio.read_fits(path)
    while data.ndim > 2:
        data = data[data.shape[0] // 2]
    # FITS layout is [dec, ra]; the plotting body below expects [ra, dec]
    # (model-grid layout) and transposes before imshow
    return data.T, hdr


def rt_plot(jm, freq: float = None, percentile: float = 5.0,
            show_plot: bool = False, savefig: Union[bool, str] = False):
    """3 panels: flux, optical depth, emission measure at ``freq``
    (functions.py:695-861).

    Accepts either ``(JetModel, freq)`` — products computed on the fly —
    or a run object: ``rt_plot(run)`` loads the run's saved
    ``fits_flux``/``fits_tau``/``fits_em`` products, and
    ``rt_plot(jm, run)`` reads the frequency off the run.
    """
    if freq is not None and hasattr(freq, 'freq'):  # (jm, run)
        freq = freq.freq
    if freq is None and hasattr(jm, 'fits_flux'):   # a run object alone
        run = jm
        flux, hdr = _load_run_map(run.fits_flux)
        tau, _ = _load_run_map(run.fits_tau)
        em, _ = _load_run_map(run.fits_em)
        arcsec_pp = abs(float(hdr['CDELT2'])) * 3600.0
        half_x = flux.shape[0] / 2 * arcsec_pp
        half_z = flux.shape[1] / 2 * arcsec_pp
        extent = (-half_x, half_x, -half_z, half_z)
        return _rt_plot_body(flux, tau, em, extent, percentile, show_plot,
                             savefig)
    if freq is None:
        raise TypeError("rt_plot requires (JetModel, freq) or a run "
                        "object with saved RT products")
    flux = jm.flux_ff(freq)
    tau = jm.optical_depth_ff(freq)
    em = jm.emission_measure()

    arcsec_pp = np.degrees(np.arctan(
        jm.csize * cnsts.AU /
        (jm.params['target']['dist'] * cnsts.PARSEC))) * 3600.0
    half_x = jm.nx / 2 * arcsec_pp
    half_z = jm.nz / 2 * arcsec_pp
    extent = (-half_x, half_x, -half_z, half_z)
    return _rt_plot_body(flux, tau, em, extent, percentile, show_plot,
                         savefig)


def _rt_plot_body(flux, tau, em, extent, percentile, show_plot, savefig):

    fig, axes = plt.subplots(1, 3, figsize=(6.65, 6.65 / 2.4),
                             sharey=True, constrained_layout=True)
    xs = np.linspace(extent[0], extent[1], flux.shape[0])
    zs = np.linspace(extent[2], extent[3], flux.shape[1])
    tau_max = np.nanmax(np.where(np.isfinite(tau), tau, 0.0))
    # the reference displays flux in mJy/pixel (functions.py:763)
    flux = flux * 1e3
    for ax, img, label, cmap, letter in [
            (axes[0], flux, r'$S_\nu\,[{\rm mJy\,pixel^{-1}}]$',
             'inferno', 'a'),
            (axes[1], tau, r'$\tau_\nu$', 'magma', 'b'),
            (axes[2], em, r'${\rm EM}\,[{\rm pc\,cm^{-6}}]$', 'viridis',
             'c')]:
        pos = img[np.isfinite(img) & (img > 0)]
        if pos.size:
            vmin = np.percentile(pos, percentile)
            norm = LogNorm(vmin=vmin, vmax=pos.max())
        else:
            norm = None
        im = ax.imshow(img.T, origin='lower', extent=extent, norm=norm,
                       cmap=cmap, aspect='equal')
        fig.colorbar(im, ax=ax, label=label, location='top', shrink=0.95)
        # the tau = 1 surface (optically-thick core boundary) on every
        # panel — the reference's key rt_plot diagnostic overlay
        # (functions.py:733-738)
        if tau_max > 1.0:
            ax.contour(xs, zs, tau.T, [1.0], colors='w',
                       linewidths=0.8)
        ax.text(0.9, 0.92, letter, ha='center', va='center',
                transform=ax.transAxes, color='w')
        ax.tick_params(which='both', direction='in', top=True,
                       right=True)
        ax.minorticks_on()
    fig.supxlabel(r'$\Delta\alpha\,[^{\prime\prime}]$')
    fig.supylabel(r'$\Delta\delta\,[^{\prime\prime}]$')
    _finish(fig, show_plot, savefig)


def geometry_plot(jm, show_plot: bool = False,
                  savefig: Union[bool, str] = False):
    """Three fill-factor projections of the grid (sums along x, y, z —
    the reference's panels, functions.py:1019-1056) with axis-triad
    orientation markers, plus the analytic jet boundary overlaid on the
    plane-of-sky panel (beyond the reference)."""
    fig, axes = plt.subplots(
        1, 3, figsize=(cfg.plots['dims']['text'],
                       cfg.plots['dims']['text'] * 0.36),
        sharex=True, sharey=True, constrained_layout=True)

    if hasattr(jm, 'occupancy_projections'):
        proj = jm.occupancy_projections()
    else:
        ff = np.nan_to_num(jm.fill_factor, nan=0.0)
        proj = {'yz': ff.sum(axis=0), 'xz': ff.sum(axis=1),
                'xy': ff.sum(axis=2)}
    cs = jm.csize
    ext = {
        'yz': (float(np.min(jm.yy)), float(np.max(jm.yy)) + cs,
               float(np.min(jm.zz)), float(np.max(jm.zz)) + cs),
        'xz': (float(np.min(jm.xx)), float(np.max(jm.xx)) + cs,
               float(np.min(jm.zz)), float(np.max(jm.zz)) + cs),
        'xy': (float(np.min(jm.xx)), float(np.max(jm.xx)) + cs,
               float(np.min(jm.yy)), float(np.max(jm.yy)) + cs),
    }
    cmap = plt.get_cmap('inferno')
    lim = max(abs(v) for e in ext.values() for v in e)
    labels = {'yz': (r'$y$', r'$z$'), 'xz': (r'$x$', r'$z$'),
              'xy': (r'$x$', r'$y$')}
    for ax, (key, letter) in zip(axes, (('yz', 'a'), ('xz', 'b'),
                                        ('xy', 'c'))):
        ax.set_facecolor(cmap(0.0))
        ax.imshow(proj[key].T, origin='lower', extent=ext[key],
                  cmap=cmap, aspect='equal')
        # grid outline (the imaged region inside the square view)
        e = ext[key]
        ax.plot([e[0], e[1], e[1], e[0], e[0]],
                [e[2], e[2], e[3], e[3], e[2]], 'w:', lw=0.8)
        ax.plot(0, 0, marker='o', mfc='w', mec='none', ms=2)
        ax.text(0.95, 0.95, letter, transform=ax.transAxes, ha='right',
                va='top', color='w')
        hl, vl = labels[key]
        ax.annotate(hl, (0.05, 0.05), xycoords='axes fraction',
                    xytext=(0.16, 0.05), textcoords='axes fraction',
                    color='w', va='center',
                    arrowprops=dict(arrowstyle='<-', color='w', lw=1))
        ax.annotate(vl, (0.05, 0.05), xycoords='axes fraction',
                    xytext=(0.05, 0.17), textcoords='axes fraction',
                    color='w', ha='center',
                    arrowprops=dict(arrowstyle='<-', color='w', lw=1))
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.tick_params(which='both', direction='in', color='w',
                       top=True, right=True)
        ax.minorticks_on()

    # analytic projected jet boundary on the plane-of-sky (xz) panel:
    # the axis foreshortens by sin(inc); the half-width perpendicular to
    # the projected axis stays w(r) (circular cross-section)
    g = jm.params['geometry']
    pa = np.radians(g['pa'])
    si = np.sin(np.radians(g['inc']))
    # deprojected radii must reach lim / sin(inc) for the projected
    # boundary to span the silhouette of an inclined jet
    r_far = lim / max(si, 0.1)
    rs = np.linspace(g['r_0'], r_far, 200)
    w = g['w_0'] * ((rs + g['mod_r_0'] - g['r_0']) /
                    g['mod_r_0']) ** g['epsilon']
    for sgn_r in (+1, -1):
        for sgn_w in (+1, -1):
            x = sgn_w * w * np.cos(pa) + sgn_r * rs * si * np.sin(pa)
            z = -sgn_w * w * np.sin(pa) + sgn_r * rs * si * np.cos(pa)
            axes[1].plot(x, z, 'r-', lw=0.6)
    axes[1].set_xlim(-lim, lim)
    axes[1].set_ylim(-lim, lim)

    axes[0].set_ylabel(r'$[{\rm au}]$')
    axes[1].set_xlabel(r'$[{\rm au}]$')
    axes[1].set_title(f"{jm.name}: grid {jm.nx}x{jm.ny}x{jm.nz} @ "
                      f"{cs} au", fontsize='small')
    _finish(fig, show_plot, savefig)
    return fig, axes


def jml_profile_plot(inp, ax=None, show_plot: bool = False,
                     savefig: Union[bool, str] = False):
    """Jet mass-loss rate vs time, red/blue/total (functions.py:864-993)."""
    jm = inp.model if hasattr(inp, 'model') else inp
    t0s = [e['t_0'] for e in jm.ejections.values()]
    hls = [e['half_life'] for e in jm.ejections.values()]
    tmax = (max(t0s) + 4 * max(hls)) if t0s else cnsts.YEAR * 5
    times = np.linspace(0.0, max(tmax, cnsts.YEAR * 5), 2000)

    jml_r = np.asarray(jm.jml_t('R')(times))
    jml_b = np.asarray(jm.jml_t('B')(times))

    created_fig = ax is None
    if created_fig:
        fig, ax = plt.subplots(
            1, 1, figsize=(cfg.plots['dims']['text'],
                           cfg.plots['dims']['column']),
            constrained_layout=True)
    else:
        fig = ax.figure
    fac = cnsts.YEAR / 1.989e30  # kg/s -> Msol/yr
    ax.plot(times / cnsts.YEAR, jml_b * fac, 'b-', label='blue jet')
    ax.plot(times / cnsts.YEAR, jml_r * fac, 'r-', label='red jet')
    ax.plot(times / cnsts.YEAR, (jml_r + jml_b) * fac, 'k--', lw=0.8,
            label='total')
    ax.set_yscale('log')
    ax.set_xlabel(r'$t\,[{\rm yr}]$')
    ax.set_ylabel(r'$\dot{m}_{\rm jet}\,[{\rm M_\odot\,yr^{-1}}]$')
    ax.legend(fontsize='small')
    if created_fig:
        _finish(fig, show_plot, savefig)
    return fig, ax


def sed_plot(pline, plot_time: float, plot_reynolds: bool = True,
             savefig: Union[bool, str] = False):
    """Radio SED at one epoch: model fluxes, imfit fluxes, spectral
    indices and the Reynolds (1986) analytic expectation
    (functions.py:1123-1257)."""
    from ..ops import physics as mphys

    freqs, fluxes = [], []
    freqs_i, fluxes_i, efluxes_i = [], [], []
    for run in pline.runs:
        if run.year == plot_time and run.completed and \
                run.obs_type == 'continuum':
            if run.results.get('flux') is not None:
                freqs.append(run.freq)
                fluxes.append(float(np.nansum(run.results['flux'])))
            imfit = run.results.get('imfit')
            # CASA's integrated flux-density key is 'I' with its 'Ierr'
            # uncertainty (reference functions.py:1141-1145); 'Flux' is
            # the pre-r4 summary column kept for old products
            key = 'I' if imfit and 'I' in imfit else 'Flux'
            if imfit and key in imfit:
                freqs_i.append(run.freq)
                fluxes_i.append(imfit[key]['val'])
                ierr = imfit.get('Ierr')
                efluxes_i.append(ierr['val'] if ierr else 0.0)

    if not freqs:
        return None
    freqs = np.asarray(freqs)
    fluxes = np.asarray(fluxes)
    order = np.argsort(freqs)
    freqs, fluxes = freqs[order], fluxes[order]

    fig, ax = plt.subplots(
        1, 1, figsize=[cfg.plots['dims']['column'] * 1.6] * 2,
        constrained_layout=True)
    ax.plot(freqs / 1e9, fluxes, 'ko-', ms=4, label='sky model')
    if freqs_i:
        # imfit fluxes with their Gauss-Newton 1-sigma error bars
        # (reference functions.py:1218-1219)
        ax.errorbar(np.asarray(freqs_i) / 1e9, fluxes_i,
                    yerr=np.asarray(efluxes_i), fmt='gs', ms=4,
                    ecolor='g', capsize=2, label='imfit')

    if plot_reynolds:
        l_z_as = pline.model.nz * pline.model.csize / \
            pline.model.params['target']['dist']
        fr86 = np.logspace(np.log10(freqs.min()) - 0.5,
                           np.log10(freqs.max()) + 0.5, 100)
        rb = pline.model._ss_jml_rb_frac
        try:
            fexp = np.array(
                [float(mphys.flux_expected_r86(pline.model.params, f,
                                               l_z_as * 0.5, which='B')) +
                 float(mphys.flux_expected_r86(pline.model.params, f,
                                               l_z_as * 0.5, which='R',
                                               rb_frac=rb))
                 for f in fr86])
            ax.plot(fr86 / 1e9, fexp, 'b--', lw=0.8,
                    label='Reynolds (1986)')
        except Exception:
            pass

    # spectral indices between neighbouring frequencies
    if len(freqs) > 1 or len(freqs_i) > 1:
        ax2 = ax.twinx()
        if len(freqs) > 1:
            alphas = np.diff(np.log10(fluxes)) / np.diff(np.log10(freqs))
            fmid = 10 ** (0.5 * (np.log10(freqs[1:]) +
                                 np.log10(freqs[:-1])))
            ax2.plot(fmid / 1e9, alphas, 'o', mfc='cornflowerblue',
                     mec='b', ms=5)
        if len(freqs_i) > 1:
            # imfit spectral indices with error propagation through
            # alpha = ln(S2/S1)/ln(nu2/nu1) (reference
            # functions.py:1160-1169, 1191)
            fi = np.asarray(freqs_i, float)
            si = np.asarray(fluxes_i, float)
            ei = np.asarray(efluxes_i, float)
            oi = np.argsort(fi)
            fi, si, ei = fi[oi], si[oi], ei[oi]
            with np.errstate(divide='ignore', invalid='ignore'):
                alphas_i = np.diff(np.log10(si)) / np.diff(np.log10(fi))
                c = np.log(fi[1:] / fi[:-1])
                ealphas_i = np.sqrt((ei[1:] / (si[1:] * c)) ** 2 +
                                    (ei[:-1] / (si[:-1] * c)) ** 2)
            fmid_i = 10 ** (0.5 * (np.log10(fi[1:]) + np.log10(fi[:-1])))
            ax2.errorbar(fmid_i / 1e9, alphas_i, yerr=ealphas_i,
                         fmt='none', ecolor='b', capsize=2)
        ax2.set_ylabel(r'$\alpha$', color='b')

    ax.set_xscale('log')
    ax.set_yscale('log')
    ax.set_xlabel(r'$\nu\,[{\rm GHz}]$')
    ax.set_ylabel(r'$S_\nu\,[{\rm Jy}]$')
    ax.legend(fontsize='x-small')
    _finish(fig, False, savefig)


def diagnostic_plot(jm, show_plot: bool = False,
                    savefig: Union[bool, str] = False):
    """Conservation diagnostics plus grid-occupancy maps
    (functions.py:368-458).

    Left column: mass and angular momentum per signed-r slice along the
    jet — the reference's conservation check, which at head is dead code
    (it reads the commented-out ``JetModel.mass``, classes.py:787-835)
    and was in any case restricted to ``inc == 90, pa == 0``; here the
    profiles come from :meth:`JetModel.conservation_profiles` (on-device
    r-binned segment sums, any geometry).  Steady state should show the
    mass profile tracking the analytic expectation
    ``jml * csize / v(r)`` (overlaid when the velocity power laws make
    it exact), with ejection bursts standing out as moving excursions.

    Right column: LOS-summed fill factors and projected areas (grid
    occupancy, the reference's fill-factor wall-time log's subject).
    """
    prof = jm.conservation_profiles()
    fig, axes = plt.subplots(2, 2, figsize=(cfg.plots['dims']['text'],
                                            cfg.plots['dims']['text'] / 1.4),
                             constrained_layout=True)

    occupied = prof['mass'] > 0
    axes[0, 0].plot(prof['r'], prof['mass'], 'b-', ds='steps-mid',
                    label='gridded')
    # analytic steady-state expectation: the mass in a csize-thick slice
    # at |r| is (mass flux) x (crossing time) = jml * csize*au / v(r),
    # exact for q^d_v == 0 (single crossing speed per radius)
    pl = jm.params['power_laws']
    # overlay only when steady state is guaranteed (no ejection events:
    # testing chi over the grid would pull full cubes through a remote
    # tunnel just to label a dashed line)
    if pl['q^d_v'] == 0.0 and not getattr(jm, 'ejections', {}):
        import torch
        from ..ops import geometry as mgeom_ops
        rs = prof['r']
        gm_r0 = jm.params['geometry']['r_0']
        mr0 = jm.params['geometry']['mod_r_0']
        # ops.geometry works on tensors
        v = jm.params['properties']['v_0'] * mgeom_ops.rho(
            torch.as_tensor(np.abs(rs)), gm_r0, mr0).numpy() ** pl['q_v']
        expect = np.where(np.abs(rs) >= gm_r0,
                          np.where(rs < 0, jm.ss_jml('R'),
                                   jm.ss_jml('B')) *
                          jm.csize * cnsts.AU / (v * 1e3), np.nan)
        axes[0, 0].plot(rs, expect, 'k--', lw=0.8,
                        label=r'$\dot{m}\,\Delta r/v(r)$')
        axes[0, 0].legend(fontsize='x-small')
    axes[0, 0].set_ylabel(r'$m\,[{\rm kg}]$')
    axes[1, 0].plot(prof['r'], prof['angmom'], 'r-', ds='steps-mid')
    axes[1, 0].set_ylabel(r'$L\,[{\rm kg\,m^2\,s^{-1}}]$')
    axes[1, 0].set_xlabel(r'$r\,[{\rm au}]$')
    for ax in (axes[0, 0], axes[1, 0]):
        if occupied.any():
            ax.set_yscale('log')
        ax.tick_params(which='both', direction='in', top=True, right=True)
        ax.minorticks_on()

    ff = np.nan_to_num(jm.fill_factor, nan=0.0)
    areas = np.nan_to_num(jm.areas, nan=0.0)
    for row, (arr, name) in enumerate([(ff, 'fill factor'),
                                       (areas, 'projected area')]):
        img = arr.sum(axis=1)
        im = axes[row, 1].imshow(img.T, origin='lower', cmap='viridis')
        axes[row, 1].set_title(f"LOS-summed {name}", fontsize='small')
        fig.colorbar(im, ax=axes[row, 1], shrink=0.8)
    _finish(fig, show_plot, savefig)


def plot_mass_volume_slices(jm, show_plot: bool = False,
                            savefig: Union[bool, str] = False):
    """Mass and volume per z-slice vs |z| (functions.py:182-365)."""
    ff = np.nan_to_num(jm.fill_factor, nan=0.0)
    nd = np.nan_to_num(jm.number_density, nan=0.0)
    cell_vol_cm3 = (jm.csize * cnsts.AU * 1e2) ** 3
    m_cell = (nd * cell_vol_cm3 * jm.params['properties']['mu'] *
              cnsts.atomic_mass('H') * 1e3 * ff)  # g
    vols = ff.sum(axis=(0, 1)) * (jm.csize ** 3)
    masses = m_cell.sum(axis=(0, 1)) / 1.989e33  # Msol
    zs = jm.zs + jm.csize / 2.0

    fig, (ax1, ax2) = plt.subplots(2, 1, sharex=True,
                                   figsize=(cfg.plots['dims']['column'],
                                            cfg.plots['dims']['text']),
                                   constrained_layout=True)
    ax1.plot(zs, vols, 'b-')
    ax1.set_ylabel(r'$V_{\rm slice}\,[{\rm au^3}]$')
    ax2.plot(zs, masses, 'r-')
    ax2.set_ylabel(r'$M_{\rm slice}\,[{\rm M_\odot}]$')
    ax2.set_xlabel(r'$z\,[{\rm au}]$')
    for ax in (ax1, ax2):
        ax.set_yscale('log')
    _finish(fig, show_plot, savefig)


def _movie_writer(path):
    """(writer, output path) for :func:`timelapse_animation`, honouring
    the reference's mp4-first intent (functions.py:1274-1411 writes an
    .mp4): ffmpeg when available, else pillow with the extension
    switched to .gif so a requested-but-unwritable .mp4 degrades to an
    animated GIF rather than a frame directory."""
    import matplotlib.animation as manim
    base, ext = os.path.splitext(str(path))
    have_ffmpeg = manim.FFMpegWriter.isAvailable()
    if ext.lower() == '.mp4':
        return ('ffmpeg', str(path)) if have_ffmpeg else \
            ('pillow', base + '.gif')
    if ext.lower() == '.gif':
        return 'pillow', str(path)
    if have_ffmpeg:
        return 'ffmpeg', base + (ext or '') + '.mp4'
    return 'pillow', base + (ext or '') + '.gif'


def timelapse_animation(pline, tscop: Tuple[str, str] = None,
                        freq: float = None,
                        savefig: Union[bool, str] = False, fps: int = 5):
    """Animate the per-epoch synthetic (or model) images
    (functions.py:1274-1411).  Writes an .mp4 via matplotlib's ffmpeg
    writer when available (the reference's output format), degrading to
    an animated GIF (pillow) and finally to a directory of per-epoch PNG
    frames when no movie writer works."""
    from ..io.fits import read_fits
    import matplotlib.animation as manim

    frames = []
    for run in pline.runs:
        if freq is not None and run.freq != freq:
            continue
        if tscop is not None and tuple(run.tscop or ()) != tuple(tscop):
            continue
        img_file = run.products.get('clean_image')
        if img_file is None or not os.path.exists(img_file):
            if os.path.exists(run.fits_flux):
                img_file = run.fits_flux
            else:
                continue
        data, hdr = read_fits(img_file)
        while data.ndim > 2:
            data = data[0]
        frames.append((run.year, data))

    if not frames:
        return None
    frames.sort(key=lambda f: f[0])
    vmax = max(np.nanmax(d) for _, d in frames)

    fig, ax = plt.subplots(figsize=[cfg.plots['dims']['column'] * 2] * 2)
    im = ax.imshow(frames[0][1], origin='lower', cmap='inferno',
                   vmin=0, vmax=vmax)
    title = ax.set_title('')

    def update(i):
        im.set_data(frames[i][1])
        title.set_text(f"t = {frames[i][0]:.2f} yr")
        return [im, title]

    anim = manim.FuncAnimation(fig, update, frames=len(frames))
    if savefig:
        if savefig is True:   # bare flag: a sensible default, not
            savefig = 'timelapse'   # a file literally named 'True'
        writer, out_path = _movie_writer(savefig)
        try:
            anim.save(out_path, fps=fps, writer=writer)
        except Exception:
            stem = os.path.splitext(str(savefig))[0]
            os.makedirs(stem, exist_ok=True)
            for i, (yr, d) in enumerate(frames):
                update(i)
                fig.savefig(os.path.join(stem, f'frame{i:04d}.png'),
                            dpi=120)
    plt.close(fig)
    return anim


def radio_plot(model, run, percentile: float = 5.0,
               savefig: Union[bool, str] = False):
    """Flux / optical depth / emission measure from a run's FITS products
    (reference Pipeline.radio_plot, classes.py:3015-3183)."""
    from ..io.fits import read_fits

    imgs = []
    for path in (run.fits_flux, run.fits_tau, run.fits_em):
        data, _ = read_fits(path)
        while data.ndim > 2:
            # all-empty pixel columns are legitimately NaN here (outside
            # the jet) — suppress numpy's empty-slice warning
            with warnings.catch_warnings():
                warnings.simplefilter('ignore', RuntimeWarning)
                data = np.nanmean(np.where(data > 0, data, np.nan),
                                  axis=0)
        imgs.append(np.where(data > 0, data, np.nan))

    csize_as = np.degrees(np.arctan(
        model.csize * cnsts.AU /
        (model.params['target']['dist'] * cnsts.PARSEC))) * 3600.0
    half_x = imgs[0].shape[1] * csize_as / 2.0
    half_z = imgs[0].shape[0] * csize_as / 2.0
    extent = (-half_x, half_x, -half_z, half_z)

    fig, axes = plt.subplots(1, 3, figsize=(cfg.plots['dims']['text'],
                                            cfg.plots['dims']['column']),
                             sharey=True, constrained_layout=True)
    labels = [r'$S_\nu\,[{\rm Jy\,pixel^{-1}}]$', r'$\tau_\nu$',
              r'${\rm EM}\,[{\rm pc\,cm^{-6}}]$']
    for ax, img, label in zip(axes, imgs, labels):
        pos = img[np.isfinite(img)]
        norm = None
        if pos.size:
            vmin = max(np.nanpercentile(pos, percentile), 1e-30)
            norm = LogNorm(vmin=vmin, vmax=np.nanmax(pos))
        im = ax.imshow(img, origin='lower', extent=extent, norm=norm,
                       cmap='inferno', aspect='equal')
        fig.colorbar(im, ax=ax, label=label, location='top', shrink=0.95)
    fig.supxlabel(r'$\Delta\alpha\,[^{\prime\prime}]$')
    fig.supylabel(r'$\Delta\delta\,[^{\prime\prime}]$')
    _finish(fig, False, savefig)


def load_fits_hdr_and_data(fits_file: str):
    """(header, data) of a FITS file (functions.py:1260-1271)."""
    from ..io.fits import read_fits
    data, hdr = read_fits(fits_file)
    return hdr, data


def uv_plot(vis, max_points: int = 100_000, show_plot: bool = False,
            savefig: Union[bool, str] = False):
    """uv-coverage + visibility-amplitude diagnostics for a visibility
    set — the role CASA's ``plotms`` fills after simobserve (the
    reference, driving CASA, has no in-package equivalent).

    ``vis`` is a ``SynObs.<cfg>[.noisy|.selfcal].vis.npz`` product path
    (keys ``uvw`` [m], ``vis_re``/``vis_im`` (n_chan, n_vis), ``freqs``
    [Hz]) or an equivalent mapping.  Left panel: conjugate-symmetrised
    uv coverage in kilolambda; right: amplitude vs uv distance with a
    binned median profile.  Points beyond ``max_points`` are decimated
    with a deterministic stride.
    """
    if isinstance(vis, (str, os.PathLike)):
        vis = np.load(vis)
    uvw = np.asarray(vis['uvw'], dtype=float)
    freqs = np.atleast_1d(np.asarray(vis['freqs'], dtype=float))
    re = np.atleast_2d(np.asarray(vis['vis_re'], dtype=float))
    im = np.atleast_2d(np.asarray(vis['vis_im'], dtype=float))
    lam = cnsts.C / freqs
    u_kl = (uvw[None, :, 0] / lam[:, None]).ravel() / 1e3
    v_kl = (uvw[None, :, 1] / lam[:, None]).ravel() / 1e3
    amp = np.hypot(re, im).ravel()
    uvdist = np.hypot(u_kl, v_kl)
    step = max(1, -(-u_kl.size // max_points))   # ceil: honour the cap
    u_kl, v_kl, amp, uvdist = (a[::step] for a in (u_kl, v_kl, amp,
                                                   uvdist))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9.6, 4.4))
    ax1.scatter(np.concatenate([u_kl, -u_kl]),
                np.concatenate([v_kl, -v_kl]), s=0.5, lw=0,
                color='cornflowerblue', rasterized=True)
    ax1.set_xlabel(r'$u$ [k$\lambda$]')
    ax1.set_ylabel(r'$v$ [k$\lambda$]')
    ax1.set_aspect('equal', 'datalim')
    ax1.set_title('uv coverage')

    ax2.scatter(uvdist, amp, s=1.0, lw=0, color='0.55', alpha=0.4,
                rasterized=True)
    if uvdist.size:
        edges = np.linspace(0.0, uvdist.max() * 1.0001, 25)
        which = np.digitize(uvdist, edges) - 1
        mids, meds = [], []
        for b in range(len(edges) - 1):
            sel = amp[which == b]
            if sel.size:
                mids.append(0.5 * (edges[b] + edges[b + 1]))
                meds.append(np.median(sel))
        ax2.plot(mids, meds, color='maroon', lw=1.5,
                 label='binned median')
        ax2.legend(frameon=False)
    ax2.set_xlabel(r'uv distance [k$\lambda$]')
    ax2.set_ylabel('amplitude [Jy]')
    ax2.set_title('visibility amplitude')
    fig.tight_layout()
    _finish(fig, show_plot, savefig)
    return fig


def gain_plot(g_re, g_im, t_sol=None, show_plot: bool = False,
              savefig: Union[bool, str] = False):
    """Per-antenna gain-solution tracks (CASA ``plotcal``'s role):
    amplitude and unwrapped phase vs solution interval for (n_sol,
    n_ant) gain solutions, such as the JAX package's StEFCal solver
    ``synthobs.calibration.solve_gains`` gives (a (n_chan, n_sol, n_ant)
    bandpass solution plots amplitude/phase vs channel instead, one line
    per antenna, using the first solution interval)."""
    g = np.asarray(g_re) + 1j * np.asarray(g_im)
    if g.ndim == 3:                       # bandpass: (n_chan, n_sol, n_ant)
        if t_sol is not None:
            raise ValueError("t_sol does not apply to bandpass-shaped "
                             "(n_chan, n_sol, n_ant) solutions — the "
                             "x axis is the channel")
        g = g[:, 0, :]
        xlab = 'channel'
    else:
        xlab = 'solution interval'
    x = np.arange(g.shape[0]) if t_sol is None else np.asarray(t_sol)
    fig, (ax1, ax2) = plt.subplots(2, 1, sharex=True, figsize=(7.2, 5.4))
    for a in range(g.shape[1]):
        ax1.plot(x, np.abs(g[:, a]), lw=0.8, alpha=0.8)
        ax2.plot(x, np.degrees(np.unwrap(np.angle(g[:, a]))), lw=0.8,
                 alpha=0.8)
    ax1.set_ylabel('|g|')
    ax2.set_ylabel('gain phase [deg]')
    ax2.set_xlabel(xlab if t_sol is None else 'time [s]')
    ax1.set_title(f'{g.shape[1]} antenna gain solutions')
    fig.tight_layout()
    _finish(fig, show_plot, savefig)
    return fig
