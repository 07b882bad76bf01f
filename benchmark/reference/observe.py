"""The plain reference of the continuum observation chain: the uv plan of
a run, its visibilities by a direct Fourier transform of a sky map, Briggs
weights, gridding and the FFT to the dirty image and PSF, Hogbom's CLEAN,
restoration with the fitted beam and an elliptical-Gaussian fit, written
from the published description as plain PyTorch: the stage of the
upstream RaJePy that drives CASA (classes.py:2490-2851 of
https://github.com/SimonP2207/RaJePy: simobserve, tclean with its defaults
niter 500, nsigma 3, Briggs robust 0.5, imfit), tclean's Briggs formula
(Briggs 1995), Hogbom (1974) and a Levenberg-Marquardt least-squares fit.

Every function computes in the ``dtype`` it is given (float64 and
complex128 for the reference, float32 and complex64 for the control), on
the device of its inputs or the one it is given.  Python floats are
constants.  Nothing here imports the program.

Departures from CASA, each the program's own model of the same step:

* the uv plan is RaJePy's: the elevation window above ``min_el``, full
  days of that window plus the remainder, each scan centred on transit
  (an east-west array's split of its last day is not written here);
  each scan's integrations are decimated to at most ``max_time_samples``
  evenly spaced samples, and the noise is scaled to the true number of
  integrations;
* thermal noise is the radiometer equation, sigma = SEFD / (eta
  sqrt(2 dnu t)) per part of each visibility, in place of simobserve's
  tsys-atm model;
* the primary beam is a Gaussian of FWHM 1.2 lambda / D at each channel,
  D the mean dish, in place of CASA's voltage patterns;
* visibilities are the exact direct transform V = sum I e^{-2 pi i (u l +
  v m)} over the pixels of the sky map (coplanar: the w term is below 0.1
  rad at the field's edge for the cells here, and a plan that needs it
  raises), l and m measured along increasing pixel index from the map's
  centre (n - 1) / 2, as the image's centre pixel n // 2 is measured by
  the imager, which undoes the same convention;
* the image is RaJePy's: a cell of a quarter of 1 / (longest baseline in
  wavelengths) at the centre frequency, at least 500 pixels and twice the
  model's extent, and a CLEAN mask of the model's extent plus 2 pixels;
* Briggs densities are the weights summed on the image's uv cells
  (nearest cell, each visibility and its conjugate point), gridding is a
  Gaussian kernel of sigma 0.65 cells over 5 x 5 cells (each visibility
  and its conjugate point) divided out of the image by its transform, in
  place of tclean's prolate spheroidal gridder;
* the restoring beam is the second moments of the PSF above half its
  peak within n / 8 pixels of the centre, with the truncation's bias
  undone, in place of tclean's least-squares fit of the main lobe;
* the source fit is one elliptical Gaussian over the whole image from the
  estimates given, as imfit with an estimates file.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.constants as sc
import torch

ARCSEC = sc.arcsec
C = sc.c
ANTENNAS = {('VLA', 'A'): os.path.join(os.path.dirname(
    os.path.abspath(__file__)), 'vla.a.cfg')}
#: (longitude east, latitude) [deg] of the array's reference position
#: (CASA's Observatories table, the row of the VLA)
SITES = {'VLA': (-107.618333675045662, 33.9004860013725704)}
SIDEREAL = 1.0027379093        # hour angle turned per hour of clock
GRID_SIGMA = 0.65              # gridding kernel [uv cells]
SUPPORT = 2                    # its half-width [uv cells]
FWHM = 2.0 * math.sqrt(2.0 * math.log(2.0))


@contextlib.contextmanager
def exact_matmul():
    """Matrix products in the precision of their operands (no TF32 on the
    card) within the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def read_antennas(tscop: Tuple[str, str]) -> Tuple[np.ndarray, np.ndarray]:
    """ECEF positions [m] (n_ant, 3) and dish diameters [m] of an array's
    CASA antenna file (coordsys XYZ)."""
    xyz, diam = [], []
    with open(ANTENNAS[tuple(tscop)]) as f:
        for line in f:
            parts = line.split()
            if parts and not parts[0].startswith('#'):
                xyz.append([float(v) for v in parts[:3]])
                diam.append(float(parts[3]))
    return np.asarray(xyz), np.asarray(diam)


def read_fits(path: str) -> Tuple[np.ndarray, Dict]:
    """The primary image of a FITS file as float64 (last axis NAXIS1), and
    its header cards as a dict."""
    with open(path, 'rb') as f:
        raw = f.read()
    hdr, pos = {}, 0
    while True:
        card = raw[pos:pos + 80].decode('ascii')
        pos += 80
        key = card[:8].strip()
        if key == 'END':
            break
        if card[8:10] == '= ':
            val = card[10:].split('/')[0].strip() if "'" not in card[10:] \
                else card[10:].split("'")[1].rstrip()
            try:
                val = float(val)
            except ValueError:
                pass
            hdr[key] = val
    pos = -(-pos // 2880) * 2880
    shape = tuple(int(hdr[f'NAXIS{i}'])
                  for i in range(int(hdr['NAXIS']), 0, -1))
    dt = {-32: '>f4', -64: '>f8'}[int(hdr['BITPIX'])]
    n = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dt, count=n, offset=pos)
    return data.reshape(shape).astype(np.float64), hdr


def declination(text: str) -> float:
    """'+DD:MM:SS.S' to degrees."""
    sign = -1.0 if text.strip().startswith('-') else 1.0
    d, m, s = (float(v) for v in text.strip().lstrip('+-').split(':'))
    return sign * (d + m / 60.0 + s / 3600.0)


def plan(setup: Dict, dtype=torch.float64, device='cpu') -> Dict:
    """The run's uv plan, image geometry and noise (RaJePy
    classes.py:2510-2759).  ``setup``: ``dec`` (sexagesimal),
    ``tscop`` (telescope, configuration), ``t_obs``, ``t_int`` [s],
    ``min_el`` [deg], ``freq`` (centre), ``chan_freqs``, ``chanwidth``
    [Hz], ``max_time_samples``, ``sefd`` [Jy], ``eta``, ``sky_shape`` (ny,
    nx) and ``sky_cell_rad``.  Returns ``uvw`` (n_vis, 3) [m], in the
    order scan, time, baseline (antenna pairs i < j in order), ``sigma``
    [Jy], ``imsize``, ``cell_rad``, ``mask`` (imsize, imsize) and
    ``dish`` [m]."""
    dec = declination(setup['dec'])
    lon, lat = SITES[setup['tscop'][0]]
    xyz, diam = read_antennas(setup['tscop'])
    d_r, l_r = math.radians(dec), math.radians(lat)
    # the window above min_el: all day if the lower transit clears it
    lowest = math.degrees(math.asin(math.sin(l_r) * math.sin(d_r) -
                                    math.cos(l_r) * math.cos(d_r)))
    if lowest > setup['min_el']:
        time_up = 86400
    else:
        cos_h = ((math.sin(math.radians(setup['min_el'])) -
                  math.sin(l_r) * math.sin(d_r)) /
                 (math.cos(l_r) * math.cos(d_r)))
        time_up = int(7200.0 * math.degrees(math.acos(cos_h)) / 15.0)
    t_obs, t_int = float(setup['t_obs']), float(setup['t_int'])
    scans = [float(time_up)] * int(t_obs // time_up)
    if t_obs - (t_obs // time_up) * time_up > 0:
        scans.append(t_obs - (t_obs // time_up) * time_up)
    # baselines, antenna pairs (i, j), i < j, in order
    i, j = np.triu_indices(len(xyz), k=1)
    bl = torch.as_tensor(xyz[j] - xyz[i], dtype=dtype, device=device)
    tracks, n_true = [], 0
    for dur in scans:
        n = max(1, int(round(dur / t_int)))
        n_true += n
        n = min(n, setup['max_time_samples'])
        ha = (np.arange(n) - (n - 1) / 2.0) * (dur / n) / 3600.0 * SIDEREAL
        h = torch.as_tensor(np.radians(ha * 15.0 - lon), dtype=dtype,
                            device=device)[:, None]
        sh, ch = torch.sin(h), torch.cos(h)
        sd, cd = math.sin(d_r), math.cos(d_r)
        lx, ly, lz = bl[None, :, 0], bl[None, :, 1], bl[None, :, 2]
        # Thompson, Moran & Swenson eq. 4.1 at the Greenwich hour angle
        tracks.append(torch.stack(
            [sh * lx + ch * ly, -sd * ch * lx + sd * sh * ly + cd * lz,
             cd * ch * lx - cd * sh * ly + sd * lz], -1).reshape(-1, 3))
    uvw = torch.cat(tracks)
    n_samp = uvw.shape[0] // bl.shape[0]
    t_eff = t_int * max(n_true / n_samp, 1.0)
    sigma = setup['sefd'] / (setup['eta'] *
                             math.sqrt(2.0 * setup['chanwidth'] * t_eff))
    # the image: a quarter of the longest baseline's fringe, >= 500 pixels
    longest = float(np.max(np.linalg.norm(xyz[:, None] - xyz[None],
                                          axis=-1)))
    cell_as = 1.0 / (longest * setup['freq'] / C) / ARCSEC / 4.0
    ny, nx = setup['sky_shape']
    cell_m = setup['sky_cell_rad']
    imsize = max(500, math.ceil(max(nx, ny) * cell_m / ARCSEC * 2.0
                                / cell_as))
    imsize += imsize % 2
    w_max = float(torch.max(torch.abs(uvw[:, 2]))) * \
        max(setup['chan_freqs']) / C
    if 2.0 * math.pi * w_max * (1.0 - math.cos(0.5 * max(nx, ny) *
                                                cell_m)) > 0.1:
        raise NotImplementedError("the field needs the w term")
    c0 = imsize // 2
    hx = math.ceil(nx * cell_m / ARCSEC / cell_as / 2.0) + 2
    hy = math.ceil(ny * cell_m / ARCSEC / cell_as / 2.0) + 2
    mask = torch.zeros(imsize, imsize, dtype=dtype, device=device)
    mask[max(c0 - hy, 0):c0 + hy, max(c0 - hx, 0):c0 + hx] = 1.0
    return {'uvw': uvw, 'sigma': sigma, 'imsize': imsize,
            'cell_rad': cell_as * ARCSEC, 'mask': mask,
            'dish': float(np.mean(diam))}


def visibilities(sky: torch.Tensor, cell_rad: float, uvw: torch.Tensor,
                 freqs, dish: float, chunk_bytes: int = 1 << 28
                 ) -> torch.Tensor:
    """(n_chan, n_vis) visibilities [Jy] of ``sky`` (n_chan, ny, nx)
    [Jy/pixel] through the Gaussian primary beam, by the direct transform
    over the map's non-zero pixels, in ``sky``'s dtype (complex)."""
    dt = sky.dtype
    n_chan, ny, nx = sky.shape
    y = (torch.arange(ny, dtype=dt, device=sky.device) - (ny - 1) / 2.0)
    x = (torch.arange(nx, dtype=dt, device=sky.device) - (nx - 1) / 2.0)
    m_all = (y[:, None] * cell_rad).expand(ny, nx)
    l_all = (x[None, :] * cell_rad).expand(ny, nx)
    out = []
    for c in range(n_chan):
        lam = C / float(freqs[c])
        keep = sky[c] != 0
        l, m = l_all[keep], m_all[keep]
        fwhm = 1.2 * lam / dish
        flux = sky[c][keep] * torch.exp(-4.0 * math.log(2.0) *
                                        (l * l + m * m) / fwhm ** 2)
        u, v = uvw[:, 0] / lam, uvw[:, 1] / lam
        step = max(1, chunk_bytes // (8 * max(1, flux.numel())))
        re, im = [], []
        for lo in range(0, u.shape[0], step):
            ph = (-2.0 * math.pi) * (u[lo:lo + step, None] * l[None] +
                                     v[lo:lo + step, None] * m[None])
            re.append(torch.cos(ph) @ flux)
            im.append(torch.sin(ph) @ flux)
        out.append(torch.complex(torch.cat(re), torch.cat(im)))
    return torch.stack(out)


def add_noise(vis: torch.Tensor, sigma: float, seed: int) -> torch.Tensor:
    """``vis`` plus Gaussian noise of ``sigma`` on each part."""
    gen = torch.Generator(device=vis.device)
    gen.manual_seed(int(seed))
    rdt = vis.real.dtype
    re = torch.randn(vis.shape, generator=gen, dtype=rdt, device=vis.device)
    im = torch.randn(vis.shape, generator=gen, dtype=rdt, device=vis.device)
    return vis + torch.complex(sigma * re, sigma * im)


def _uv(p: Dict, freqs, dtype):
    """Every visibility's (u, v) [wavelengths], channel by channel."""
    uvw = p['uvw'].to(dtype)
    lam = torch.as_tensor(C / np.asarray(freqs, np.float64), dtype=dtype,
                          device=uvw.device)
    return ((uvw[None, :, 0] / lam[:, None]).reshape(-1),
            (uvw[None, :, 1] / lam[:, None]).reshape(-1))


def _mirror(grid: torch.Tensor, rows, cols, vals, sign: float = 1.0):
    """Add ``vals`` at (rows, cols), and ``sign`` times them at the
    conjugate points (n - row, n - col) that lie on the grid."""
    n = grid.shape[0]
    grid.index_put_((rows, cols), vals, accumulate=True)
    on = (rows > 0) & (cols > 0)
    grid.index_put_((n - rows[on], n - cols[on]), sign * vals[on],
                    accumulate=True)


def briggs(u, v, n: int, cell_rad: float, robust: float) -> torch.Tensor:
    """Briggs weights of unit-weight visibilities: 1 / (1 + W_k f^2), W_k
    the summed weight of the visibility's uv cell (its conjugate points
    included), f^2 = (5 10^-robust)^2 / (sum_k W_k / n_vis)."""
    du = 1.0 / (n * cell_rad)
    gu = torch.round(u / du).long() + n // 2
    gv = torch.round(v / du).long() + n // 2
    ok = (gu >= 0) & (gu < n) & (gv >= 0) & (gv < n)
    dens = torch.zeros(n, n, dtype=u.dtype, device=u.device)
    _mirror(dens, gv[ok], gu[ok], torch.ones_like(u[ok]))
    w_k = dens[gv.clamp(0, n - 1), gu.clamp(0, n - 1)]
    f2 = (5.0 * 10.0 ** -robust) ** 2 / (w_k.sum() / u.numel())
    return 1.0 / (1.0 + w_k * f2)


def image(p: Dict, vis: torch.Tensor, freqs, robust: float
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dirty image [Jy/beam], PSF) of the visibilities (n_chan, n_vis) of
    plan ``p``, every channel on one grid (multi-frequency synthesis), in
    ``vis``'s real dtype."""
    dt = vis.real.dtype
    n, cell = p['imsize'], p['cell_rad']
    u, v = _uv(p, freqs, dt)
    w = briggs(u, v, n, cell, robust)
    du = 1.0 / (n * cell)
    fu, fv = u / du + n // 2, v / du + n // 2
    iu, iv = torch.round(fu).long(), torch.round(fv).long()
    ok = ((iu >= SUPPORT) & (iu < n - SUPPORT) &
          (iv >= SUPPORT) & (iv < n - SUPPORT))
    fu, fv, iu, iv, w = fu[ok], fv[ok], iu[ok], iv[ok], w[ok]
    vals = vis.reshape(-1)[ok]
    # the weights, and the real and imaginary parts (conjugated at the
    # conjugate points)
    wgt, re, im = torch.zeros(3, n, n, dtype=dt, device=vis.device)
    for a in range(-SUPPORT, SUPPORT + 1):
        for b in range(-SUPPORT, SUPPORT + 1):
            k = w * torch.exp(-((iu + a - fu) ** 2 + (iv + b - fv) ** 2)
                              / (2.0 * GRID_SIGMA ** 2))
            _mirror(wgt, iv + b, iu + a, k)
            _mirror(re, iv + b, iu + a, k * vals.real)
            _mirror(im, iv + b, iu + a, k * vals.imag, -1.0)
    grid = torch.complex(re, im)

    def to_sky(g):
        return torch.fft.fftshift(torch.fft.ifft2(
            torch.fft.ifftshift(g))).real

    q = torch.arange(n, dtype=dt, device=vis.device) - n // 2
    corr = torch.exp(-2.0 * math.pi ** 2 * GRID_SIGMA ** 2 * (q / n) ** 2)
    scale = n * n / wgt.sum() / torch.outer(corr, corr)
    return to_sky(grid) * scale, to_sky(wgt.to(vis.dtype)) * scale


def threshold(dirty: torch.Tensor, mask: torch.Tensor, nsigma: float
              ) -> float:
    """``nsigma`` times the standard deviation of the dirty image outside
    the mask."""
    out = dirty[mask == 0]
    return nsigma * float(torch.sqrt(((out - out.mean()) ** 2).mean()))


def hogbom(dirty: torch.Tensor, psf: torch.Tensor, mask: torch.Tensor,
           thresh: float, gain: float = 0.1, niter: int = 500):
    """Hogbom (1974): while fewer than ``niter`` components and the
    largest |residual| inside the mask exceeds ``thresh``, take ``gain``
    of it into the model at its pixel and subtract the PSF, centred there,
    times that much from the residual.  Returns (model, residual,
    iterations)."""
    n = dirty.shape[0]
    c = n // 2
    model, res = torch.zeros_like(dirty), dirty.clone()
    for it in range(niter):
        k = int(torch.argmax(torch.abs(res * mask)))
        py, px = divmod(k, n)
        if float(torch.abs(res[py, px] * mask[py, px])) <= thresh:
            return model, res, it
        comp = gain * res[py, px]
        model[py, px] += comp
        y0, y1 = max(0, py - c), min(n, py - c + n)
        x0, x1 = max(0, px - c), min(n, px - c + n)
        res[y0:y1, x0:x1] -= comp * psf[y0 - py + c:y1 - py + c,
                                        x0 - px + c:x1 - px + c]
    return model, res, niter


def fit_beam(psf: torch.Tensor, cell_rad: float) -> Tuple[float, float,
                                                          float]:
    """(bmaj, bmin [rad], bpa [deg east of north]): the FWHM of the
    Gaussian whose second moments the PSF's core has (pixels above half
    the peak within n / 8 of the centre; the moments of a Gaussian cut at
    half maximum are sigma^2 (1 - ln 2) and are scaled back).  The image's
    x axis points west, so an angle theta from +x is a PA of theta - 90."""
    n = psf.shape[0]
    yy, xx = torch.meshgrid(*(torch.arange(n, dtype=psf.dtype,
                                           device=psf.device),) * 2,
                            indexing='ij')
    core = torch.where((psf > 0.5 * psf.max()) &
                       ((yy - n // 2) ** 2 + (xx - n // 2) ** 2 <
                        (n // 8) ** 2), psf, torch.zeros_like(psf))
    s = core.sum()
    cx, cy = (core * xx).sum() / s, (core * yy).sum() / s
    mxx = (core * (xx - cx) ** 2).sum() / s
    myy = (core * (yy - cy) ** 2).sum() / s
    mxy = (core * (xx - cx) * (yy - cy)).sum() / s
    half = torch.sqrt((mxx - myy) ** 2 + 4.0 * mxy ** 2) / 2.0
    lam1, lam2 = (mxx + myy) / 2.0 + half, (mxx + myy) / 2.0 - half
    scale = FWHM * cell_rad / math.sqrt(1.0 - math.log(2.0))
    theta = 0.5 * math.degrees(float(torch.atan2(2.0 * mxy, mxx - myy)))
    return (float(torch.sqrt(lam1.clamp_min(1e-12))) * scale,
            float(torch.sqrt(lam2.clamp_min(1e-12))) * scale,
            theta % 180.0 - 90.0)


def restore(model: torch.Tensor, residual: torch.Tensor, beam,
            cell_rad: float) -> torch.Tensor:
    """The residual plus every CLEAN component times the unit-peak
    elliptical Gaussian ``beam`` (bmaj, bmin [rad], bpa [deg]) centred on
    its pixel."""
    n = model.shape[0]
    bmaj, bmin, bpa = beam
    th = math.radians(bpa + 90.0)
    ar = torch.arange(n, dtype=model.dtype, device=model.device)
    out = residual.clone()
    for py, px in torch.nonzero(model).tolist():
        x = (ar[None, :] - px) * cell_rad
        y = (ar[:, None] - py) * cell_rad
        xr = x * math.cos(th) + y * math.sin(th)
        yr = -x * math.sin(th) + y * math.cos(th)
        out += model[py, px] * torch.exp(
            -4.0 * math.log(2.0) * ((xr / bmaj) ** 2 + (yr / bmin) ** 2))
    return out


def _gauss(p: torch.Tensor, xx, yy):
    """The model plane and its Jacobian (n_pix, 6) at parameters
    (peak, x0, y0, sigma_maj, sigma_min, theta)."""
    peak, x0, y0, sa, sb, th = p
    ct, st = torch.cos(th), torch.sin(th)
    xr = (xx - x0) * ct + (yy - y0) * st
    yr = -(xx - x0) * st + (yy - y0) * ct
    a, b = xr / sa, yr / sb
    env = torch.exp(-0.5 * (a * a + b * b))
    g = peak * env
    jac = torch.stack([env, g * (a * ct / sa - b * st / sb),
                       g * (a * st / sa + b * ct / sb), g * a * a / sa,
                       g * b * b / sb, g * (b * xr / sb - a * yr / sa)], -1)
    return g.reshape(-1), jac.reshape(-1, 6)


def fit_gaussian(img: torch.Tensor, est: Dict[str, float],
                 max_iter: int = 200) -> Optional[Dict[str, float]]:
    """Least-squares fit of one elliptical Gaussian to ``img`` by
    Levenberg-Marquardt from ``est`` (peak, x, y, maj_pix, min_pix [FWHM,
    pixels], pa_deg [east of north]), in ``img``'s dtype: peak, x, y,
    maj_pix, min_pix, pa_deg and flux_pixsum (2 pi peak sigma_maj
    sigma_min), or None if it does not converge to a positive peak."""
    dt, dev = img.dtype, img.device
    ny, nx = img.shape
    yy, xx = torch.meshgrid(torch.arange(ny, dtype=dt, device=dev),
                            torch.arange(nx, dtype=dt, device=dev),
                            indexing='ij')
    data = torch.nan_to_num(img).reshape(-1)
    p = torch.tensor([est['peak'], est['x'], est['y'],
                      max(est['maj_pix'] / FWHM, 0.5),
                      max(est['min_pix'] / FWHM, 0.5),
                      math.radians(est['pa_deg'] + 90.0)], dtype=dt,
                     device=dev)
    g, jac = _gauss(p, xx, yy)
    r = g - data
    cost, damp = float(r @ r), 1e-3
    for _ in range(max_iter):
        jtj, jtr = jac.T @ jac, jac.T @ r
        step = torch.linalg.solve(jtj + damp * torch.diag(torch.diag(jtj)),
                                  -jtr)
        g_new, jac_new = _gauss(p + step, xx, yy)
        r_new = g_new - data
        cost_new = float(r_new @ r_new)
        if cost_new < cost:
            small = float(torch.max(torch.abs(step) /
                                    (torch.abs(p) + 1e-12)))
            p, r, jac, damp = p + step, r_new, jac_new, damp / 10.0
            done = cost - cost_new <= 1e-15 * cost or small < 1e-12
            cost = cost_new
            if done:
                break
        else:
            damp *= 10.0
            if damp > 1e16:
                break
    peak, x0, y0, sa, sb, th = (float(v) for v in p)
    if not all(map(math.isfinite, (peak, x0, y0, sa, sb, th))) or peak <= 0:
        return None
    sa, sb = abs(sa), abs(sb)
    if sb > sa:
        sa, sb, th = sb, sa, th + math.pi / 2.0
    return {'peak': peak, 'x': x0, 'y': y0, 'maj_pix': sa * FWHM,
            'min_pix': sb * FWHM,
            'pa_deg': (math.degrees(th) - 90.0) % 180.0,
            'flux_pixsum': 2.0 * math.pi * peak * sa * sb}


def estimates(img: torch.Tensor) -> Dict[str, float]:
    """Fit estimates from an image's moments: its peak, and the centre and
    FWHM axes of the pixels above half of it."""
    n = img.shape[0]
    yy, xx = torch.meshgrid(*(torch.arange(n, dtype=img.dtype,
                                           device=img.device),) * 2,
                            indexing='ij')
    core = torch.where(img > 0.5 * img.max(), img, torch.zeros_like(img))
    s = core.sum()
    cx, cy = (core * xx).sum() / s, (core * yy).sum() / s
    sxx = float((core * (xx - cx) ** 2).sum() / s)
    syy = float((core * (yy - cy) ** 2).sum() / s)
    scale = FWHM / math.sqrt(1.0 - math.log(2.0))
    return {'peak': float(img.max()), 'x': float(cx), 'y': float(cy),
            'maj_pix': math.sqrt(max(sxx, syy, 0.25)) * scale,
            'min_pix': math.sqrt(max(min(sxx, syy), 0.25)) * scale,
            'pa_deg': 0.0}


def observe(sky: torch.Tensor, sky_cell_rad: float, p: Dict, freqs,
            seed: int, niter: int, nsigma: float, gain: float,
            robust: float) -> Dict:
    """The whole chain of plan ``p`` from ``sky`` (n_chan, ny, nx), in
    ``sky``'s dtype: the products a run of the program leaves, with the
    fit's estimates from the restored image's moments."""
    clean = visibilities(sky, sky_cell_rad, p['uvw'].to(sky.dtype), freqs,
                         p['dish'])
    noisy = add_noise(clean, p['sigma'], seed)
    dirty, psf = image(p, noisy, freqs, robust)
    mask = p['mask'].to(sky.dtype)
    model, res, its = hogbom(dirty, psf, mask,
                             threshold(dirty, mask, nsigma), gain, niter)
    restored = restore(model, res, fit_beam(psf, p['cell_rad']),
                       p['cell_rad'])
    est = estimates(restored)
    return {'sky': sky, 'clean': clean, 'noisy': noisy, 'dirty': dirty,
            'psf': psf, 'model': model, 'residual': res, 'iterations': its,
            'restored': restored, 'estimates': est,
            'fit': fit_gaussian(restored, est)}
