"""Interferometric imaging for continuum (mfs) runs: weighting, gridding,
dirty images, Hogbom CLEAN, beam fitting and restoration (PyTorch port of
the mfs part of rajepy_tpu.synthobs.imaging).

Replaces the reference's CASA ``tclean`` invocation (casa/tasks.py:215-277,
defaults briggs robust=0.5, niter=500, nsigma=3.0 set at
classes.py:2771-2782).  Everything but the beam fit and the beam image runs
on the device of the visibilities.

Gridding is deterministic: the weight density and the convolutional grid
are sums of matrix products over fixed chunks of visibilities (the
Gaussian gridding kernel is separable, so each chunk is one dense product
of its (n_vis, n_pix) kernel factors), added in chunk order.  A scatter-add
on CUDA sums in an order that changes from call to call, and Hogbom's
argmax would then pick a different pixel among near-ties.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_GRID_SIGMA = 0.65  # gridding-kernel width in uv cells
#: visibilities per gridding product: each chunk's (n_vis, n_pix) float64
#: factors take 8 * _GRID_CHUNK * n_pix bytes apiece
_GRID_CHUNK = 32768
#: Hogbom iterations queued between two host checks of the stop condition
HOGBOM_CHECK_EVERY = 32


def _split(a: torch.Tensor):
    """Veltkamp's split: a = hi + lo exactly, each with at most half the
    significand's bits, so that products of the parts are exact."""
    c = (134217729.0 if a.dtype == torch.float64 else 4097.0) * a
    hi = c - (c - a)
    return hi, a - hi


def _sub_product(r, v, v_parts, x, x_parts):
    """``r - v * x`` rounded once, as a fused multiply-add rounds it, from
    operations that each round on their own, so that every device gives the
    same bits.  Dekker's product gives v * x = p + e exactly, Knuth's sum
    r - p = s + t exactly; the result is s + (t - e).  (The JAX package's
    compilers contract ``res - val * shifted`` into a fused multiply-add;
    PyTorch runs the multiply and the subtraction as two operations, each
    rounded, on every device.)"""
    vh, vl = v_parts
    xh, xl = x_parts
    p = v * x
    e = (((vh * xh - p) + vh * xl) + vl * xh) + vl * xl
    s = r - p
    bb = s - r
    t = (r - (s - bb)) + (-p - bb)
    return s + (t - e)


def _row_chunks(rows: torch.Tensor, reach: int, n_pix: int):
    """Chunks of visibilities sorted by grid row: (lo, hi, r0, r1) with
    rows[lo:hi] in [r0 + reach, r1 - reach), clipped to the grid.  One
    copy to the host gives every chunk's band of rows."""
    n = rows.shape[0]
    los = list(range(0, n, _GRID_CHUNK))
    his = [min(lo + _GRID_CHUNK, n) for lo in los]
    ends = torch.stack((rows[los], rows[[h - 1 for h in his]]), 1).tolist()
    return [(lo, hi, max(a - reach, 0), min(b + reach + 1, n_pix))
            for lo, hi, (a, b) in zip(los, his, ends)]


def _cells(u_wav, v_wav, n_pix: int, cell_rad: float):
    """Nearest uv cell (gu, gv) of every visibility, as int64."""
    du = 1.0 / (n_pix * float(cell_rad))
    gu = torch.round(u_wav / du).to(torch.int64) + n_pix // 2
    gv = torch.round(v_wav / du).to(torch.int64) + n_pix // 2
    return gu, gv


def _herm(g: torch.Tensor, sign: float) -> torch.Tensor:
    """``g`` plus ``sign`` times its conjugate-point image: a contribution
    at (v, u) is mirrored to (n - v, n - u); mirrors that land on index n
    (from index 0) fall off the grid."""
    gf = torch.roll(torch.flip(g, (0, 1)), (1, 1), (0, 1))
    gf[0, :] = 0.0
    gf[:, 0] = 0.0
    return g + sign * gf


def grid_weights(u_wav, v_wav, weights, n_pix: int, cell_rad: float):
    """Sum the weights onto the uv grid (conjugate-symmetrised); returns the
    (n_pix, n_pix) weight-density grid used for uniform/briggs weighting."""
    gu, gv = _cells(u_wav, v_wav, n_pix, cell_rad)
    ok = (gu >= 0) & (gu < n_pix) & (gv >= 0) & (gv < n_pix)
    w = torch.where(ok, weights, torch.zeros_like(weights))
    # by row (a stable sort: the same order on every call), so that each
    # chunk's product covers only its own band of rows
    gu = torch.where(ok, gu, torch.zeros_like(gu))
    gv = torch.where(ok, gv, torch.zeros_like(gv))
    order = torch.argsort(gv, stable=True)
    gu, gv, w = gu[order, None], gv[order, None], w[order, None]
    grid = w.new_zeros((n_pix, n_pix))
    for lo, hi, r0, r1 in _row_chunks(gv[:, 0], 0, n_pix):
        # one-hot factors: grid[j, i] += sum_k [gv_k == j] w_k [gu_k == i]
        ov = w.new_zeros((hi - lo, r1 - r0)).scatter_(1, gv[lo:hi] - r0,
                                                      w[lo:hi])
        ou = w.new_zeros((hi - lo, n_pix)).scatter_(
            1, gu[lo:hi], torch.ones_like(w[lo:hi]))
        grid[r0:r1] += ov.T @ ou
    # conjugate points (n - gv, n - gu): index n falls off the grid
    return _herm(grid, 1.0)


def briggs_weights(u_wav, v_wav, weights, n_pix: int, cell_rad: float,
                   robust: float = 0.5):
    """Briggs (1995) robust weighting: w_i / (1 + W_k f^2) with
    f^2 = (5 * 10^-robust)^2 / (sum W_k^2 / sum w_i).  robust=+2 ~ natural,
    -2 ~ uniform; tclean's default robust=0.5 (casa/tasks.py:242)."""
    dens = grid_weights(u_wav, v_wav, weights, n_pix, cell_rad)
    gu, gv = _cells(u_wav, v_wav, n_pix, cell_rad)
    gu = torch.clamp(gu, 0, n_pix - 1)
    gv = torch.clamp(gv, 0, n_pix - 1)
    w_k = dens[gv, gu]
    # sum W_k^2 over uv CELLS == sum_i w_i * W_cell(i) over visibilities
    # (W_cell = sum of weights in the cell); the conjugate symmetrisation
    # scales every W_k by the same factor, which cancels exactly in the
    # W_k * f^2 product
    f2 = (5.0 * 10.0 ** -robust) ** 2 / (
        torch.sum(weights * w_k) / torch.clamp(torch.sum(weights), min=1e-30))
    return weights / (1.0 + w_k * f2)


def grid_and_image(u_wav, v_wav, vis, weights, n_pix: int, cell_rad: float,
                   support: int = 2):
    """Grid weighted visibilities and FFT to the sky plane.

    Convolutional gridding with a Gaussian kernel of ``support`` cells
    half-width (5x5 footprint by default) followed by grid correction
    (division by the kernel's image-plane transform).  Returns
    (dirty_image, dirty_beam), both (n_pix, n_pix) real tensors, beam
    peak normalised to 1 and the image in Jy/dirty-beam.

    The grid is the sum over visibility chunks of ``Av_w^T [1 | Re | Im]
    Au``, the separable kernel's factors as dense matrices: deterministic
    on every device, and the same sums as the JAX package's matmul and
    scatter forms.  The visibilities are taken in order of their grid row,
    so that a chunk's product covers only the rows its kernels reach.
    """
    cell_rad = float(cell_rad)
    rdtype = vis.real.dtype
    u_wav = torch.as_tensor(u_wav, dtype=rdtype, device=vis.device)
    v_wav = torch.as_tensor(v_wav, dtype=rdtype, device=vis.device)
    weights = torch.as_tensor(weights, dtype=rdtype, device=vis.device)
    du = 1.0 / (n_pix * cell_rad)
    fu = u_wav / du + n_pix // 2
    fv = v_wav / du + n_pix // 2
    iu = torch.round(fu).to(torch.int64)
    iv = torch.round(fv).to(torch.int64)
    ok = ((iu >= support) & (iu < n_pix - support) &
          (iv >= support) & (iv < n_pix - support))
    w = torch.where(ok, weights, torch.zeros_like(weights))
    iu_s = torch.where(ok, iu, torch.full_like(iu, n_pix // 2))
    iv_s = torch.where(ok, iv, torch.full_like(iv, n_pix // 2))

    # by row (a stable sort: the same order on every call)
    order = torch.argsort(iv_s, stable=True)
    fu, fv, iu_s, iv_s, w, vis = (x[order] for x in
                                  (fu, fv, iu_s, iv_s, w, vis))

    inv2s2 = 1.0 / (2.0 * _GRID_SIGMA ** 2)
    grids = vis.real.new_zeros((3, n_pix, n_pix))
    offs = torch.arange(-support, support + 1, device=vis.device)

    def factor(f, i_s, c0, c1):
        """Dense (chunk, c1 - c0) kernel factor: exp(-(c - f)^2 / 2s^2)
        in the 2 support + 1 columns c around i_s, zero elsewhere."""
        cols = i_s[:, None] + offs[None, :]
        d = cols.to(rdtype) - f[:, None]
        out = f.new_zeros((f.shape[0], c1 - c0))
        return out.scatter_(1, cols - c0, torch.exp(-d * d * inv2s2))

    for lo, hi, r0, r1 in _row_chunks(iv_s, support, n_pix):
        au = factor(fu[lo:hi], iu_s[lo:hi], 0, n_pix)
        av_w = factor(fv[lo:hi], iv_s[lo:hi], r0, r1) * w[lo:hi, None]
        x = vis[lo:hi, None]
        prod = torch.cat((av_w, av_w * x.real, av_w * x.imag), 1).T @ au
        grids[:, r0:r1] += prod.view(3, r1 - r0, n_pix)
    wgt_grid = _herm(grids[0], 1.0)
    vis_grid = torch.complex(_herm(grids[1], 1.0), _herm(grids[2], -1.0))

    norm = torch.clamp(torch.sum(wgt_grid), min=1e-30)
    img = torch.fft.fftshift(torch.fft.ifft2(
        torch.fft.ifftshift(vis_grid))).real
    psf = torch.fft.fftshift(torch.fft.ifft2(torch.fft.ifftshift(
        wgt_grid.to(vis_grid.dtype)))).real

    # grid correction: FT of the (cell-sampled) Gaussian kernel
    q = torch.arange(n_pix, dtype=rdtype, device=vis.device) - n_pix // 2
    corr_1d = torch.exp(-2.0 * np.pi ** 2 * _GRID_SIGMA ** 2 *
                        (q / n_pix) ** 2)
    corr = torch.outer(corr_1d, corr_1d)
    scale = n_pix * n_pix / norm
    return img * scale / corr, psf * scale / corr


def hogbom_clean(dirty: torch.Tensor, psf: torch.Tensor, mask,
                 gain: float = 0.1, niter: int = 500,
                 threshold: float = 0.0):
    """Hogbom CLEAN minor cycle.

    ``psf`` must be the same shape as ``dirty`` with its peak at the centre
    pixel; ``mask`` restricts component placement (the reference builds a
    clean box from the model's bounding box, classes.py:2748-2751).

    Each iteration runs on the device without waiting for the host: its
    update is gated by the stop condition (iterations left and masked peak
    above ``threshold``), evaluated on the device, so an iteration past the
    stop adds exact zeros.  The host reads the condition every
    :data:`HOGBOM_CHECK_EVERY` iterations.  The residual update ``res - val *
    shifted`` and the component ``model + res * gain`` are each rounded
    once (:func:`_sub_product`), as the JAX package's compiled while loop
    rounds them, so the result is that loop's: the same components,
    residual and count, on every device.

    Returns (model, residual, n_iterations).
    """
    n = dirty.shape[0]
    centre = n // 2
    dev, dt = dirty.device, dirty.dtype
    mask = torch.as_tensor(mask, dtype=dt, device=dev)
    thr = torch.as_tensor(threshold, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    neg_gain = torch.full((1,), -gain, dtype=dt, device=dev)
    neg_gain_parts = _split(neg_gain)
    # pad psf so any shift keeps full support
    psf_pad = torch.nn.functional.pad(psf, (n // 2, n // 2, n // 2, n // 2))
    wp = psf_pad.shape[1]
    # flat index of the (n, n) window at offset (0, 0) of the padded psf
    ar = torch.arange(n, device=dev)
    window = (ar[:, None] * wp + ar[None, :]).reshape(-1)
    psf_flat = psf_pad.reshape(-1)
    psf_hi, psf_lo = _split(psf_flat)
    res = dirty.clone()
    model_flat = torch.zeros(n * n, dtype=dt, device=dev)
    res_flat = res.view(-1)
    mask_flat = mask.reshape(-1)
    # every index and count is a one-element tensor: nothing here waits
    # for the device but the periodic check of ``active``
    it = torch.zeros(1, dtype=torch.int64, device=dev)
    active = torch.ones(1, dtype=torch.bool, device=dev)
    done = 0
    while done < niter:
        n_queue = min(HOGBOM_CHECK_EVERY, niter - done)
        for _ in range(n_queue):
            masked = torch.abs(res_flat * mask_flat)
            idx = torch.argmax(masked).view(1)
            active = masked.index_select(0, idx) > thr
            r_i = res_flat.index_select(0, idx)
            val = torch.where(active, r_i * gain, zero)
            # the component: model + r_i * gain, rounded once
            m_i = model_flat.index_select(0, idx)
            m_new = _sub_product(m_i, r_i, _split(r_i), neg_gain,
                                 neg_gain_parts)
            model_flat.index_copy_(0, idx, torch.where(active, m_new, m_i))
            py, px = idx // n, idx % n
            off = (centre + n // 2 - py) * wp + (centre + n // 2 - px)
            sel = window + off
            res_flat.copy_(_sub_product(res_flat, val, _split(val),
                                        psf_flat[sel],
                                        (psf_hi[sel], psf_lo[sel])))
            it += active.to(torch.int64)
        done += n_queue
        if not bool(active):
            break
    return model_flat.view(n, n), res, int(it[0])


def fit_psf_beam(psf, cell_rad: float) -> Tuple[float, float, float]:
    """Fit an elliptical Gaussian to the PSF main lobe (a host array, or a
    tensor, which is copied to the host).

    Returns (bmaj_rad, bmin_rad, bpa_deg) — FWHM axes.  Second-moment fit
    over the positive core (pixels above half maximum), the standard
    approximation used to define the CLEAN restoring beam.
    """
    if isinstance(psf, torch.Tensor):
        psf = psf.cpu().numpy()
    psf = np.asarray(psf)
    n = psf.shape[0]
    yy, xx = np.mgrid[0:n, 0:n]
    core = psf * (psf > 0.5 * psf.max())
    # keep only the central connected-ish blob: within n//8 of centre
    r2 = (yy - n // 2) ** 2 + (xx - n // 2) ** 2
    core = np.where(r2 < (n // 8) ** 2, core, 0.0)
    s = core.sum()
    cx = (core * xx).sum() / s
    cy = (core * yy).sum() / s
    mxx = (core * (xx - cx) ** 2).sum() / s
    myy = (core * (yy - cy) ** 2).sum() / s
    mxy = (core * (xx - cx) * (yy - cy)).sum() / s
    t = mxx + myy
    d = np.sqrt((mxx - myy) ** 2 + 4 * mxy ** 2)
    lam1 = (t + d) / 2.0
    lam2 = (t - d) / 2.0
    # For a 2-D Gaussian truncated at half maximum the per-axis second
    # moment is sigma^2 (1 - ln 2); undo that bias.
    calib = 1.0 / (1.0 - np.log(2.0))
    sig1 = np.sqrt(max(lam1, 1e-12) * calib)
    sig2 = np.sqrt(max(lam2, 1e-12) * calib)
    fwhm = 2.0 * np.sqrt(2.0 * np.log(2.0))
    bmaj = sig1 * fwhm * cell_rad
    bmin = sig2 * fwhm * cell_rad
    theta = 0.5 * np.degrees(np.arctan2(2 * mxy, mxx - myy))
    # position angle east of north (FITS/CASA BPA): the image basis is
    # x = West (CDELT1 < 0), y = North, so an image-frame angle theta
    # (from +x toward +y) maps to PA = theta - 90
    bpa = theta % 180.0 - 90.0
    return float(bmaj), float(bmin), float(bpa)


def gaussian_beam_kernel(n: int, cell_rad: float, bmaj_rad: float,
                         bmin_rad: float, bpa_deg: float) -> np.ndarray:
    """Unit-peak elliptical Gaussian restoring beam image (n, n), on the
    host."""
    yy, xx = np.mgrid[0:n, 0:n]
    x = (xx - n // 2) * cell_rad
    y = (yy - n // 2) * cell_rad
    # inverse of fit_psf_beam's convention: PA east of north -> image
    # angle theta = PA + 90 on the x=West/y=North basis
    th = np.radians(bpa_deg + 90.0)
    xr = x * np.cos(th) + y * np.sin(th)
    yr = -x * np.sin(th) + y * np.cos(th)
    c = 4.0 * np.log(2.0)
    return np.exp(-c * ((xr / bmaj_rad) ** 2 + (yr / bmin_rad) ** 2))


def restore(model: torch.Tensor, residual: torch.Tensor, beam_kernel):
    """Convolve the CLEAN model with the restoring beam and add residuals
    (Jy/beam), on the model's device."""
    kern = torch.as_tensor(beam_kernel, dtype=model.dtype,
                           device=model.device)
    n = model.shape[0]
    fk = torch.fft.rfft2(torch.fft.ifftshift(kern))
    fm = torch.fft.rfft2(model)
    conv = torch.fft.irfft2(fm * fk, s=(n, n))
    return conv + residual
