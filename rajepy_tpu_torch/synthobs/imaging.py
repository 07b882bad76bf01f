"""Interferometric imaging: weighting, gridding, dirty images, CLEAN
(Hogbom, channel-batched Hogbom for line cubes, Clark, multiscale and
multi-term MFS), beam fitting and restoration (PyTorch port of
rajepy_tpu.synthobs.imaging).

Replaces the reference's CASA ``tclean`` invocation (casa/tasks.py:215-277,
defaults briggs robust=0.5, niter=500, nsigma=3.0 set at
classes.py:2771-2782).  Everything but the beam fit and the beam image runs
on the device of the visibilities.  The CLEAN minor cycles gate each
iteration on the device and let the host read the stop condition every
:data:`HOGBOM_CHECK_EVERY` iterations (:func:`_gated`); on CUDA tensors
Hogbom's iteration is two launches of the kernels of ``csrc/hogbom.cu``
(:func:`_hogbom`).

Gridding is deterministic: the weight density and the convolutional grid
are sums of matrix products over fixed chunks of visibilities (the
Gaussian gridding kernel is separable, so each chunk is one dense product
of its (n_vis, n_pix) kernel factors), added in chunk order.  A scatter-add
on CUDA sums in an order that changes from call to call, and Hogbom's
argmax would then pick a different pixel among near-ties.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..utils import profiling
from ..utils.profiling import KernelTimer

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


def _gated(step, n_max: int, go_on=lambda active: bool(active.any())):
    """Call ``step()`` up to ``n_max`` times without waiting for the device.

    Each call gates its own update on the device by its stop condition, so
    a call past the stop changes nothing, and returns that condition; the
    host reads it (``go_on``) every :data:`HOGBOM_CHECK_EVERY` calls and
    stops when it is false."""
    done = 0
    while done < n_max:
        for _ in range(min(HOGBOM_CHECK_EVERY, n_max - done)):
            active = step()
        done += min(HOGBOM_CHECK_EVERY, n_max - done)
        if not go_on(active):
            break


def _pad(planes: torch.Tensor) -> torch.Tensor:
    """(..., n, n) planes zero-padded by n // 2 on every side, so that any
    shift of a centre-peaked plane keeps its full support."""
    h = planes.shape[-1] // 2
    return torch.nn.functional.pad(planes, (h, h, h, h))


def _windows(padded: torch.Tensor, n: int, py: torch.Tensor,
             px: torch.Tensor):
    """The (n, n) window of each zero-padded plane (:func:`_pad` of an
    (n, n) plane) that puts the plane's centre pixel (n // 2, n // 2) on
    (py, px): ``padded`` (b, m, m), ``py`` and ``px`` (b, 1).  Two gathers,
    rows then columns."""
    b, m, _ = padded.shape
    ar = torch.arange(n, device=padded.device)
    rows = ar + (2 * (n // 2) - py)
    cols = ar + (2 * (n // 2) - px)
    w = padded.gather(1, rows[:, :, None].expand(b, n, m))
    return w.gather(2, cols[:, None, :].expand(b, n, n))


def _hogbom(dirty: torch.Tensor, psf: torch.Tensor, mask, thresholds,
            gain: float, niter: int):
    """Hogbom's minor cycle on every channel of (b, n, n) ``dirty`` and
    ``psf`` at once: (model, residual, per-channel iteration counts).

    One iteration peak-finds and subtracts on every channel still above
    its threshold; a channel at or below it takes no update, so each
    channel's result is what :func:`hogbom_clean` gives it alone.  Each
    iteration is gated on the device; every :data:`HOGBOM_CHECK_EVERY`
    iterations the host reads which channels are still active.

    CUDA tensors (float64 or float32; another dtype raises) take the
    kernels of ``csrc/hogbom.cu`` (:class:`kernels.HogbomCycle`: two
    launches an iteration, finished channels left in place), any other
    device :func:`_hogbom_plain`, their plain version; the two give equal
    results.  Counts ``obs.hogbom_calls`` on every call and
    ``obs.hogbom_kernel`` on each that ran the kernels."""
    profiling.count('obs.hogbom_calls')
    if dirty.device.type != 'cuda':
        return _hogbom_plain(dirty, psf, mask, thresholds, gain, niter)
    cycle = kernels.HogbomCycle(dirty, psf, mask, thresholds, gain)
    _gated(cycle.step, niter)
    out = cycle.finish()
    profiling.count('obs.hogbom_kernel')
    return out


def _hogbom_plain(dirty: torch.Tensor, psf: torch.Tensor, mask, thresholds,
                  gain: float, niter: int):
    """:func:`_hogbom` in eager PyTorch, on any device: the plain version
    of the Hogbom kernels.  At each check the host drops the finished
    channels from the working set (a finished channel's state is final:
    its residual no longer changes, so it stays at or below its
    threshold)."""
    nb, n, _ = dirty.shape
    dev, dt = dirty.device, dirty.dtype
    mask_flat = torch.as_tensor(mask, dtype=dt, device=dev).reshape(1, -1)
    thr = torch.as_tensor(thresholds, dtype=dt, device=dev).reshape(nb, 1)
    zero = torch.zeros((), dtype=dt, device=dev)
    neg_gain = torch.full((1, 1), -gain, dtype=dt, device=dev)
    neg_gain_parts = _split(neg_gain)
    model_out = torch.zeros((nb, n * n), dtype=dt, device=dev)
    res_out = dirty.reshape(nb, n * n).clone()
    count_out = torch.zeros(nb, dtype=torch.int64, device=dev)
    # the working set: the channels still CLEANing, as indices into the
    # outputs and their state
    st = {'live': torch.arange(nb, device=dev), 'psf': _pad(psf),
          'thr': thr, 'model': model_out.clone(), 'res': res_out.clone(),
          'count': count_out.clone()}

    def step():
        res, model = st['res'], st['model']
        masked = torch.abs(res * mask_flat)
        idx = torch.argmax(masked, dim=1, keepdim=True)
        active = masked.gather(1, idx) > st['thr']
        r_i = res.gather(1, idx)
        val = torch.where(active, r_i * gain, zero)
        # the component: model + r_i * gain, rounded once
        m_i = model.gather(1, idx)
        m_new = _sub_product(m_i, r_i, _split(r_i), neg_gain,
                             neg_gain_parts)
        model.scatter_(1, idx, torch.where(active, m_new, m_i))
        win = _windows(st['psf'], n, idx // n, idx % n).reshape(res.shape)
        st['res'] = _sub_product(res, val, _split(val), win, _split(win))
        st['count'] += active[:, 0]
        return active

    def store(sel):
        """Write the state of working-set rows ``sel`` to the outputs."""
        rows = st['live'][sel]
        for out, key in ((model_out, 'model'), (res_out, 'res'),
                         (count_out, 'count')):
            out.index_copy_(0, rows, st[key][sel])

    def go_on(active):
        flags = active[:, 0].cpu()
        if bool(flags.all()):
            return True
        store(torch.nonzero(~flags)[:, 0].to(dev))
        keep = torch.nonzero(flags)[:, 0].to(dev)
        for key in st:
            st[key] = st[key].index_select(0, keep)
        return bool(flags.any())

    _gated(step, niter, go_on)
    store(torch.arange(st['live'].shape[0], device=dev))
    return (model_out.view(nb, n, n), res_out.view(nb, n, n), count_out)


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
    model, res, count = _hogbom(dirty[None], psf[None], mask,
                                [float(threshold)], gain, niter)
    return model[0], res[0], int(count[0])


def hogbom_clean_batched(dirty: torch.Tensor, psf: torch.Tensor, mask,
                         thresholds, gain: float = 0.1, niter: int = 500):
    """Hogbom CLEAN with the channel axis batched inside the minor cycle:
    every iteration peak-finds and subtracts on all still-active channels
    at once.  A channel whose masked peak is at or below its threshold
    adds exact zeros while the others go on, so each channel's model,
    residual and count are :func:`hogbom_clean`'s on that channel alone,
    bit for bit.  On the CPU the host drops finished channels from the
    loop at its checks; on the card they stay in place (:func:`_hogbom`).

    Args:
      dirty: (n_chan, n, n); psf: (n_chan, n, n) centre-peaked;
      mask: (n, n); thresholds: (n_chan,) per-channel stop levels.
    Returns (model, residual, n_iterations) with the channel axis kept;
    ``n_iterations`` is the most any channel took (the JAX package's loop
    count).
    """
    model, res, count = _hogbom(dirty, psf, mask, thresholds, gain, niter)
    return model, res, int(count.max()) if count.numel() else 0


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


def clark_clean(dirty: torch.Tensor, psf: torch.Tensor, mask,
                gain: float = 0.1, niter: int = 500, threshold: float = 0.0,
                cycleniter: int = 100, cyclefactor: float = 1.0,
                minpsffraction: float = 0.05, maxpsffraction: float = 0.8,
                psf_patch: int = 0):
    """Clark (1980) CLEAN: patch minor cycles + exact FFT major cycles.

    The deconvolver behind tclean's default ``deconvolver='clark'``
    (casa/tasks.py:243): minor cycles subtract only the central
    ``psf_patch``-pixel patch of the PSF (default ``max(32, n // 4)``), and
    every major cycle recomputes the residual exactly as ``dirty - model *
    psf`` by FFT.  The minor cycle stops at ``peak * clip(cyclefactor *
    sidelobe, minpsffraction, maxpsffraction)``, ``sidelobe`` being the
    largest |PSF| outside the patch, or after ``cycleniter`` iterations.

    Minor iterations are gated on the device (the host reads the stop
    condition every :data:`HOGBOM_CHECK_EVERY`); the patch update and the
    component are each rounded once (:func:`_sub_product`), as in
    :func:`hogbom_clean`.  The host reads the residual's peak once a major
    cycle.

    Returns (model, residual, n_minor_iterations); ``residual`` is the
    exact ``dirty - model * psf``.
    """
    n = dirty.shape[0]
    c = n // 2
    if psf_patch <= 0:
        psf_patch = max(32, n // 4)
    p = min(int(psf_patch), n)
    p -= p % 2
    q = p // 2
    npad = n + p
    dev, dt = dirty.device, dirty.dtype
    mask_pad = torch.nn.functional.pad(
        torch.as_tensor(mask, dtype=dt, device=dev), (q, q, q, q))
    mask_flat = mask_pad.reshape(-1)
    patch = psf[c - q:c + q, c - q:c + q].reshape(-1)
    patch_parts = _split(patch)
    outside = torch.abs(psf)
    outside[c - q:c + q, c - q:c + q] = 0.0
    frac = min(max(cyclefactor * float(outside.max()), minpsffraction),
               maxpsffraction)
    fpsf = torch.fft.rfft2(torch.fft.ifftshift(psf))
    zero = torch.zeros((), dtype=dt, device=dev)
    neg_gain = torch.full((1,), -gain, dtype=dt, device=dev)
    neg_gain_parts = _split(neg_gain)
    ar = torch.arange(p, device=dev)
    win_base = (ar[:, None] * npad + ar[None, :]).reshape(-1)
    model_flat = torch.zeros(n * n, dtype=dt, device=dev)
    res_flat = torch.nn.functional.pad(dirty, (q, q, q, q)).reshape(-1)

    def masked_peak():
        return float(torch.abs(res_flat * mask_flat).max())

    def minor(stop):
        """One minor iteration, gated on ``masked peak > stop``."""
        masked = torch.abs(res_flat * mask_flat)
        idx = torch.argmax(masked).view(1)
        active = masked.index_select(0, idx) > stop
        pyp, pxp = idx // npad, idx % npad
        r_i = res_flat.index_select(0, idx)
        val = torch.where(active, r_i * gain, zero)
        midx = ((pyp - q) * n + (pxp - q)).clamp(0, n * n - 1)
        m_i = model_flat.index_select(0, midx)
        m_new = _sub_product(m_i, r_i, _split(r_i), neg_gain, neg_gain_parts)
        model_flat.index_copy_(0, midx, torch.where(active, m_new, m_i))
        # the patch-sized window of the padded residual, its start clamped
        # into the grid as a dynamic slice clamps it
        r0 = (pyp - q).clamp(0, npad - p)
        c0 = (pxp - q).clamp(0, npad - p)
        widx = win_base + r0 * npad + c0
        win = res_flat.index_select(0, widx)
        res_flat.index_copy_(0, widx, _sub_product(win, val, _split(val),
                                                   patch, patch_parts))
        it.add_(active)
        return active

    it = torch.zeros(1, dtype=torch.int64, device=dev)
    tot = 0
    peak = masked_peak()
    while tot < niter and peak > threshold:
        stop = torch.tensor(max(frac * peak, threshold), dtype=dt,
                            device=dev)
        it.zero_()
        _gated(lambda: minor(stop), min(cycleniter, niter - tot))
        tot += int(it[0])
        exact = dirty - torch.fft.irfft2(
            torch.fft.rfft2(model_flat.view(n, n)) * fpsf, s=(n, n))
        res_flat = torch.nn.functional.pad(exact, (q, q, q, q)).reshape(-1)
        peak = masked_peak()
    residual = res_flat.view(npad, npad)[q:q + n, q:q + n]
    return model_flat.view(n, n), residual, tot


def _centred_conv2(*fields):
    """Circular convolution of centre-origin fields via FFT (all centred
    at n//2; result centred).  Accepts 2+ factors."""
    acc = None
    for f in fields:
        g = torch.fft.fft2(torch.fft.ifftshift(f))
        acc = g if acc is None else acc * g
    return torch.fft.fftshift(torch.fft.ifft2(acc)).real


def _ms_scale_kernel(n: int, scale_pix: float, dtype, device):
    """Multiscale component shape: a delta for scale 0, else a unit-sum
    Gaussian of FWHM ``scale_pix`` pixels, centred at n//2."""
    if scale_pix <= 0:
        k = torch.zeros((n, n), dtype=dtype, device=device)
        k[n // 2, n // 2] = 1.0
        return k
    sig = scale_pix / 2.3548200450309493
    ax = torch.arange(n, dtype=dtype, device=device) - n // 2
    g = torch.exp(-0.5 * (ax / sig) ** 2)
    k = g[:, None] * g[None, :]
    return k / torch.sum(k)


def multiscale_clean(dirty: torch.Tensor, psf: torch.Tensor, mask,
                     scales=(0, 3, 10), gain: float = 0.1, niter: int = 500,
                     threshold: float = 0.0, smallscalebias: float = 0.0):
    """Multiscale CLEAN (Cornwell 2008).

    The deconvolver behind tclean's ``deconvolver='multiscale'`` /
    ``scales`` / ``smallscalebias`` (casa/tasks.py:242-244): each minor
    cycle peak-finds jointly over per-scale residuals ``D_s = dirty * k_s``
    (``k_s`` a delta at scale 0, else a Gaussian of FWHM ``scales[s]``
    pixels), each scale weighted by ``(1 - smallscalebias * scale_s /
    max(scales)) / sqrt(P_ss(0))``, and subtracts the cross-scale beams
    ``P_st = psf * k_s * k_t`` from every scale's residual.  The stop is
    the masked scale-0 residual peak against ``threshold``.  Iterations are
    gated on the device, as in :func:`hogbom_clean`.

    Returns ``(model_image, residual, n_iterations)``: the model is a sky
    image (components already shaped), the residual is computed exactly as
    ``dirty - model * psf``.
    """
    if scales[0] != 0:
        raise ValueError("scales[0] must be 0 (the stop threshold is "
                         "evaluated on the full-resolution residual)")
    n = dirty.shape[0]
    c = n // 2
    dev, dt = dirty.device, dirty.dtype
    n_s = len(scales)
    mask = torch.as_tensor(mask, dtype=dt, device=dev)
    ks = torch.stack([_ms_scale_kernel(n, float(s), dt, dev)
                      for s in scales])
    fks = torch.fft.fft2(torch.fft.ifftshift(ks, dim=(-2, -1)))
    fpsf = torch.fft.fft2(torch.fft.ifftshift(psf))
    fdirty = torch.fft.fft2(torch.fft.ifftshift(dirty))

    def ifft_c(f):
        return torch.fft.fftshift(torch.fft.ifft2(f), dim=(-2, -1)).real

    d = ifft_c(fks * fdirty[None])                            # (S, n, n)
    p_cross = ifft_c(fks[:, None] * fks[None, :] * fpsf[None, None])
    s_ar = torch.arange(n_s, device=dev)
    pss_centre = p_cross[s_ar, s_ar, c, c]
    p_pad = _pad(p_cross)
    max_scale = max(float(s) for s in scales) or 1.0
    bias = torch.tensor([1.0 - smallscalebias * float(s) / max_scale
                         for s in scales], dtype=dt, device=dev)
    # the greedy step's chi^2 reduction D_s[p]^2 / P_ss(0): each scale's
    # residual weighted by 1 / sqrt(P_ss(0))
    sel_w = (bias / torch.sqrt(pss_centre))[:, None, None]
    thr = torch.tensor(threshold, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    neg_gain = torch.full((1,), -gain, dtype=dt, device=dev)
    neg_gain_parts = _split(neg_gain)
    m = torch.zeros((n_s * n * n,), dtype=dt, device=dev)
    it = torch.zeros(1, dtype=torch.int64, device=dev)
    st = {'d': d}

    def step():
        d = st['d']
        active = (torch.abs(d[0] * mask).max() > thr).view(1)
        idx = torch.argmax((torch.abs(d * mask[None]) * sel_w).reshape(-1))
        idx = idx.view(1)
        s = idx // (n * n)
        py, px = (idx // n) % n, idx % n
        # the component amplitude D_s[p] / P_ss(0) * gain, added to the
        # model rounded once
        a_i = d.reshape(-1).index_select(0, idx) / \
            pss_centre.index_select(0, s)
        m_i = m.index_select(0, idx)
        m_new = _sub_product(m_i, a_i, _split(a_i), neg_gain, neg_gain_parts)
        m.index_copy_(0, idx, torch.where(active, m_new, m_i))
        amp = torch.where(active, a_i * gain, zero)
        beams = p_pad.index_select(0, s)[0]                # (S, 2n, 2n)
        win = _windows(beams, n, py.expand(n_s, 1), px.expand(n_s, 1))
        st['d'] = _sub_product(d, amp, _split(amp), win, _split(win))
        it.add_(active)
        return active

    _gated(step, niter)
    fmod = torch.sum(torch.fft.fft2(torch.fft.ifftshift(
        m.view(n_s, n, n), dim=(-2, -1))) * fks, dim=0)
    model = torch.fft.fftshift(torch.fft.ifft2(fmod)).real
    residual = dirty - _centred_conv2(model, psf)
    return model, residual, int(it[0])


def taylor_stacks(dirty_c: torch.Tensor, psf_c: torch.Tensor, freqs,
                  ref_freq: float, nterms: int = 2):
    """Taylor-weighted image/PSF moment stacks for multi-term MFS.

    Rau & Cornwell (2011, A&A 532, A71) wideband imaging: with
    ``w_c = (nu_c - nu_ref) / nu_ref``, the Taylor dirty images are
    ``I_t = (1/N) sum_c w_c^t D_c`` (t < nterms) and the PSF moment
    stack ``P_s = (1/N) sum_c w_c^s B_c`` for s < 2*nterms - 1 — the
    Hessian blocks ``H_tq = P_{t+q}`` depend only on t + q.

    Returns (dirty_t (nterms, n, n), psf_m (2*nterms - 1, n, n)).
    """
    freqs = torch.as_tensor(freqs, dtype=dirty_c.dtype,
                            device=dirty_c.device)
    w = (freqs - ref_freq) / ref_freq
    n_chan = freqs.shape[0]
    wt = torch.stack([w ** t for t in range(2 * nterms - 1)])
    psf_m = torch.einsum('sc,cij->sij', wt, psf_c) / n_chan
    dirty_t = torch.einsum('tc,cij->tij', wt[:nterms], dirty_c) / n_chan
    return dirty_t, psf_m


def mtmfs_clean(dirty_t: torch.Tensor, psf_m: torch.Tensor, mask,
                gain: float = 0.1, niter: int = 500, threshold: float = 0.0):
    """Multi-term (Taylor-polynomial) multi-frequency-synthesis CLEAN.

    The deconvolver behind tclean's ``deconvolver='mtmfs'`` / ``nterms``
    (casa/tasks.py:246): each minor cycle peak-finds on the masked order-0
    residual, solves the (nterms, nterms) Hessian system ``H a = r`` at the
    peak (``H_tq = psf_m[t+q]`` at zero lag) and subtracts ``sum_q a_q
    P_{t+q}`` from every order's residual.  Iterations are gated on the
    device, as in :func:`hogbom_clean`.

    Args:
      dirty_t: (nterms, n, n) Taylor dirty images (:func:`taylor_stacks`)
      psf_m:   (2*nterms - 1, n, n) PSF moment stack, psf_m[0] peak 1
      mask:    (n, n) CLEAN box

    Returns (model_t, residual_t, n_iterations), both (nterms, n, n).
    """
    nterms, n, _ = dirty_t.shape
    c = n // 2
    dev, dt = dirty_t.device, dirty_t.dtype
    mask = torch.as_tensor(mask, dtype=dt, device=dev)
    ti = torch.arange(nterms, device=dev)
    tq = ti[:, None] + ti[None, :]
    inv_h = torch.linalg.inv(psf_m[tq, c, c])
    thr = torch.tensor(threshold, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    n_m = psf_m.shape[0]
    psf_pad = _pad(psf_m)
    model = torch.zeros((nterms, n * n), dtype=dt, device=dev)
    it = torch.zeros(1, dtype=torch.int64, device=dev)
    st = {'res': dirty_t}

    def step():
        res = st['res']
        masked = torch.abs(res[0] * mask).reshape(-1)
        idx = torch.argmax(masked).view(1)
        active = masked.index_select(0, idx) > thr
        r = res.reshape(nterms, -1).index_select(1, idx)[:, 0]
        a = torch.where(active, gain * (inv_h @ r), zero)
        model.index_add_(1, idx, a[:, None])
        win = _windows(psf_pad, n, (idx // n).expand(n_m, 1),
                       (idx % n).expand(n_m, 1))
        st['res'] = res - torch.einsum('q,tqij->tij', a, win[tq])
        it.add_(active)
        return active

    _gated(step, niter)
    return model.view(nterms, n, n), st['res'], int(it[0])


#: device memory one block of clean_cube's channels may take: the block's
#: PSFs (zero-padded: 4 planes), models and residuals, the CLEAN loop's
#: working copies and its temporaries, counted as CUBE_PLANES (n, n)
#: float64 planes a channel
CUBE_BLOCK_BYTES = 8 << 30
CUBE_PLANES = 28


def _cube_channel(uvw, freq: float, vis, weights, n_pix: int, cell_rad,
                  inv_mask, n_out, weighting: str, robust: float,
                  nsigma: float):
    """One channel's weighting, gridding, dirty image, PSF and nsigma
    threshold from the out-of-mask RMS (a 0-d tensor)."""
    lam = 299792458.0 / freq
    u_wav = uvw[:, 0] / lam
    v_wav = uvw[:, 1] / lam
    if weighting == 'natural':
        wb = weights
    else:
        wb = briggs_weights(u_wav, v_wav, weights, n_pix, cell_rad,
                            robust=robust if weighting == 'briggs'
                            else -2.0)
    dirty, psf = grid_and_image(u_wav, v_wav, vis, wb, n_pix, cell_rad)
    mean_out = torch.sum(dirty * inv_mask) / n_out
    rms = torch.sqrt(torch.sum(((dirty - mean_out) * inv_mask) ** 2) /
                     n_out)
    return dirty, psf, nsigma * rms


def clean_cube(uvw_m, freqs, vis: torch.Tensor, weights, n_pix: int,
               cell_rad: float, mask, beam_kernel,
               weighting: str = 'briggs', robust: float = 0.5,
               gain: float = 0.1, niter: int = 500, nsigma: float = 3.0,
               chan_block: Optional[int] = None,
               info: Optional[dict] = None,
               model_residual: bool = False):
    """Per-channel imaging of a visibility cube, on the visibilities'
    device.

    The replacement for tclean's ``specmode='cube'``
    (classes.py:2771-2782): for every channel the uv wavelengths from the
    shared uvw metres, the weights (briggs, uniform = robust -2, or
    natural), :func:`grid_and_image` and an ``nsigma`` threshold from the
    dirty image's out-of-mask RMS; then the channel-batched Hogbom
    (:func:`hogbom_clean_batched`) and restoration with the common beam.

    The channels go through in blocks of ``chan_block`` (default: as many
    as :data:`CUBE_BLOCK_BYTES` holds at :data:`CUBE_PLANES` planes a
    channel).  Every
    step is per channel (the preparation and the restoration one channel
    at a time, the CLEAN channel by channel inside its batch), so the
    result does not depend on the block.

    Args:
      uvw_m:  (n_vis, >=2) baseline coordinates [m]
      freqs:  (n_chan,) channel frequencies [Hz]
      vis:    (n_chan, n_vis) complex visibilities [Jy]
      weights:(n_vis,) base visibility weights (the uv taper)
      mask:   (n_pix, n_pix) CLEAN box
      beam_kernel: (n_pix, n_pix) unit-peak restoring beam (common beam)
      info:   a dict to fill with the block size and count, the CLEAN's
              iterations (the most of any channel), loop iterations (each
              block's most, summed) and channel-iterations (every
              channel's, summed)
      model_residual: also keep every block's CLEAN model and residual,
              copied to the host as each block ends (the device holds no
              more than without them)

    Returns (restored, dirty): both (n_chan, n_pix, n_pix) [Jy/beam] on the
    visibilities' device; with ``model_residual``, (restored, dirty, model
    [Jy/pixel], residual [Jy/beam]), the model and residual on the host,
    the restored cube being the model convolved with the beam plus the
    residual.  The preparation, CLEAN and
    restoration of the blocks are recorded as the stages "synthobs: cube
    prep", "synthobs: cube CLEAN" and "synthobs: cube restore"; the
    counters ``obs.cube_channels`` and ``obs.cube_loop_iterations`` add
    the channels and the loop iterations.
    """
    dev, rdt = vis.device, vis.real.dtype
    freqs = np.asarray(freqs, dtype=float)
    n_chan = freqs.shape[0]
    uvw = torch.as_tensor(np.asarray(uvw_m)[:, :2], dtype=rdt, device=dev)
    weights = torch.as_tensor(weights, dtype=rdt, device=dev)
    mask = torch.as_tensor(mask, dtype=rdt, device=dev)
    inv_mask = 1.0 - mask
    n_out = torch.clamp(torch.sum(inv_mask), min=1.0)
    fkern = torch.fft.rfft2(torch.fft.ifftshift(
        torch.as_tensor(beam_kernel, dtype=rdt, device=dev)))
    block = int(chan_block) if chan_block else max(1, min(
        n_chan, CUBE_BLOCK_BYTES // (CUBE_PLANES * 8 * n_pix * n_pix)))
    restored = torch.empty((n_chan, n_pix, n_pix), dtype=rdt, device=dev)
    dirty = torch.empty_like(restored)
    if model_residual:
        model_cube, res_cube = (torch.empty((n_chan, n_pix, n_pix),
                                            dtype=rdt) for _ in range(2))
    n_iter, loop_iters, chan_iters = 0, 0, 0
    for b0 in range(0, n_chan, block):
        b1 = min(b0 + block, n_chan)
        with KernelTimer("synthobs: cube prep") as kt:
            psf = torch.empty((b1 - b0, n_pix, n_pix), dtype=rdt,
                              device=dev)
            thr = torch.empty(b1 - b0, dtype=rdt, device=dev)
            for k in range(b1 - b0):
                dirty[b0 + k], psf[k], thr[k] = _cube_channel(
                    uvw, float(freqs[b0 + k]), vis[b0 + k], weights, n_pix,
                    cell_rad, inv_mask, n_out, weighting, robust, nsigma)
            kt.set_result(thr)
        with KernelTimer("synthobs: cube CLEAN") as kt:
            model, res, count = _hogbom(dirty[b0:b1], psf, mask, thr, gain,
                                        niter)
            del psf
            kt.set_result(count)
        n_iter = max(n_iter, int(count.max()))
        loop_iters += int(count.max())
        chan_iters += int(count.sum())
        with KernelTimer("synthobs: cube restore") as kt:
            for k in range(b1 - b0):
                restored[b0 + k] = torch.fft.irfft2(
                    torch.fft.rfft2(model[k]) * fkern,
                    s=(n_pix, n_pix)) + res[k]
            kt.set_result(restored)
        if model_residual:
            model_cube[b0:b1].copy_(model)
            res_cube[b0:b1].copy_(res)
        del model, res
    profiling.count('obs.cube_channels', n_chan)
    profiling.count('obs.cube_loop_iterations', loop_iters)
    if info is not None:
        info.update(chan_block=block, n_blocks=-(-n_chan // block),
                    iterations=n_iter, loop_iterations=loop_iters,
                    channel_iterations=chan_iters)
    if model_residual:
        return restored, dirty, model_cube, res_cube
    return restored, dirty
