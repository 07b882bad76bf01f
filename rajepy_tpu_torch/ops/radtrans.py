"""Free-free continuum and radio-recombination-line radiative transfer on
tensors (PyTorch port of rajepy_tpu.ops.radtrans, radtrans.py:44-338).

The free-free opacity

    tau(nu) = 0.018 T^-1.5 nu^-2 (n_e x)^2 ds g_ff          (classes.py:1395)

factorises out of the grid in frequency (Reynolds gaunt: ``nu^-2.1``; van
Hoof gaunt at uniform T: ``nu^-2 g_ff(nu, T_0)``), so ONE line-of-sight
reduction serves every channel and per-channel work is a scalar multiply on
an (nx, nz) map.

The LOS axis is y (axis 1, 'ij' indexing).  All reductions are masked
sums, NaN-free.  The RRL opacity has no such factorisation: its
channel-independent per-cell factors (:func:`tau_rrl_precompute`) feed the
RRL kernels of :mod:`.kernels` on the float32 path, while float64 takes the
plain per-channel loop (:func:`tau_rrl_maps`).  The ordered emergent scan
(:func:`transfer_scan`) is the plain form of the emergent kernels of
:mod:`.kernels`.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .. import constants as cnsts
from . import gaunt as _gaunt
from . import kernels as kn
from . import physics as phys
from . import rrls as mrrl

LOS_AXIS = 1


def path_length_cm(ff, area, csize_au):
    """Per-cell LOS path element ds [cm]: csize * ff / area, zero outside
    (the reference's ``csize * con.au * 1e2 * (ff/areas)`` with NaNs,
    classes.py:1396-1397)."""
    pos = area > 0
    safe_area = torch.where(pos, area, torch.ones_like(area))
    return torch.where(pos, csize_au * cnsts.AU2CM * ff / safe_area,
                       torch.zeros_like(area))


def emission_measure_map(n_e, x_i, ff, area, csize_au):
    """EM = sum_los (n_e x)^2 ds [pc cm^-6] (classes.py:1101-1128)."""
    return torch.sum(emission_measure_base(n_e, x_i, ff, area, csize_au),
                     dim=LOS_AXIS)


def emission_measure_base(n_e, x_i, ff, area, csize_au):
    """Per-cell EM contribution (n_e x)^2 ds [pc cm^-6]; the LOS sum of
    this, re-weighted by the burst factor squared, gives the EM map."""
    pos = area > 0
    safe_area = torch.where(pos, area, torch.ones_like(area))
    ds_pc = torch.where(pos, csize_au * cnsts.AU / cnsts.PARSEC *
                        ff / safe_area, torch.zeros_like(area))
    return (n_e * x_i) ** 2 * ds_pc


def tau_ff_base(temp, n_es, ds_cm, inside, reynolds_gaunt: bool):
    """Frequency-independent part of the free-free opacity per cell.

    reynolds_gaunt=True: cell factor for tau = base * nu^-2.1
    reynolds_gaunt=False (van Hoof): cell factor for
        tau = base * nu^-2 * gff(nu, T_0).
    """
    safe_t = torch.where(inside, temp, torch.ones_like(temp))
    if reynolds_gaunt:
        base = 0.018 * 11.95 * safe_t ** -1.35 * n_es ** 2 * ds_cm
    else:
        base = 0.018 * safe_t ** -1.5 * n_es ** 2 * ds_cm
    return torch.where(inside, base, torch.zeros_like(base))


def tau_ff_channel_scale(freqs, t_0, reynolds_gaunt: bool):
    """Per-channel scalar multiplier for the factorised free-free opacity.
    ``t_0`` is a float or a 0-d tensor (differentiable through the van
    Hoof gaunt factor)."""
    if reynolds_gaunt:
        return freqs ** -2.1
    # keep the caller's dtype: the gaunt table is float64
    return freqs ** -2.0 * _gaunt.gff(freqs, t_0).to(freqs.dtype)


def tau_ff_maps(freqs, temp, n_es, ds_cm, inside, t_0: float,
                reynolds_gaunt: bool):
    """Collapsed free-free optical-depth maps, all channels at once:
    (n_chan, nx, nz), from one grid pass (radtrans.py:95-103)."""
    base_map = torch.sum(tau_ff_base(temp, n_es, ds_cm, inside,
                                     reynolds_gaunt), dim=LOS_AXIS)
    scale = tau_ff_channel_scale(freqs, t_0, reynolds_gaunt)
    return scale[:, None, None] * base_map[None, :, :]


def tau_ff_maps_from_static(freqs, base_static, chi2, t_0: float,
                            reynolds_gaunt: bool):
    """Collapsed tau maps from the epoch-independent base-opacity cube:
    tau(t) = scale(nu) * sum_los A * chi(t)^2 (radtrans.py:106-119).
    ``chi2`` may be a cube or the scalar 1 (no bursts)."""
    base_map = torch.sum(base_static * chi2, dim=LOS_AXIS)
    scale = tau_ff_channel_scale(freqs, t_0, reynolds_gaunt)
    return scale[:, None, None] * base_map[None, :, :]


def tau_ff_cube(freqs, temp, n_es, ds_cm, inside, t_0: float,
                reynolds_gaunt: bool):
    """Uncollapsed per-cell optical depths (n_chan, nx, ny, nz) — the
    reference's collapse=False path (classes.py:1366-1368)."""
    base = tau_ff_base(temp, n_es, ds_cm, inside, reynolds_gaunt)
    scale = tau_ff_channel_scale(freqs, t_0, reynolds_gaunt)
    return scale[:, None, None, None] * base[None]


def mean_temperature_map(temp, inside):
    """LOS-mean temperature over jet cells (nanmean of classes.py:1471-1472,
    as a masked mean).  Returns ``(tbar, any_inside)``."""
    return mean_temperature_from_sums(*temperature_sums(temp, inside))


def temperature_sums(temp, inside):
    """The LOS sum of the jet cells' temperatures and their count, the
    numerator and denominator of :func:`mean_temperature_map`: each adds
    over slabs of the line of sight, where a mean of the slabs' means
    would be wrong."""
    s = torch.where(inside, temp, torch.zeros_like(temp)).sum(dim=LOS_AXIS)
    return s, inside.sum(dim=LOS_AXIS)


def mean_temperature_from_sums(s, n):
    """``(tbar, any_inside)`` from :func:`temperature_sums`' ``(s, n)``."""
    pos = n > 0
    tbar = torch.where(pos, s / n.clamp_min(1).to(s.dtype),
                       torch.zeros_like(s))
    return tbar, pos


def intensity_ff_maps(freqs, tau_maps, tbar_map, any_inside):
    """I_ff = 2 nu^2 k_B T_B / c^2 with T_B = mean(T) (1 - e^-tau)
    (classes.py:1449-1496).  Outside the jet silhouette the map is exactly 0
    (the reference yields NaN there)."""
    t_b = tbar_map[None] * (-torch.expm1(-tau_maps))
    ints = 2.0 * freqs[:, None, None] ** 2 * cnsts.K_B * t_b / cnsts.C ** 2
    return torch.where(any_inside[None], ints, torch.zeros_like(ints))


def flux_scale_jy(csize_au: float, dist_pc):
    """Pixel solid-angle factor arctan(csize/d)^2 / 1e-26 turning intensity
    into Jy/pixel (classes.py:1519-1521): a float, or a 0-d tensor for a
    tensor ``dist_pc`` (a fitted distance)."""
    arg = (csize_au * cnsts.AU) / (dist_pc * cnsts.PARSEC)
    if isinstance(arg, torch.Tensor):
        return torch.atan(arg) ** 2 / 1e-26
    return math.atan(arg) ** 2 / 1e-26


def flux_ff_maps(freqs, tau_maps, tbar_map, any_inside, csize_au, dist_pc):
    """Free-free flux maps [Jy/pixel] for all channels
    (classes.py:1498-1541)."""
    ints = intensity_ff_maps(freqs, tau_maps, tbar_map, any_inside)
    return ints * flux_scale_jy(csize_au, dist_pc)


# --------------------------------------------------------------------------- #
# Radio recombination lines (radtrans.py:166-338)
# --------------------------------------------------------------------------- #
class RRLCoeffs:
    """Static per-line constants resolved once per run
    (classes.py:1158-1171)."""

    def __init__(self, line: str):
        element, n, dn = mrrl.rrl_parser(line)
        self.line = line
        self.element = element
        self.n = n
        self.dn = dn
        self.nu0 = mrrl.rrl_nu_0(element, n, dn)
        self.fn1n2 = mrrl.f_n1n2(n, dn)
        self.energy_n = mrrl.energy_n(n, element)
        self.z = cnsts.z_number(element)


def _line_fields(coeffs: RRLCoeffs, temp, n_es, vy, inside):
    """Masked temperature and density, Doppler-shifted line centre, the
    two FWHMs and the ion density per cell."""
    safe_t = torch.where(inside, temp, torch.ones_like(temp))
    safe_ne = torch.where(inside, n_es, torch.zeros_like(n_es))
    rest = phys.doppler_shift(coeffs.nu0, vy)
    fwhm_g = mrrl.deltanu_g(rest, safe_t, coeffs.element)
    fwhm_l = mrrl.deltanu_l(safe_ne, coeffs.n, coeffs.dn)
    n_i = mrrl.ni_from_ne(safe_ne, coeffs.element)
    return safe_t, safe_ne, rest, fwhm_g, fwhm_l, n_i


def _tau_rrl_channel(coeffs: RRLCoeffs, f, lf, ds_cm, inside):
    """Per-cell line optical depth at one channel frequency ``f``."""
    safe_t, safe_ne, rest, fwhm_g, fwhm_l, n_i = lf
    phi = mrrl.phi_voigt_nu(rest, fwhm_l, fwhm_g, f)
    kap = mrrl.kappa_l(f, coeffs.n, coeffs.fn1n2, phi, safe_ne, n_i,
                       safe_t, coeffs.z, coeffs.energy_n)
    tau = kap * ds_cm
    return torch.where(inside, tau, torch.zeros_like(tau))


def tau_rrl_maps(coeffs: RRLCoeffs, freqs, temp, n_es, vy, ds_cm, inside,
                 remat: bool = False):
    """Collapsed RRL optical-depth maps for all channels: (n_chan, nx, nz).

    Per channel (classes.py:1130-1229): Doppler-shift the rest frequency by
    the cell's LOS velocity, thermal + Stark FWHMs, Voigt profile at the
    channel frequency, kappa_L (G&S 2.114), tau = kappa ds, masked sum
    along y.  A Python loop over channels keeps one grid-shaped temporary
    set live at a time, as the JAX package's ``lax.map`` does.

    ``remat=True`` (the fit forwards) checkpoints each channel
    (``torch.utils.checkpoint``) where autograd records a graph: the
    backward pass recomputes the channel's Voigt/kappa temporaries instead
    of keeping them for every channel, so only the collapsed maps are
    stored (radtrans.py:182-199).  The values do not change."""
    lf = _line_fields(coeffs, temp, n_es, vy, inside)

    def channel(f, *lf_):
        return torch.sum(_tau_rrl_channel(coeffs, f, lf_, ds_cm, inside),
                         dim=LOS_AXIS)

    if remat and torch.is_grad_enabled() and any(
            t.requires_grad for t in (*lf, ds_cm)):
        return torch.stack([checkpoint(channel, f, *lf, use_reentrant=False)
                            for f in freqs])
    return torch.stack([channel(f, *lf) for f in freqs])


def tau_rrl_precompute(coeffs: RRLCoeffs, temp, n_es, vy, ds_cm, inside):
    """Channel-independent per-cell factors of the RRL opacity, feeding the
    RRL kernels (ops.kernels.rrl_tiles / rrl_cube): returns
    ``(amp, rest, scale, y_voigt, hkT)`` (radtrans.py:218-242)."""
    safe_t, safe_ne, rest, fwhm_g, fwhm_l, n_i = _line_fields(
        coeffs, temp, n_es, vy, inside)

    sigma = fwhm_g / (2.0 * math.sqrt(2.0 * math.log(2.0)))
    sigma = torch.where(inside, sigma, torch.ones_like(sigma))
    scale = 1.0 / (sigma * math.sqrt(2.0))
    y_voigt = 0.5 * fwhm_l * scale

    amp = (mrrl._KAPPA_L_P0 * coeffs.n ** 2.0 * coeffs.fn1n2 *
           safe_ne * n_i / safe_t ** 1.5 *
           torch.exp((coeffs.z ** 2.0 * coeffs.energy_n) /
                     (cnsts.K_CGS * safe_t)) *
           ds_cm / (sigma * math.sqrt(2.0 * math.pi)))
    amp = torch.where(inside, amp, torch.zeros_like(amp))
    hkT = cnsts.H_CGS / (cnsts.K_CGS * safe_t)
    return amp, rest, scale, y_voigt, hkT


def rrl_kernel_inputs(coeffs: RRLCoeffs, freqs, temp, n_es, vy, ds_cm,
                      inside):
    """The RRL kernels' float32 arguments ``(freqs_off, amp, rest_off,
    scale, y_voigt, hkT, nu0)``: channel frequencies and line centres are
    OFFSETS from nu0, because an absolute 3e10 Hz quantises at ~2 kHz in
    float32 (radtrans.py:255-257)."""
    amp, rest, scale, y_voigt, hkT = tau_rrl_precompute(
        coeffs, temp, n_es, vy, ds_cm, inside)
    f32 = torch.float32
    nu0 = float(coeffs.nu0)
    return ((freqs - nu0).to(f32), amp.to(f32), (rest - nu0).to(f32),
            scale.to(f32), y_voigt.to(f32), hkT.to(f32), nu0)


def tau_rrl_maps_fused(coeffs: RRLCoeffs, freqs, temp, n_es, vy, ds_cm,
                       inside):
    """Collapsed RRL optical-depth maps of the FULL grid through the RRL
    cube kernel (K5; radtrans.py:245-260): amp is read once to find the
    row blocks that hold jet cells, and only those are evaluated, for a
    group of channels at a time."""
    return kn.rrl_cube(*rrl_kernel_inputs(coeffs, freqs, temp, n_es, vy,
                                          ds_cm, inside))


def tau_rrl_maps_tiles(coeffs: RRLCoeffs, freqs, temp_t, n_es_t, vy_t,
                       ds_t, inside_t, order, seg_start, nx: int, nz: int):
    """Collapsed RRL optical-depth maps from COMPACTED jet-occupied field
    tiles (radtrans.py:263-282): the opacity factors are evaluated only on
    the tiles the jet occupies, and the tile kernel (K4) sums each (x, z)
    tile position's tiles, walked through ``(order, seg_start)`` of
    :func:`.kernels.segment_order`, straight into (n_chan, nx, nz)."""
    return kn.rrl_tiles(*rrl_kernel_inputs(coeffs, freqs, temp_t, n_es_t,
                                           vy_t, ds_t, inside_t),
                        order, seg_start, nx, nz)


def tau_rrl_cube(coeffs: RRLCoeffs, freqs, temp, n_es, vy, ds_cm, inside):
    """Uncollapsed RRL optical depths (n_chan, nx, ny, nz) — the
    collapse=False path."""
    lf = _line_fields(coeffs, temp, n_es, vy, inside)
    return torch.stack([_tau_rrl_channel(coeffs, f, lf, ds_cm, inside)
                        for f in freqs])


def _safe_tbar(tbar_map, any_inside):
    return torch.where(any_inside, tbar_map, torch.ones_like(tbar_map))[None]


def intensity_rrl_maps(freqs, tbar_map, tau_ff_maps_, tau_rrl_maps_,
                       any_inside):
    """LTE RRL intensity maps: B_nu(T) e^-tau_c (1 - e^-tau_L)
    (classes.py:1231-1290; rrls.py:428-449)."""
    ints = mrrl.line_intensity_lte(freqs[:, None, None],
                                   _safe_tbar(tbar_map, any_inside),
                                   tau_ff_maps_, tau_rrl_maps_)
    return torch.where(any_inside[None], ints, torch.zeros_like(ints))


def rrl_flux_maps_lte(freqs, scale, a_map, tbar_map, any_inside, tau_l,
                      csize_au, dist_pc, contsub: bool):
    """LTE RRL flux maps [Jy/pixel], the line plus the free-free continuum
    unless ``contsub``, with tau_c = ``scale`` x ``a_map`` per channel
    (``scale`` from :func:`tau_ff_channel_scale`): the plain version of the
    channel-stage kernel :func:`kernels.rrl_flux_maps`, which routes CPU
    tensors here."""
    tau_c = scale[:, None, None] * a_map[None]
    fluxes = intensity_rrl_maps(freqs, tbar_map, tau_c, tau_l, any_inside) \
        * flux_scale_jy(csize_au, dist_pc)
    if not contsub:
        fluxes = fluxes + flux_ff_maps(freqs, tau_c, tbar_map, any_inside,
                                       csize_au, dist_pc)
    return fluxes


def tau_rrl_maps_nonlte(freqs, tbar_map, any_inside, tau_rrl_maps_,
                        b_n1, b_n2):
    """Stimulated-corrected non-LTE line opacity b_n1 beta tau_L*
    (G&S eq. 2.141): the one definition every non-LTE product uses."""
    beta = mrrl.beta_coeff(freqs[:, None, None],
                           _safe_tbar(tbar_map, any_inside), b_n1, b_n2)
    return b_n1 * beta * tau_rrl_maps_


def intensity_rrl_maps_nonlte(freqs, tbar_map, tau_ff_maps_, tau_rrl_maps_,
                              any_inside, b_n1, b_n2):
    """Non-LTE RRL intensity maps from departure coefficients
    (see ops.rrls.line_intensity_nonlte).  ``b_n1``/``b_n2`` are floats,
    0-d tensors (fitted, differentiable) or (nx, nz) sightline maps."""
    ints = mrrl.line_intensity_nonlte(freqs[:, None, None],
                                      _safe_tbar(tbar_map, any_inside),
                                      tau_ff_maps_, tau_rrl_maps_,
                                      b_n1, b_n2)
    return torch.where(any_inside[None], ints, torch.zeros_like(ints))


# --------------------------------------------------------------------------- #
# Ordered radiative transfer along the line of sight (radtrans.py:343-369)
# --------------------------------------------------------------------------- #
def transfer_scan(source_fn_cgs, dtau, observer_near_y0: bool = False):
    """Emergent intensity from the ordered transfer integral
    I = sum_i S_i e^{-tau_acc,i} (1 - e^{-dtau_i}) along the LOS (y), with
    tau_acc the optical depth in front of cell i (an exclusive cumsum).

    ``observer_near_y0``: the observer sits at y -> -infinity when True
    (material at smaller y is in front), else at y -> +infinity."""
    if observer_near_y0:
        dtau_o, src_o = dtau, source_fn_cgs
    else:
        dtau_o = torch.flip(dtau, [LOS_AXIS])
        src_o = torch.flip(source_fn_cgs, [LOS_AXIS])
    tau_acc = kn.exclusive_cumsum(dtau_o, LOS_AXIS)
    contrib = src_o * torch.exp(-tau_acc) * (-torch.expm1(-dtau_o))
    return torch.sum(contrib, dim=LOS_AXIS)


def cumulative_tau(dtau):
    """Cumulative optical depth along the LOS (inclusive prefix scan)."""
    return torch.cumsum(dtau, dim=LOS_AXIS)
