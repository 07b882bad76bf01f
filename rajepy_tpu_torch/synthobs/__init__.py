"""CASA-free synthetic interferometric observations of continuum and
line (RRL) runs (PyTorch port of rajepy_tpu.synthobs).

High-level entry point mirroring the reference's simobserve/tclean/imfit stage
(classes.py:2490-2851 + casa/), with the external CASA binary replaced by:

1. uv-track generation from the bundled antenna configurations and
   observatory geometry (:mod:`.uvgen`, :mod:`.observatories`), including
   the reference's elevation windows and the east-west-interferometer
   8-scan hour-angle split (classes.py:2510-2586);
2. FFT sampling of the model FITS sky image at the uv points plus
   radiometer-equation thermal noise (:mod:`.sampler`) — the measurement
   set becomes an npz visibility set;
   Optionally antenna gain corruption, the transfer of another run's
   gain solutions and UVFITS copies of the sets (:mod:`.calibration`,
   :mod:`.uvfits`);
3. Briggs-weighted gridding, FFT dirty imaging, CLEAN (Hogbom, Clark,
   multiscale or multi-term MFS for continuum runs; the channel-batched
   Hogbom for line cubes; niter=500, nsigma=3, briggs robust=0.5 as
   tclean's defaults at classes.py:2771-2782) and Gaussian restoration
   (:mod:`.imaging`), with optional StEFCal self-calibration rounds on
   continuum runs (:mod:`.calibration`);
4. for continuum runs, elliptical-Gaussian source fitting with
   CASA-imfit-compatible summary files (:mod:`.imfit`), estimates seeded
   from the Reynolds tau=1 surface exactly like the reference
   (classes.py:2720-2808).

Steps 2 and 3 run on the device of the pipeline's model, in float64 and
complex128 whatever the model's precision (the JAX package computes this
chain in float64 everywhere but on a TPU); the uv plan, the gain tracks,
the beam fit, the beam image, the source fit and the file writes are host
numpy, as in the JAX package.

A line cube is imaged channel-sharded (``parallel.sharding.
sharded_clean_cube``) when ``shard_imaging`` asks for it and there are at
least as many channels as devices.

While a profiler records, an observation is the span ``rajepy.obs.run``
and its stages the spans ``rajepy.obs.plan`` (elevation window, scans, uv
tracks, sky model, image geometry, noise level), ``.sample`` (FFT sampling
and noise, corruption, gain transfer, the sets' copy to the host),
``.image`` (weights, gridding, FFT to the dirty image and PSF, their copy
to the host, the threshold), ``.clean`` (the minor cycle), ``.restore``
(beam fit, beam image, restoration), ``.write`` (the visibility sets and
every FITS product) and ``.imfit`` (estimates, fit, summary file); the
counters ``obs.runs``, ``obs.visibilities`` (visibilities sampled) and
``obs.clean_iterations`` (minor-cycle iterations; a cube's summed over its
channels) count what they did.
"""
from __future__ import annotations

import functools
import hashlib
import os
import time
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from .. import constants as cnsts
from ..io import fits as fitsio
from ..ops import astronomy as astro
from ..ops import geometry as mgeom
from ..ops import physics as mphys
from ..utils.misc import atomic_write, casa_imfit_file_to_dict
from ..utils import profiling
from ..utils.profiling import KernelTimer
from . import calibration, imaging, imfit as imfit_mod, observatories, \
    sampler, uvgen

__all__ = ["simulate_observation", "observatories", "uvgen", "sampler",
           "imaging", "imfit_mod", "calibration"]

#: the precision of the uv/imaging chain on every device
_RDT = torch.float64


def _product_path(fitsfile: str, suffix: str) -> str:
    """Sibling product filename: swap the '.fits' extension for
    ``suffix`` ('.pbcor.fits', '.estimates', ...).  A bare str.replace
    corrupts paths whose DIRECTORIES contain the substring."""
    root, ext = os.path.splitext(fitsfile)
    if ext != '.fits':
        raise ValueError(f"expected a .fits product path, got {fitsfile}")
    return root + suffix


def _elevation_window(ra_deg, dec_deg, tscop, min_el):
    """Time above the elevation limit per day [s] (classes.py:2510-2529)."""
    lon, lat, _ = observatories.observatory_location(tscop)
    ra_hour = ra_deg / 15.0
    min_ha = ra_hour - 12.0
    if min_ha < 0:
        min_ha += 24.0
    el_range = (astro.elevation(ra_deg, dec_deg, lat, min_ha),
                astro.elevation(ra_deg, dec_deg, lat, ra_hour))
    if min(el_range) > min_el:
        time_up = int(24. * 60. * 60.)
    else:
        ha_lim = float(astro.ha(ra_deg, dec_deg, lat, min_el))
        if not np.isfinite(ha_lim):
            # arccos out of range: the source never rises above (or
            # never sets below) the elevation limit at this latitude
            raise ValueError(
                f"target (dec={dec_deg:.2f} deg) never rises above the "
                f"elevation limit {min_el:.1f} deg at {tscop} "
                f"(latitude {lat:.2f} deg) — no observable time")
        time_up = int(7200.0 * ha_lim)
    return el_range, time_up, lon, lat


def _observation(observe):
    """``observe`` inside the span ``rajepy.obs.run``, counting each
    observation it completes (``obs.runs``)."""
    @functools.wraps(observe)
    def run_observation(*args, **kwargs):
        with profiling.span('rajepy.obs.run'):
            products = observe(*args, **kwargs)
        profiling.count('obs.runs')
        return products
    return run_observation


@_observation
def simulate_observation(pipeline, run, min_el: float = 20.0,
                         seed: int = 11111,
                         max_time_samples: int = 512,
                         niter: int = 500, nsigma: float = 3.0,
                         weighting: str = 'briggs', robust: float = 0.5,
                         deconvolver: str = 'hogbom',
                         scales=(0, 3, 10),
                         smallscalebias: float = 0.0,
                         nterms: int = 2,
                         reffreq: Optional[float] = None,
                         cycleniter: int = 100,
                         uvtaper_as: Optional[float] = None,
                         pbcor: bool = False, pblimit: float = 0.2,
                         apply_pb: bool = True,
                         pb_model: str = 'gaussian',
                         pb_blockage_m: float = 0.0,
                         sefd: Optional[float] = None,
                         thermalnoise: str = 'radiometer',
                         user_pwv: float = 1.0,
                         t_ground: float = 270.0,
                         corruption: Optional[Dict] = None,
                         selfcal: Optional[str] = None,
                         selfcal_solint_s: Optional[float] = None,
                         selfcal_rounds: int = 1,
                         applycal_gains: Optional[str] = None,
                         save_products: tuple = (),
                         shard_imaging: Optional[bool] = None,
                         reuse_vis: bool = False,
                         export_uvfits: bool = False) -> Dict[str, str]:
    """Synthesise an interferometric observation of ``run``'s sky model.

    Writes (under ``run.rt_dcy``): the visibility sets
    ``SynObs/SynObs.<cfg>.vis.npz`` (clean) / ``...noisy.vis.npz``, the
    restored image ``SynObs.<cfg>.noisy.imaging.fits`` (for a line run the
    (n_chan, n, n) cube with its FREQ axis) and, for continuum runs, the
    imfit estimates/summary files.  Returns a products dict using the
    reference's keys ('ms_clean', 'ms_noisy', 'clean_image', ...).

    The keywords are the JAX package's, with the same defaults and the
    same products; see its docstring for each.  ``deconvolver`` selects
    the continuum (mfs) minor cycle: ``'hogbom'``, ``'clark'`` (with
    ``cycleniter``), ``'multiscale'`` (``scales``, ``smallscalebias``) or
    ``'mtmfs'`` (``nterms``, ``reffreq``; also writes the tt1, alpha and
    alpha.error images); line runs always image with the channel-batched
    Hogbom (:func:`imaging.clean_cube`), restored with a common beam
    fitted to the central channel's PSF.  ``seed`` (simobserve's
    thermal-noise seed, tasks.py:205) seeds a ``torch.Generator`` on the
    model's device, so the noise is torch's stream, not ``jax.random``'s.
    ``reuse_vis=True`` reuses saved visibility sets whose signature (sky
    model, uv plan, noise model, seed, primary beam, corruption and gain
    transfer) matches, which the JAX package's sets do too: the two
    packages' sets interchange.

    ``corruption`` (a dict of ``amp_rms``, ``phase_rms_deg``,
    ``coherence_s``, ``seed``) multiplies the noisy set by antenna gain
    tracks (:func:`calibration.simulate_gain_errors`, the JAX package's
    draws bit for bit); ``applycal_gains`` divides out a gains product of
    another run (``SynObs.<cfg>.selfcal.gains.npz``, of either package),
    stretched over this run's time axis.  ``selfcal='phase'`` or
    ``'amp+phase'`` runs ``selfcal_rounds`` StEFCal rounds on a continuum
    run (phase-only but the last, which uses the requested mode; one
    solution per ``selfcal_solint_s`` seconds), each solving against the
    previous CLEAN model and re-imaging: the restored image is the last
    round's, ``SynObs.<cfg>.selfcal.vis.npz`` (``ms_selfcal``) holds the
    corrected set and ``SynObs.<cfg>.selfcal.gains.npz`` (``gains``) the
    cumulative solutions, summarised in ``run.results['selfcal']``.
    ``export_uvfits=True`` also writes the clean and noisy sets as
    random-groups UVFITS files (``uvfits_clean``, ``uvfits_noisy``).

    Raises ``ValueError`` before anything is sampled or written for what
    the JAX package refuses (a deconvolver other than Hogbom or ``selfcal``
    on a line run, mtmfs with ``nterms`` outside 2-4 or fewer channels
    than terms, ``selfcal`` with mtmfs, an unknown ``selfcal`` mode,
    ``selfcal_rounds < 1``); for gain transfer, after sampling and before
    any write, a gains product of another antenna count or with a zero
    gain.  ``shard_imaging`` (None: whenever
    ``parallel.sharding.available_devices`` holds two or more devices)
    images a line cube with its channels split over the devices, when it
    has at least as many channels as devices.
    """
    cube_mode = run.obs_type != 'continuum'
    if deconvolver not in ('hogbom', 'clark', 'multiscale', 'mtmfs'):
        raise ValueError(f"unknown deconvolver {deconvolver!r}")
    if deconvolver != 'hogbom' and cube_mode:
        raise ValueError(f"deconvolver={deconvolver!r} is continuum "
                         "(mfs) only; cube runs use the channel-batched "
                         "Hogbom")
    if deconvolver == 'mtmfs':
        nterms = int(nterms)
        if nterms < 2 or nterms > 4:
            raise ValueError(f"mtmfs needs 2 <= nterms <= 4, got {nterms}")
        if selfcal:
            raise ValueError("selfcal with deconvolver='mtmfs' is not "
                             "supported (the CLEAN component model is "
                             "per-Taylor-order, not a flat sky); "
                             "selfcal with clark/hogbom/multiscale, or "
                             "transfer gains via applycal_gains")
    if selfcal not in (None, 'phase', 'amp+phase'):
        raise ValueError(f"unknown selfcal mode {selfcal!r}")
    selfcal_rounds = int(selfcal_rounds)
    if selfcal and selfcal_rounds < 1:
        raise ValueError("selfcal_rounds must be >= 1")
    if selfcal and cube_mode:
        raise ValueError("selfcal is continuum (mfs) only: line cubes "
                         "lack the per-solint SNR for a gain solve; "
                         "transfer continuum solutions instead")
    if pb_model not in ('gaussian', 'airy'):
        raise ValueError(f"unknown pb_model {pb_model!r} (gaussian/airy)")
    if isinstance(save_products, str):
        save_products = (save_products,)
    unknown = set(save_products) - {'psf', 'dirty', 'model', 'residual'}
    if unknown:
        raise ValueError(f"save_products: unknown name(s) {sorted(unknown)}"
                         " — choose from psf/dirty/model/residual")
    if weighting not in ('briggs', 'uniform', 'natural'):
        raise ValueError(f"unknown weighting {weighting!r}")
    if thermalnoise not in ('radiometer', 'tsys-atm'):
        raise ValueError(f"unknown thermalnoise mode {thermalnoise!r}")
    with profiling.span('rajepy.obs.plan'):
        model = pipeline.model
        dev = model.device
        log = pipeline.log
        tscop, t_cfg = run.tscop
        ant_file = observatories.cfg_file(tscop, t_cfg)
        ant = observatories.read_antenna_config(ant_file)

        ra_deg = astro.parse_ra(model.params['target']['ra'])
        dec_deg = astro.parse_dec(model.params['target']['dec'])

        # --- observation plan (classes.py:2510-2586) ----------------------- #
        el_range, time_up, lon, lat = _elevation_window(ra_deg, dec_deg, tscop,
                                                        min_el)
        ew_int = tscop in observatories.EW_TELESCOPES
        plan = uvgen.plan_scans(run.t_obs, time_up, ew_int)
        if log:
            log.add_entry(
                "INFO",
                "Target elevation range of {:+.0f} to {:+.0f}deg with minimum "
                "elevation of {}deg and total time on target of {:.1f}hr, "
                "means "
                "splitting observations over {} run(s)".format(
                    el_range[0], el_range[1], min_el, run.t_obs / 3600,
                    len(plan['durations'])), timestamp=False)

        # --- uv tracks ----------------------------------------------------- #
        with KernelTimer("synthobs: uv tracks", log):
            bl, _pairs = uvgen.baselines(ant['xyz'])
            uvw_list = []
            n_int_true = 0
            for dur, ha_c in zip(plan['durations'], plan['ha_centres']):
                has = uvgen.scan_hour_angles(ha_c, dur, run.t_int,
                                             max_samples=max_time_samples)
                n_int_true += max(1, int(round(dur / run.t_int)))
                uvw_list.append(uvgen.uvw_tracks(bl, has, dec_deg, lon))
            uvw = np.concatenate(uvw_list, axis=0).reshape(-1, 3)

        # --- sky model ----------------------------------------------------- #
        sky, hdr = fitsio.read_fits(run.fits_flux)
        if sky.ndim == 2:
            sky = sky[None]
        n_chan = sky.shape[0]
        cell_model_rad = abs(float(hdr['CDELT2'])) * np.pi / 180.0
        freqs = np.asarray(run.chan_freqs, dtype=float)[:n_chan]
        if deconvolver == 'mtmfs' and n_chan < nterms:
            raise ValueError(
                f"mtmfs with nterms={nterms} needs at least that many "
                f"channels to constrain the Taylor planes; this run has "
                f"{n_chan} (set the run's chanws below its bws)")

        # --- beam / image geometry (classes.py:2656-2759) ------------------ #
        max_bl = observatories.max_baseline(ant_file)
        max_bl_uvwave = max_bl / (cnsts.C / run.freq)
        beam_min_as = 1.0 / max_bl_uvwave / cnsts.ARCSEC
        cell_as = beam_min_as / 4.0
        cell_rad = cell_as * cnsts.ARCSEC
        if log:
            log.add_entry(
                "INFO",
                "With maximum baseline length of {:.0e} wavelengths, a beam "
                "width of {:.2e}arcsec is calculated and therefore using a "
                "cell size of {:.2e}arcsec".format(max_bl_uvwave, beam_min_as,
                                                   cell_as), timestamp=False)

        ny_m, nx_m = sky.shape[-2:]
        min_imsize_as = max(nx_m, ny_m) * abs(float(hdr['CDELT2'])) * 7200.0
        imsize = max(500, int(np.ceil(min_imsize_as / cell_as)))
        imsize += imsize % 2

        # small-field (coplanar) validity check: when the a-priori bound on the
        # dropped w(n-1) phase says it matters, sample by w-stacking with
        # enough planes to hold the residual under ~1e-3 per unit flux
        field_radius_rad = 0.5 * max(nx_m, ny_m) * cell_model_rad
        w_phase = sampler.w_term_max_phase_error(uvw, float(np.max(freqs)),
                                                 field_radius_rad)
        w_planes = 0
        if w_phase > 0.1:
            w_planes = sampler.n_wplanes_for(uvw, float(np.max(freqs)),
                                             field_radius_rad)
            if log:
                log.add_entry(
                    "INFO",
                    "non-coplanar (w-term) phase error bound {:.2f} rad at "
                    "the field edge exceeds 0.1 rad (max|w|={:.2e} m, field "
                    "radius {:.1f}\"): sampling visibilities by w-stacking "
                    "over {} plane(s)".format(
                        w_phase, float(np.max(np.abs(uvw[:, 2]))),
                        field_radius_rad / cnsts.ARCSEC, w_planes),
                    timestamp=False)

        # the sky model carries no information beyond its pixel Nyquist
        # 1/(2 cell): baselines out there degrid to 0 — warn, since it means
        # the model grid is too coarse for this array
        uv_max_wav = float(np.max(np.abs(uvw[:, :2]))) * \
            float(np.max(freqs)) / cnsts.C
        nyq_wav = 0.5 / cell_model_rad
        if uv_max_wav > nyq_wav and log:
            log.add_entry(
                "WARNING",
                "longest baseline ({:.3g} wavelengths) exceeds the sky "
                "model's pixel Nyquist ({:.3g}; model cell {:.2e} rad) — "
                "those visibilities carry zero model flux; use a finer "
                "model grid (smaller c_size or larger n_x/n_z) for this "
                "array".format(uv_max_wav, nyq_wav, cell_model_rad),
                timestamp=False)

        # --- noise level --------------------------------------------------- #
        lam = cnsts.C / freqs
        # per-vis noise; scale so the *imaged* noise matches the true number of
        # integrations even when time samples were decimated
        sefd_val = sefd if sefd is not None else \
            observatories.DEFAULT_SEFD.get(tscop, 500.0)
        n_samp = uvw.shape[0] // bl.shape[0] if bl.shape[0] else 1
        t_int_eff = run.t_int * max(n_int_true / max(n_samp, 1), 1.0)
        sigma = sampler.thermal_noise_sigma(sefd_val, run.chanwidth, t_int_eff)
        if thermalnoise == 'tsys-atm':
            # atmosphere-aware Tsys (CASA tsys-atm analogue): scale the
            # catalogue-SEFD sigma per channel by Tsys(nu, el, pwv)/Tsys_ref
            # at the time-weighted track-mean elevation, sampled across each
            # scan's hour-angle span
            from . import atmosphere
            ra_hour = ra_deg / 15.0
            els, wts = [], []
            for dur, ha_c in zip(plan['durations'], plan['ha_centres']):
                half_h = 0.5 * dur / 3600.0
                for ha in np.linspace(ha_c - half_h, ha_c + half_h, 5):
                    els.append(astro.elevation(ra_deg, dec_deg, lat,
                                               (ra_hour + ha) % 24.0))
                    wts.append(dur)
            el_mean = float(np.average(els, weights=wts)) if els else 90.0
            sigma = sigma * atmosphere.sefd_scale(freqs, el_mean, user_pwv,
                                                  t_ground)
            if log:
                flat = sampler.thermal_noise_sigma(sefd_val, run.chanwidth,
                                                   t_int_eff)
                log.add_entry(
                    "INFO",
                    "tsys-atm noise: pwv={:.1f}mm, t_ground={:.0f}K, mean "
                    "elevation {:.0f}deg -> sigma x{:.2f}-{:.2f} vs flat "
                    "radiometer".format(user_pwv, t_ground, el_mean,
                                        float(np.min(sigma)) / flat,
                                        float(np.max(sigma)) / flat),
                    timestamp=False)

        # --- stage-level resume (reuse_vis) -------------------------------- #
        base = os.path.basename(ant_file)
        if base.endswith('.cfg'):
            base = base[:-4]
        synobs_dcy = os.path.join(run.rt_dcy, 'SynObs')
        clean_vis_file = os.path.join(synobs_dcy, f'SynObs.{base}.vis.npz')
        noisy_vis_file = os.path.join(synobs_dcy,
                                      f'SynObs.{base}.noisy.vis.npz')
        # primary-beam width input to the sampler — part of the visibility
        # signature (an antenna-diameter edit changes the sampled PB even
        # when the positions, and so the uvw bytes, are unchanged)
        mean_dish = float(np.mean(ant['diam'])) if len(ant['diam']) else 25.0

        def _vis_signature() -> str:
            """Fingerprint of everything upstream of the sampled visibilities
            (the JAX package's, token for token, so that either package's
            saved sets are found by the other)."""
            h = hashlib.blake2b(digest_size=16)
            h.update(np.ascontiguousarray(sky).tobytes())
            h.update(np.ascontiguousarray(uvw).tobytes())
            h.update(np.ascontiguousarray(np.asarray(sigma)).tobytes())
            h.update(np.asarray(freqs).tobytes())
            parts = [sky.shape, int(seed), bool(apply_pb), pb_model,
                     float(pb_blockage_m), int(w_planes), mean_dish,
                     sorted((corruption or {}).items()), 'centre-fits']
            if applycal_gains:
                st = os.stat(applycal_gains)
                parts.append((os.path.abspath(applycal_gains),
                              st.st_size, st.st_mtime_ns))
            h.update(repr(parts).encode())
            return h.hexdigest()

        vis_sig = _vis_signature()
    with profiling.span('rajepy.obs.sample'):
        reused = False
        if reuse_vis and os.path.exists(clean_vis_file) \
                and os.path.exists(noisy_vis_file):
            try:
                with np.load(clean_vis_file) as fc, \
                        np.load(noisy_vis_file) as fn:
                    if (str(fc.get('resume_sig', '')) == vis_sig and
                            str(fn.get('resume_sig', '')) == vis_sig):
                        re_cn, im_cn = fc['vis_re'], fc['vis_im']
                        re_nn, im_nn = fn['vis_re'], fn['vis_im']
                        reused = True
            except (OSError, EOFError, ValueError, KeyError,
                    zipfile.BadZipFile):
                reused = False      # unreadable / truncated set: resample
        if reused:
            noisy = torch.complex(
                torch.as_tensor(re_nn, dtype=_RDT, device=dev),
                torch.as_tensor(im_nn, dtype=_RDT, device=dev))
            if log:
                log.add_entry(
                    "INFO",
                    "Reusing sampled visibilities from {} (signature "
                    "match — "
                    "skipping the sampling/corruption stages)".format(
                        os.path.basename(noisy_vis_file)), timestamp=False)
        else:
            # every channel FFTs its own sky plane, applies its own primary
            # beam (the role of CASA's vpmanager PB, casa/_interface.py:17-27)
            # and samples at its own uv wavelengths, on the model's device
            with KernelTimer("synthobs: vis sampling (+noise)", log) as kt:
                clean, noisy = sampler.sample_vis_cube_with_noise(
                    torch.as_tensor(sky, device=dev).to(_RDT), cell_model_rad,
                    uvw, freqs, seed, sigma, apply_pb=apply_pb,
                    dish_diameter_m=mean_dish, w_planes=w_planes,
                    pb_model=pb_model, pb_blockage_m=pb_blockage_m,
                    centre='fits')
                kt.set_result(noisy)
            profiling.count('obs.visibilities', noisy.numel())
            re_cn, im_cn = clean.real.cpu().numpy(), clean.imag.cpu().numpy()
            del clean

        # --- antenna gain corruption (sm.setgain analogue) ----------------- #
        n_ant = ant['xyz'].shape[0]
        # per-visibility (ant1, ant2, t_index), copied to the device once for
        # the corruption, the gain transfer and every selfcal round
        vis_meta = [torch.as_tensor(a, device=dev)
                    for a in calibration.vis_metadata(n_samp, _pairs)]
        if corruption and not reused:
            g_re, g_im = calibration.simulate_gain_errors(
                int(corruption.get('seed', seed + 1)), n_samp, n_ant,
                amp_rms=float(corruption.get('amp_rms', 0.0)),
                phase_rms_deg=float(corruption.get('phase_rms_deg', 0.0)),
                coherence_s=corruption.get('coherence_s'),
                t_int_s=t_int_eff)
            with KernelTimer("synthobs: gain corruption", log) as kt:
                noisy = calibration.apply_gains(
                    noisy, torch.complex(torch.from_numpy(g_re),
                                         torch.from_numpy(g_im)), *vis_meta)
                kt.set_result(noisy)
            if log:
                log.add_entry(
                    "INFO",
                    "Applied antenna gain corruption: amp_rms={:.3f}, "
                    "phase_rms={:.1f}deg, coherence={}s over {} antennas x "
                    "{} integrations".format(
                        float(corruption.get('amp_rms', 0.0)),
                        float(corruption.get('phase_rms_deg', 0.0)),
                        corruption.get('coherence_s'), n_ant, n_samp),
                    timestamp=False)

        # --- gain transfer (applycal with a gains product) ----------------- #
        if applycal_gains and not reused:
            with np.load(applycal_gains) as gt:
                g_re_t = np.asarray(gt['g_re'], dtype=float)
                g_im_t = np.asarray(gt['g_im'], dtype=float)
            if g_re_t.shape[-1] != n_ant:
                raise ValueError(
                    f"applycal_gains has {g_re_t.shape[-1]} antennas, this "
                    f"run's array has {n_ant} — gain transfer needs the "
                    "same antenna configuration")
            if not np.all(np.hypot(g_re_t, g_im_t) > 0.0):
                raise ValueError(
                    "applycal_gains contains zero gains (applycal divides "
                    "by g_i conj(g_j) — a zero would produce inf/NaN "
                    "visibilities); flag the dead antenna's solutions to "
                    "1+0j before transfer")
            with KernelTimer("synthobs: applycal (gain transfer)", log) as kt:
                noisy = calibration.correct_vis(
                    noisy, torch.complex(torch.from_numpy(g_re_t),
                                         torch.from_numpy(g_im_t)),
                    *vis_meta, n_samp)
                kt.set_result(noisy)
            if log:
                log.add_entry(
                    "INFO",
                    "Applied transferred gain solutions from {} "
                    "({} solution interval(s) stretched over {} "
                    "integrations)".format(os.path.basename(applycal_gains),
                                           g_re_t.shape[0], n_samp),
                    timestamp=False)
        if not reused:
            re_nn, im_nn = noisy.real.cpu().numpy(), noisy.imag.cpu().numpy()

    # --- visibility products, written BEFORE imaging ---------------------- #
    with profiling.span('rajepy.obs.write'):
        # the measurement-set analogue hits disk as soon as it exists, so an
        # imaging-stage failure never loses the sampling stage: a reuse_vis
        # rerun resumes from here
        if not reused:
            os.makedirs(synobs_dcy, exist_ok=True)
            with KernelTimer("synthobs: vis npz write", log):
                # uncompressed (re, im) float64 pairs, the JAX package's layout
                with atomic_write(clean_vis_file) as f:
                    np.savez(f, uvw=uvw, vis_re=re_cn, vis_im=im_cn,
                             freqs=freqs, sigma=0.0, resume_sig=vis_sig)
                with atomic_write(noisy_vis_file) as f:
                    np.savez(f, uvw=uvw, vis_re=re_nn, vis_im=im_nn,
                             freqs=freqs, sigma=sigma, resume_sig=vis_sig)

        uvfits_files = {}
        if export_uvfits:
            # standard-format copies of the visibility sets, openable by real
            # CASA (importuvfits), AIPS and difmap: host numpy, the JAX
            # package's writer
            from . import uvfits as uvfits_mod
            a1, a2, t_idx = calibration.vis_metadata(n_samp, _pairs)
            time_s = (t_idx + 0.5) * t_int_eff
            for tag, (vr, vi, sg) in {
                    'uvfits_clean': (re_cn, im_cn, 0.0),
                    'uvfits_noisy': (re_nn, im_nn, sigma)}.items():
                suffix = '.uvfits' if tag.endswith('clean') else \
                    '.noisy.uvfits'
                fname = os.path.join(synobs_dcy, f'SynObs.{base}{suffix}')
                with KernelTimer(f"synthobs: {tag} write", log):
                    uvfits_mod.write_uvfits(
                        fname, uvw, vr, vi, freqs, ant['xyz'], a1, a2,
                        time_s, ra_deg, dec_deg, sigma=sg,
                        ant_names=ant.get('names'), source='TARGET',
                        telescope=str(tscop))
                uvfits_files[tag] = fname
            if log:
                log.add_entry(
                    "INFO",
                    "Exported UVFITS visibility sets (clean + noisy) to "
                    f"{os.path.basename(uvfits_files['uvfits_noisy'])}",
                    timestamp=False)

    # --- imaging (classes.py:2761-2788) ---------------------------------- #
    # multi-frequency synthesis: all channels on one grid (continuum) or a
    # per-channel cube (RRL)
    def uvtaper_weights(us, vs):
        """tclean's outer uv taper: Gaussian rolloff in weight whose
        image-plane FWHM is uvtaper_as arcsec (FWHM_uv =
        4 ln2 / (pi FWHM_sky))."""
        if uvtaper_as is None:
            return np.ones_like(us)
        theta = float(uvtaper_as) * cnsts.ARCSEC
        fwhm_uv = 4.0 * np.log(2.0) / (np.pi * theta)
        return np.exp(-4.0 * np.log(2.0) * (us ** 2 + vs ** 2) /
                      fwhm_uv ** 2)

    # imaging weights depend on uv only, not on the visibility values:
    # selfcal re-images every round, so they are kept on the device per
    # channel selection
    _wb_cache: Dict = {}

    def image_channels(chan_idx, vis=None):
        """Dirty image and PSF of the channels ``chan_idx`` of ``vis``
        (default: the noisy set) gridded together, on the device."""
        chan_idx = np.asarray(chan_idx)
        us = (uvw[None, :, 0] / lam[chan_idx, None]).ravel()
        vs = (uvw[None, :, 1] / lam[chan_idx, None]).ravel()
        us_d = torch.as_tensor(us, dtype=_RDT, device=dev)
        vs_d = torch.as_tensor(vs, dtype=_RDT, device=dev)
        key = np.ascontiguousarray(chan_idx).tobytes()
        wb = _wb_cache.get(key)
        if wb is None:
            w0 = torch.as_tensor(uvtaper_weights(us, vs), dtype=_RDT,
                                 device=dev)
            if weighting == 'natural':
                wb = w0
            else:
                wb = imaging.briggs_weights(
                    us_d, vs_d, w0, imsize, cell_rad,
                    robust=robust if weighting == 'briggs' else -2.0)
            _wb_cache[key] = wb
        src = noisy if vis is None else vis
        sel = torch.as_tensor(chan_idx, device=src.device)
        return imaging.grid_and_image(us_d, vs_d, src[sel].reshape(-1), wb,
                                      imsize, cell_rad)

    # CLEAN mask: the model's bounding box mapped into the new image
    # (classes.py:2688-2751)
    model_extent_x_as = nx_m * abs(float(hdr['CDELT1'])) * 3600.0
    model_extent_y_as = ny_m * abs(float(hdr['CDELT2'])) * 3600.0
    half_x = int(np.ceil(model_extent_x_as / cell_as / 2.0)) + 2
    half_y = int(np.ceil(model_extent_y_as / cell_as / 2.0)) + 2
    mask = np.zeros((imsize, imsize))
    c0 = imsize // 2
    mask[max(c0 - half_y, 0):c0 + half_y,
         max(c0 - half_x, 0):c0 + half_x] = 1.0

    def beam_of(psf):
        beam = imaging.fit_psf_beam(psf, cell_rad)
        return beam, imaging.gaussian_beam_kernel(imsize, cell_rad, *beam)

    extra_maps = {}                 # save_products captures (last imaging)
    mtmfs_maps: Dict[str, np.ndarray] = {}   # tt1/alpha (mtmfs only)
    if cube_mode:
        # common restoring beam fitted to the central channel's PSF
        # (tclean 'commonbeam' behaviour), then every channel: weighting,
        # gridding, FFT, the channel-batched CLEAN, restoration
        with KernelTimer(f"synthobs: cube imaging ({n_chan} chan, "
                         f"{imsize}px)", log) as kt:
            with profiling.span('rajepy.obs.image'):
                psf0 = image_channels([n_chan // 2])[1].cpu().numpy()
            with profiling.span('rajepy.obs.restore'):
                beam, beam_kernel = beam_of(psf0)
            # every channel's weighting, gridding, FFT and restoration
            # run inside clean_cube: the span counts them as its CLEAN
            with profiling.span('rajepy.obs.clean'):
                # per-visibility taper evaluated at the run centre frequency
                # (narrow-fractional-bandwidth cubes; per-channel deviation
                # ~ (dnu/nu)^2)
                lam_c = cnsts.C / run.freq
                w_vis = uvtaper_weights(uvw[:, 0] / lam_c, uvw[:, 1] / lam_c)
                info: Dict = {}
                # the CLEAN model and residual cubes, kept only when asked
                kept = [k for k in ('model', 'residual')
                        if k in save_products]
                clean_args = (uvw, freqs, noisy, w_vis, imsize, cell_rad, mask,
                              beam_kernel)
                clean_kw = dict(weighting=weighting, robust=robust, gain=0.1,
                                niter=niter, nsigma=nsigma, info=info,
                                model_residual=bool(kept))
                from ..parallel import sharding as psh
                devs = psh.available_devices(noisy.device)
                shard = len(devs) > 1 if shard_imaging is None else \
                    bool(shard_imaging)
                if shard and 1 < len(devs) <= n_chan:
                    # each device CLEANs its own block of channels (the
                    # reference's tclean cube is sequential,
                    # classes.py:2771-2782)
                    if log:
                        log.add_entry(
                            "INFO", f"Imaging {n_chan} channels across "
                                    f"{len(devs)} devices (channel-sharded "
                                    "CLEAN)", timestamp=False)
                    mesh = psh.make_mesh(n_los=1, n_chan=len(devs),
                                         devices=devs)
                    cubes = [x.gather() for x in psh.sharded_clean_cube(
                        mesh, *clean_args, **clean_kw)]
                else:
                    cubes = list(imaging.clean_cube(*clean_args, **clean_kw))
                restored_d, dirty_d = cubes[:2]
                kt.set_result(restored_d)
                restored_cube = restored_d.cpu().numpy()
                if 'dirty' in save_products:
                    extra_maps['dirty'] = dirty_d.cpu().numpy()
                for name, cube in zip(('model', 'residual'), cubes[2:]):
                    if name in kept:
                        extra_maps[name] = cube.cpu().numpy()
                if save_products:
                    extra_maps['psf'] = psf0
                del restored_d, dirty_d, cubes
        profiling.count('obs.clean_iterations', info['channel_iterations'])
        if log:
            log.add_entry(
                "INFO",
                "Cube CLEAN: {} channels in {} block(s) of {}, {} "
                "iterations at most, {} channel-iterations".format(
                    n_chan, info['n_blocks'], info['chan_block'],
                    info['iterations'], info['channel_iterations']),
                timestamp=False)
    elif deconvolver == 'mtmfs':
        # multi-term MFS: per-channel dirty/PSF stacks, Taylor moments,
        # joint minor cycle, Taylor-plane restoration
        with KernelTimer(f"synthobs: mtmfs imaging ({n_chan} chan, "
                         f"{imsize}px, nterms={nterms})", log) as kt:
            with profiling.span('rajepy.obs.image'):
                stacks = [image_channels([ci]) for ci in range(n_chan)]
                nu_ref = float(reffreq) if reffreq else float(run.freq)
                dirty_t, psf_m = imaging.taylor_stacks(
                    torch.stack([d for d, _ in stacks]),
                    torch.stack([p for _, p in stacks]), freqs, nu_ref,
                    nterms=nterms)
                del stacks
                d0, psf0 = dirty_t[0].cpu().numpy(), psf_m[0].cpu().numpy()
                outside = d0[mask == 0]
                rms = float(np.std(outside)) if outside.size else 0.0
            with profiling.span('rajepy.obs.clean'):
                mdl_t, res_t, _its = imaging.mtmfs_clean(
                    dirty_t, psf_m, mask, gain=0.1, niter=niter,
                    threshold=nsigma * rms)
            profiling.count('obs.clean_iterations', int(_its))
            with profiling.span('rajepy.obs.restore'):
                beam, beam_kernel = beam_of(psf0)
                tt_d = torch.stack([imaging.restore(mdl_t[t], res_t[t],
                                                    beam_kernel)
                                    for t in range(nterms)])
                kt.set_result(tt_d)
                tt, res01 = tt_d.cpu().numpy(), res_t[:2].cpu().numpy()
                # in-band spectral index where tt0 is solid (5 sigma)
                solid = tt[0] > 5.0 * rms
                safe0 = np.where(solid, tt[0], 1.0)
                alpha_map = np.where(solid, tt[1] / safe0, np.nan)
                # alpha error (tclean's .alpha.error): first-order propagation
                # of the per-plane residual rms through alpha = I1/I0
                # (covariance term dropped)
                sig = [float(np.std(res01[t][mask == 0]))
                       if outside.size else 0.0 for t in range(2)]
                alpha_err = np.where(
                    solid, np.sqrt(sig[1] ** 2 + np.where(
                        solid, alpha_map, 0.0) ** 2 * sig[0] ** 2) / safe0,
                    np.nan)
                mtmfs_maps.update(tt1=tt[1], alpha=alpha_map,
                                  alpha_error=alpha_err)
                if save_products:
                    extra_maps.update(psf=psf0, dirty=d0,
                                      model=mdl_t[0].cpu().numpy(),
                                      residual=res01[0])
                restored_cube = tt[:1]
        del dirty_t, psf_m, mdl_t, res_t, tt_d
    else:
        # multi-frequency synthesis: all channels on one grid
        def mfs_image(vis, label=''):
            """Image, CLEAN and restore ``vis``: the restored image (host),
            the CLEAN model (device) and the beam."""
            with KernelTimer(f"synthobs: mfs imaging ({imsize}px{label})",
                             log) as kt:
                with profiling.span('rajepy.obs.image'):
                    dirty_d, psf_d = image_channels(np.arange(n_chan), vis)
                    dirty, psf = dirty_d.cpu().numpy(), psf_d.cpu().numpy()
                    outside = dirty[mask == 0]
                    threshold = nsigma * (float(np.std(outside))
                                          if outside.size else 0.0)
                with profiling.span('rajepy.obs.clean'):
                    if deconvolver == 'multiscale':
                        mdl, resid, _its = imaging.multiscale_clean(
                            dirty_d, psf_d, mask, scales=tuple(scales),
                            gain=0.1, niter=niter, threshold=threshold,
                            smallscalebias=smallscalebias)
                    elif deconvolver == 'clark':
                        mdl, resid, _its = imaging.clark_clean(
                            dirty_d, psf_d, mask, gain=0.1, niter=niter,
                            threshold=threshold, cycleniter=cycleniter)
                    else:
                        mdl, resid, _its = imaging.hogbom_clean(
                            dirty_d, psf_d, mask, gain=0.1, niter=niter,
                            threshold=threshold)
                profiling.count('obs.clean_iterations', int(_its))
                with profiling.span('rajepy.obs.restore'):
                    beam, beam_kernel = beam_of(psf)
                    restored_d = imaging.restore(mdl, resid, beam_kernel)
                    kt.set_result(restored_d)
                    restored = restored_d.cpu().numpy()
                    if save_products:
                        extra_maps.update(psf=psf, dirty=dirty,
                                          model=mdl.cpu().numpy(),
                                          residual=resid.cpu().numpy())
            return restored, mdl, beam

        def dynamic_range(img):
            noise = img[mask == 0]
            sd = float(np.std(noise)) if noise.size else 0.0
            return float(np.nanmax(img)) / sd if sd > 0 else np.inf

        restored, mdl, beam = mfs_image(noisy)
        if selfcal:
            if not bool(torch.any(mdl != 0)):
                raise ValueError("selfcal needs a CLEAN component model "
                                 "to solve against (niter=0 produced an "
                                 "empty one)")
            n_sol = 1
            if selfcal_solint_s:
                n_sol = int(np.clip(round(run.t_obs / selfcal_solint_s),
                                    1, n_samp))
            us = (uvw[None, :, 0] / lam[:, None]).ravel()
            vs = (uvw[None, :, 1] / lam[:, None]).ravel()
            # wide-field runs sample the DATA with w-stacking: the model
            # degrid must carry the same w phases (see model_vis)
            ws = (uvw[None, :, 2] / lam[:, None]).ravel() \
                if w_planes >= 1 else None
            dr_before = dynamic_range(restored)
            dr_rounds = []
            vis_sc = noisy
            # cumulative gain product across rounds (what applycal of a
            # single 'gain table' must divide out)
            g_tot = np.ones((n_sol, n_ant), complex)
            for rnd in range(selfcal_rounds):
                # the CASA reduction ladder: phase-only rounds against
                # progressively better models, the requested mode last
                mode = (selfcal if rnd == selfcal_rounds - 1 else 'phase')
                with KernelTimer(f"synthobs: selfcal round {rnd + 1} "
                                 f"({mode}, {n_sol} solint)", log) as kt:
                    mv = calibration.model_vis(
                        mdl, cell_rad, us, vs, w_wav=ws,
                        n_wplanes=w_planes).reshape(n_chan, -1)
                    g_sol = calibration.solve_gains(
                        vis_sc, mv, *vis_meta, n_ant=n_ant, n_t=n_samp,
                        n_sol=n_sol, mode=mode)
                    vis_sc = calibration.correct_vis(vis_sc, g_sol,
                                                     *vis_meta, n_samp)
                    kt.set_result(vis_sc)
                    g_sol = g_sol.cpu().numpy()
                    del mv
                g_tot = g_tot * g_sol
                restored, mdl, beam = mfs_image(vis_sc,
                                                f', selfcal {rnd + 1}')
                dr_rounds.append(dynamic_range(restored))
            g_amp = np.abs(g_sol)
            g_phs = np.degrees(np.angle(g_sol))
            run.results['selfcal'] = {
                'mode': selfcal, 'n_sol': n_sol,
                'rounds': selfcal_rounds,
                'gain_amp_rms': float(np.std(g_amp)),
                'gain_phase_rms_deg': float(np.std(g_phs)),
                'dynamic_range_before': dr_before,
                'dynamic_range_rounds': dr_rounds,
                'dynamic_range_after': dr_rounds[-1]}
            if log:
                log.add_entry(
                    "INFO",
                    "selfcal ({}, {} round(s), {} solution interval(s)): "
                    "final-round gain rms amp={:.3f} phase={:.1f}deg; "
                    "image dynamic range {:.1f} -> {}".format(
                        selfcal, selfcal_rounds, n_sol,
                        float(np.std(g_amp)), float(np.std(g_phs)),
                        dr_before,
                        ' -> '.join(f'{d:.1f}' for d in dr_rounds)),
                    timestamp=False)
        restored_cube = restored[None]
        del mdl
    del noisy
    bmaj_rad, bmin_rad, bpa_deg = beam

    # --- products -------------------------------------------------------- #
    # (the clean/noisy visibility sets were written before imaging)
    with profiling.span('rajepy.obs.write'):
        if selfcal:
            with KernelTimer("synthobs: selfcal npz write", log):
                selfcal_vis_file = os.path.join(
                    synobs_dcy, f'SynObs.{base}.selfcal.vis.npz')
                with atomic_write(selfcal_vis_file) as f:
                    np.savez(f, uvw=uvw, vis_re=vis_sc.real.cpu().numpy(),
                             vis_im=vis_sc.imag.cpu().numpy(), freqs=freqs,
                             sigma=sigma)
                gains_file = os.path.join(
                    synobs_dcy, f'SynObs.{base}.selfcal.gains.npz')
                with atomic_write(gains_file) as f:
                    np.savez(f, g_re=g_tot.real, g_im=g_tot.imag,
                             n_ant=n_ant, mode=str(selfcal),
                             t_obs=float(run.t_obs))
            del vis_sc

        dcy = run.rt_dcy
        fitsfile = os.path.join(dcy, f'SynObs.{base}.noisy.imaging.fits')
        out_hdr = fitsio.Header()
        out_hdr['OBJECT'] = model.params['target']['name']
        out_hdr['BUNIT'] = 'Jy/beam'
        out_hdr['CTYPE1'] = 'RA---TAN'
        out_hdr['CTYPE2'] = 'DEC--TAN'
        out_hdr['CRVAL1'] = ra_deg
        out_hdr['CRVAL2'] = dec_deg
        # the imager's zero-phase point is integer pixel imsize//2 (FFT DC
        # after fftshift), so CRPIX is that pixel 1-based — CASA's n/2+1
        out_hdr['CRPIX1'] = imsize // 2 + 1
        out_hdr['CRPIX2'] = imsize // 2 + 1
        out_hdr['CDELT1'] = -cell_as / 3600.0
        out_hdr['CDELT2'] = cell_as / 3600.0
        out_hdr['BMAJ'] = np.degrees(bmaj_rad)
        out_hdr['BMIN'] = np.degrees(bmin_rad)
        out_hdr['BPA'] = bpa_deg
        if cube_mode:
            # spectral axis, as CASA exportfits writes for tclean cubes
            out_hdr['CTYPE3'] = 'FREQ'
            out_hdr['CRPIX3'] = 1.0
            out_hdr['CRVAL3'] = float(freqs[0])
            out_hdr['CDELT3'] = float(freqs[1] - freqs[0]) if len(freqs) > 1 \
                else float(run.chanwidth)
            out_hdr['CUNIT3'] = 'Hz'
        with KernelTimer("synthobs: image FITS write", log):
            fitsio.write_fits(
                fitsfile, restored_cube if cube_mode else restored_cube[0],
                out_hdr)

        products = {'ms_clean': clean_vis_file, 'ms_noisy': noisy_vis_file,
                    'clean_image': fitsfile}
        products.update(uvfits_files)
        if selfcal:
            products['ms_selfcal'] = selfcal_vis_file
            products['gains'] = gains_file

        if mtmfs_maps:
            # mtmfs Taylor/spectral-index products (tclean writes .tt0/.tt1/
            # .alpha image sets; the restored image above is tt0)
            hdr_a = out_hdr.copy()
            hdr_a['BUNIT'] = ''     # the spectral index is dimensionless
            for key, suffix, name, hdr_p in (
                    ('clean_image_tt1', '.tt1.fits', 'tt1', out_hdr),
                    ('alpha', '.alpha.fits', 'alpha', hdr_a),
                    ('alpha_error', '.alpha.error.fits', 'alpha_error',
                     hdr_a)):
                pfile = _product_path(fitsfile, suffix)
                with KernelTimer(f"synthobs: {suffix[1:-5]} FITS write", log):
                    fitsio.write_fits(pfile, mtmfs_maps[name], hdr_p)
                products[key] = pfile

        if pbcor:
            # primary-beam-corrected image (tclean pbcor/pblimit): divide by
            # the same PB model the sampler applied, NaN below pblimit, one
            # channel's PB plane at a time
            pb_freqs = freqs if cube_mode else np.asarray([run.freq])
            pbc = np.empty_like(restored_cube)
            for k, f in enumerate(pb_freqs):
                pb_k = sampler.primary_beam(imsize, imsize, cell_rad, f,
                                            mean_dish, model=pb_model,
                                            blockage_m=pb_blockage_m)
                pbc[k] = np.where(pb_k >= pblimit, restored_cube[k] / pb_k,
                                  np.nan)
            pbcor_file = _product_path(fitsfile, '.pbcor.fits')
            with KernelTimer("synthobs: pbcor FITS write", log):
                fitsio.write_fits(pbcor_file, pbc if cube_mode else pbc[0],
                                  out_hdr)
            products['clean_image_pbcor'] = pbcor_file

        if save_products:
            # tclean's auxiliary images (the reference keeps CASA's .psf/
            # .residual/.model artefacts, README "Data products"); a cube
            # keeps its common-beam psf plane and its dirty, model and
            # residual cubes
            bunits = {'psf': '', 'dirty': 'Jy/beam', 'model': 'Jy/pixel',
                      'residual': 'Jy/beam'}
            for name in save_products:
                arr = extra_maps.get(name)
                if arr is None:
                    if log:
                        log.add_entry(
                            "WARNING",
                            f"save_products: '{name}' is not available from "
                            f"{'cube' if cube_mode else 'mfs'} imaging",
                            timestamp=False)
                    continue
                hdr_p = out_hdr.copy()
                if cube_mode and arr.ndim == 2:
                    # the common-beam psf plane is 2-D: strip the cube's
                    # spectral-axis cards or the file advertises a FREQ axis
                    # it does not have
                    hdr_p._cards = [c for c in hdr_p._cards
                                    if not c[0].endswith('3')]
                hdr_p['BUNIT'] = bunits[name]
                pfile = _product_path(fitsfile, f'.{name}.fits')
                with KernelTimer(f"synthobs: {name} FITS write", log):
                    fitsio.write_fits(pfile, arr, hdr_p)
                products[name] = pfile

    if cube_mode:
        return products

    # --- imfit (continuum only; classes.py:2690-2840) -------------------- #
    with profiling.span('rajepy.obs.imfit'):
        fm_data = sky[0]
        yy, xx = np.mgrid[0:ny_m, 0:nx_m]
        xx_as = (xx + 0.5 - nx_m / 2) * abs(float(hdr['CDELT1'])) * 3600.0
        yy_as = (yy + 0.5 - ny_m / 2) * abs(float(hdr['CDELT2'])) * 3600.0
        rr_as = np.sqrt(xx_as ** 2 + yy_as ** 2)
        peak_flux = float(np.nansum(
            np.where(rr_as < beam_min_as / 2.0, fm_data, 0.0)))

        # expected deconvolved jet dims from the tau = 1 surface
        # (classes.py:2720-2746): scalar algebra on the host
        mp = model.params
        r_0_au = mp['geometry']['r_0']
        mod_r_0_au = mp['geometry']['mod_r_0']
        w_0_au = mp['geometry']['w_0']
        tau_0 = float(mphys.tau_r_from_params(mp, run.freq, r_0_au))
        q_tau = mp['power_laws']['q_tau']
        eps = mp['geometry']['epsilon']
        dist_pc = mp['target']['dist']
        maj_au = (mod_r_0_au * tau_0 ** (-1.0 / q_tau) + r_0_au -
                  mod_r_0_au) * 2.0
        maj_as = np.arctan(maj_au * cnsts.AU /
                           (dist_pc * cnsts.PARSEC)) / cnsts.ARCSEC
        min_au = float(mgeom.w_r(maj_au / 2.0, w_0_au, mod_r_0_au, r_0_au,
                                 eps))
        min_as = np.arctan(min_au * cnsts.AU /
                           (dist_pc * cnsts.PARSEC)) / cnsts.ARCSEC
        conv_maj = float(np.sqrt(maj_as ** 2 + beam_min_as ** 2))
        conv_min = float(np.sqrt(min_as ** 2 + beam_min_as ** 2))
        if conv_min > conv_maj:
            conv_maj, conv_min = conv_min, conv_maj

        est_file = _product_path(fitsfile, '.estimates')
        products['estimates'] = est_file
        with open(est_file, 'wt') as f:
            f.write('{:.6f}, {:.1f}, {:.1f}, {:.5f}arcsec, {:.5f}arcsec, '
                    '{:.2f}deg'.format(peak_flux, imsize / 2.0, imsize / 2.0,
                                       conv_maj, conv_min,
                                       mp['geometry']['pa']))

        beam_area_pix = (np.pi / (4 * np.log(2.0)) *
                         (bmaj_rad / cell_rad) * (bmin_rad / cell_rad))
        fit_t0 = time.perf_counter()
        fit = imfit_mod.fit_gaussian(
            restored_cube[0],
            estimates={'peak': max(peak_flux, 1e-12), 'x': imsize / 2.0,
                       'y': imsize / 2.0, 'maj_pix': conv_maj / cell_as,
                       'min_pix': conv_min / cell_as,
                       'pa_deg': mp['geometry']['pa']},
            beam_area_pix=beam_area_pix)
        profiling.record_stage("host source fit (imfit)",
                               time.perf_counter() - fit_t0)
        imfit_file = _product_path(fitsfile, '.imfit')
        if fit is not None:
            imfit_mod.write_imfit_summary(imfit_file, fit, cell_as,
                                          beam_area_pix)
            products['imfit'] = imfit_file
            run.results['imfit'] = {
                h: {'val': v['value'], 'unit': v['units']}
                for h, v in casa_imfit_file_to_dict(imfit_file).items()
                if h}
        else:
            run.results['imfit'] = None

    return products
