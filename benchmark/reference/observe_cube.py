"""The plain reference of the line-cube observation chain, channel by
channel, built on the continuum chain of :mod:`.observe`: the visibilities
of each channel's sky map by the direct transform at the channel's own
frequency, its dirty image and PSF (Briggs weights of its own uv
coordinates in wavelengths), an ``nsigma`` threshold from its own dirty
image, Hogbom's CLEAN, and restoration with one common beam, the fit of
the centre channel's PSF.  This is the stage of the upstream RaJePy that
drives CASA for a line run (classes.py:2490-2851 of
https://github.com/SimonP2207/RaJePy: simobserve of the flux cube, tclean
with ``specmode='cube'`` and its defaults niter 500, nsigma 3, Briggs
robust 0.5, no imfit).

Every function computes in the ``dtype`` it is given, on the device of its
inputs.  Nothing here imports the program.

Departures from tclean's cube, beyond those of :mod:`.observe` (each the
program's own model of the same step):

* the image's cell and size are set once, at the line's rest frequency
  (the run's centre), for every channel; the uv plan, the noise level and
  the CLEAN mask are the run's, shared by the channels;
* each channel's Briggs densities are its own (tclean's
  ``perchanweightdensity``), from unit weights;
* each channel's threshold is ``nsigma`` times the standard deviation of
  its dirty image outside the mask, in place of tclean's robust rms of the
  residual;
* the common restoring beam is the fit of the centre channel's PSF
  (channel n_chan // 2), in place of tclean's ``restoringbeam='common'``,
  the largest of the channels' beams (they differ by the band's
  fractional width, 0.3% here);
* no continuum subtraction, Doppler tracking or spectral regridding: the
  channels are the run's topocentric ones.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from . import observe as ref


def image_channel(p: Dict, vis: torch.Tensor, freq: float, robust: float):
    """(dirty image, PSF) of one channel's visibilities (n_vis,) at its
    frequency ``freq`` [Hz], in ``vis``'s real dtype."""
    return ref.image(p, vis[None], [freq], robust)


def clean_channel(dirty: torch.Tensor, psf: torch.Tensor, mask: torch.Tensor,
                  nsigma: float, gain: float, niter: int):
    """Hogbom of one channel to ``nsigma`` times its dirty image's
    out-of-mask standard deviation: (model, residual, iterations)."""
    return ref.hogbom(dirty, psf, mask, ref.threshold(dirty, mask, nsigma),
                      gain, niter)


def observe(sky: torch.Tensor, sky_cell_rad: float, p: Dict,
            freqs: Sequence[float], centre: int, seed: int, niter: int,
            nsigma: float, gain: float, robust: float) -> Dict:
    """The whole chain of plan ``p`` from the channels ``sky`` (n, ny, nx)
    at ``freqs``, in ``sky``'s dtype; channel ``centre`` of them gives the
    common beam.  The products a cube run of the program leaves for those
    channels: clean and noisy visibilities (n, n_vis), dirty, model,
    residual and restored cubes (n, imsize, imsize), the centre
    channel's PSF and each channel's iterations."""
    clean = ref.visibilities(sky, sky_cell_rad, p['uvw'].to(sky.dtype),
                             freqs, p['dish'])
    noisy = ref.add_noise(clean, p['sigma'], seed)
    mask = p['mask'].to(sky.dtype)
    images = [image_channel(p, noisy[k], float(f), robust)
              for k, f in enumerate(freqs)]
    beam = ref.fit_beam(images[centre][1], p['cell_rad'])
    out = {'clean': clean, 'noisy': noisy, 'psf': images[centre][1],
           'dirty': [], 'model': [], 'residual': [], 'restored': [],
           'iterations': []}
    for dirty, psf in images:
        model, res, its = clean_channel(dirty, psf, mask, nsigma, gain,
                                        niter)
        for key, value in (('dirty', dirty), ('model', model),
                           ('residual', res), ('iterations', its),
                           ('restored', ref.restore(model, res, beam,
                                                    p['cell_rad']))):
            out[key].append(value)
    for key in ('dirty', 'model', 'residual', 'restored'):
        out[key] = torch.stack(out[key])
    return out
