"""``observe_runs``: a closed loop of observed continuum runs, one client.
A request is ``Pipeline.execute_run(i, simobserve=True, plot=False,
resume=False, clobber=True)`` for the next run index ``i`` of a seeded
permutation of the campaign's runs, cycled: the RT run and its FITS
products, then the synthetic observation (uv tracks, sampling with noise,
Briggs imaging, Hogbom, restoration, imfit) and its products.  The
campaign is the bundled pipeline parameters
(``rajepy_tpu_torch/data/example-pipeline-params.py``) with the
configuration's ``pipeline`` group (``min_el`` and the ``continuum``
block, which are the bundled ones as shipped) in their place, its RRL
block empty, in a fresh temporary directory, with ``params['synthobs']``
the mix's ``synthobs``.  Mix keys: ``synthobs``; ``observe``, the settings the
program takes by default (``seed``, ``max_time_samples``, ``niter``,
``nsigma``, ``robust``, ``sefd``, and the loop gain ``gain`` and
aperture efficiency ``eta`` it fixes), which the reference is given with
``synthobs`` over them; ``sample_runs``; ``trace_requests``.

The check reads a sampled run's own products: once a run is sampled, its
directory is moved aside (one rename), so no later request rewrites it.
Each stage is held against the plain reference
(``benchmark/reference/observe.py``, float64) fed with the program's own
inputs to that stage: the flux map against the reference jet; the clean
visibilities against the direct transform of the run's sky map; the noise
(noisy less clean) against sigma; the dirty image and PSF against the
reference's weights, gridding and FFT of the run's noisy set; the model and
residual against the reference's Hogbom from the run's dirty image and
PSF, with the same number of iterations; the restored image against the
reference's beam fit and restoration of the run's model and residual; the
source fit against the reference's fit of the run's restored image from
the run's estimates."""
from __future__ import annotations

import math
import os
import runpy
import shutil
import tempfile
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.workloads import (YEAR, Reservoir, device_ms,
                                         map_gap, model_params, quiet_log)
from benchmark.reference import observe as ref
from benchmark.reference.jet import Jet, grid_dims
from benchmark.reference.constants import AU, PARSEC

COUNTERS = ('obs.runs', 'obs.visibilities', 'obs.clean_iterations')
CHECKS = ('flux_gap', 'vis_gap', 'noise_gap', 'dirty_gap', 'psf_gap',
          'clean_gap', 'restored_gap', 'imfit_gap')
#: the products a check reads, by the keys of ``run.products``
PRODUCTS = ('ms_clean', 'ms_noisy', 'clean_image', 'psf', 'dirty', 'model',
            'residual', 'estimates', 'imfit')


def bundled() -> Dict:
    """The program's bundled pipeline parameters, as shipped."""
    import rajepy_tpu_torch
    return runpy.run_path(os.path.join(
        os.path.dirname(rajepy_tpu_torch.__file__), 'data',
        'example-pipeline-params.py'))['params']


def campaign(config: Dict, mix: Dict, dcy: str) -> Dict:
    """The bundled pipeline parameters with the configuration's
    ``pipeline`` group in their place, the RRL block empty, the products
    under ``dcy`` and the mix's ``synthobs``."""
    params = bundled()
    params['min_el'] = float(config['pipeline']['min_el'])
    params['continuum'] = {k: np.asarray(v) for k, v in
                           config['pipeline']['continuum'].items()}
    params['dcys'] = {'model_dcy': dcy}
    params['rrls']['times'] = np.array([])
    params['synthobs'] = dict(mix['synthobs'])
    return params


def reference_setup(config: Dict, mix: Dict) -> Dict:
    """What the reference's plan and chain are given: the configuration's
    one continuum band and array, the target, the sky map's shape and
    cell, and the observation's settings."""
    config_params = model_params(config)
    cont = config['pipeline']['continuum']
    freq, bw, cw = (float(cont[k][0]) for k in ('freqs', 'bws', 'chanws'))
    nx, _, nz = grid_dims(config_params)
    tg = config_params['target']
    settings = dict(mix['observe'])
    settings.update((k, v) for k, v in mix['synthobs'].items()
                    if k != 'save_products')
    return dict(settings, dec=tg['dec'],
                tscop=tuple(str(t) for t in cont['tscps'][0]),
                t_obs=float(cont['t_obs'][0]),
                t_int=float(cont['t_ints'][0]),
                min_el=float(config['pipeline']['min_el']),
                freq=freq, chanwidth=cw,
                chan_freqs=freq - bw / 2.0 + cw / 2.0 +
                np.arange(int(bw / cw)) * cw,
                times=np.sort(np.asarray(cont['times'], float)),
                sky_shape=(nz, nx),
                sky_cell_rad=math.atan(config_params['grid']['c_size'] * AU /
                                       (tg['dist'] * PARSEC)))


def read_products(dcy: str, files: Dict[str, str], iterations: int) -> Dict:
    """A run's products under ``dcy`` (``files``: name -> path relative to
    it), as the compare reads them."""
    def path(k):
        return os.path.join(dcy, files[k])

    out = {'iterations': iterations}
    out['sky'] = ref.read_fits(path('flux'))[0]
    for key, name in (('clean', 'ms_clean'), ('noisy', 'ms_noisy')):
        with np.load(path(name)) as f:
            out[key] = f['vis_re'] + 1j * f['vis_im']
    for name in ('psf', 'dirty', 'model', 'residual'):
        out[name] = ref.read_fits(path(name))[0]
    out['restored'], hdr = ref.read_fits(path('clean_image'))
    cell_as = abs(hdr['CDELT2']) * 3600.0
    with open(path('estimates')) as f:
        est = [v.strip() for v in f.read().split(',')]
    out['estimates'] = {
        'peak': float(est[0]), 'x': float(est[1]), 'y': float(est[2]),
        'maj_pix': float(est[3].replace('arcsec', '')) / cell_as,
        'min_pix': float(est[4].replace('arcsec', '')) / cell_as,
        'pa_deg': float(est[5].replace('deg', ''))}
    out['fit'] = None
    if 'imfit' in files:
        with open(path('imfit')) as f:
            vals = [float(v) for v in f.read().splitlines()[2].split()]
        beam_pix = math.pi / (4.0 * math.log(2.0)) * (
            hdr['BMAJ'] * 3600.0 / cell_as) * (
            hdr['BMIN'] * 3600.0 / cell_as)
        # N Peak Peakerr Flux I Ierr X Xerr Y Yerr Maj Majerr Min ...
        out['fit'] = {'peak': vals[1], 'x': vals[6], 'y': vals[8],
                      'maj_pix': vals[10] / cell_as,
                      'min_pix': vals[12] / cell_as,
                      'flux_pixsum': vals[4] * beam_pix}
    return out


def _diff(got, want: torch.Tensor) -> float:
    """Largest |got - want|; inf where the shapes differ."""
    got = torch.as_tensor(got, device=want.device).to(want.dtype)
    if got.shape != want.shape:
        return math.inf
    return float(torch.max(torch.abs(got - want)))


def _gap(got, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|."""
    return _diff(got, want) / float(torch.max(torch.abs(want)))


def compare(got: Dict, flux: np.ndarray, setup: Dict, device) -> Dict:
    """Each stage of ``got`` (a run's products, :func:`read_products`)
    against the float64 reference fed with ``got``'s inputs to it;
    ``flux`` is the reference's flux map (n_chan, ny, nx)."""
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(f64)

    p = ref.plan(setup, f64, device)
    freqs = setup['chan_freqs']
    gaps = dict.fromkeys(CHECKS, math.inf)
    gaps['flux_gap'] = map_gap(np.asarray(got['sky']), flux)
    if np.shape(got['sky']) != flux.shape:
        return gaps
    want = ref.visibilities(t(got['sky']), setup['sky_cell_rad'], p['uvw'],
                            freqs, p['dish'])
    clean = torch.as_tensor(np.asarray(got['clean']), device=device).to(
        torch.complex128)
    noisy = torch.as_tensor(np.asarray(got['noisy']), device=device).to(
        torch.complex128)
    gaps['vis_gap'] = _gap(clean, want)
    if clean.shape != want.shape or noisy.shape != want.shape:
        return gaps
    # the rms of n draws of N(0, sigma) is sigma within sigma / sqrt(2 n):
    # the gap counts those standard errors, for each channel and part
    noise = noisy - clean
    rms = [float(torch.sqrt(torch.mean(part[c] ** 2)))
           for part in (noise.real, noise.imag)
           for c in range(noise.shape[0])]
    gaps['noise_gap'] = max(abs(r / p['sigma'] - 1.0) for r in rms) * \
        math.sqrt(2.0 * noise.shape[1])
    dirty, psf = ref.image(p, noisy, freqs, setup['robust'])
    gaps['dirty_gap'] = _gap(got['dirty'], dirty)
    gaps['psf_gap'] = _gap(got['psf'], psf)
    g_dirty, g_psf, g_model, g_res = (t(got[k]) for k in
                                      ('dirty', 'psf', 'model', 'residual'))
    if any(a.shape != dirty.shape for a in (g_dirty, g_psf, g_model, g_res)):
        return gaps
    model, res, its = ref.hogbom(
        g_dirty, g_psf, p['mask'],
        ref.threshold(g_dirty, p['mask'], setup['nsigma']), setup['gain'],
        setup['niter'])
    if its == got['iterations']:
        gaps['clean_gap'] = max(_diff(g_model, model), _diff(g_res, res)) \
            / float(torch.max(torch.abs(g_dirty)))
    restored = ref.restore(g_model, g_res, ref.fit_beam(g_psf, p['cell_rad']),
                           p['cell_rad'])
    gaps['restored_gap'] = _gap(got['restored'], restored)
    fit = ref.fit_gaussian(t(got['restored']), got['estimates'])
    if got['fit'] is not None and fit is not None:
        g = got['fit']
        gaps['imfit_gap'] = max(
            [abs(g[k] - fit[k]) / abs(fit[k])
             for k in ('peak', 'flux_pixsum', 'maj_pix', 'min_pix')] +
            [abs(g[k] - fit[k]) / fit['min_pix'] for k in ('x', 'y')])
    return gaps


class Workload:
    unit = 'run'
    control_dtype = torch.float32      # below the chain's float64
    rt_control_dtype = torch.bfloat16  # below the RT run's float32

    def __init__(self, config: Dict, mix: Dict, seed: int, device: str):
        self.config, self.params = config, model_params(config)
        self.mix, self.device = mix, device
        self.setup_ref = reference_setup(config, mix)
        n_runs = len(self.setup_ref['times'])
        self.order = np.random.default_rng([seed, 0]).permutation(n_runs)
        self.sample = Reservoir(mix['sample_runs'],
                                np.random.default_rng([seed, 1]))
        self.n = 0
        #: each request's advance of the program's observation counters
        self.deltas: List[Dict[str, int]] = []
        self.tmp = self.pipeline = None
        self.got: List[tuple] = []

    def setup(self) -> Dict:
        """Build and fill the model (the fill timed by CUDA events, ms),
        build the pipeline in a fresh directory, and warm with one run."""
        from rajepy_tpu_torch import JetModel, Pipeline
        log = quiet_log()
        jm = JetModel(model_params(self.params), log=log, device=self.device)
        fill_ms = device_ms(jm._ensure_fields, self.device)
        self.tmp = tempfile.mkdtemp(prefix='observe_runs_')
        os.makedirs(os.path.join(self.tmp, 'sampled'))
        self.pipeline = Pipeline(
            jm, campaign(self.config, self.mix,
                         os.path.join(self.tmp, 'campaign')),
            log=log)
        self._run(int(self.order[-1]))
        return {'fill_ms': fill_ms}

    def _run(self, idx: int) -> Dict[str, int]:
        from rajepy_tpu_torch.utils import profiling
        counters = getattr(profiling, 'COUNTERS', {})
        before = {k: counters.get(k, 0) for k in COUNTERS}
        self.pipeline.execute_run(idx, simobserve=True, plot=False,
                                  resume=False, clobber=True)
        return {k: counters.get(k, 0) - before[k] for k in COUNTERS}

    def request(self) -> int:
        idx = int(self.order[self.n % len(self.order)])
        self.n += 1
        delta = self._run(idx)
        self.deltas.append(delta)
        item = {'idx': idx, 'iterations': delta['obs.clean_iterations']}
        self.sample.offer(item)
        if any(it is item for it in self.sample.items):
            # the run's directory moves aside: no later run rewrites it
            run = self.pipeline.runs[idx]
            files = {k: os.path.relpath(v, run.rt_dcy)
                     for k, v in run.products.items() if k in PRODUCTS}
            files['flux'] = os.path.basename(run.fits_flux)
            item['dcy'] = os.path.join(self.tmp, 'sampled', str(self.n))
            item['files'] = files
            os.rename(run.rt_dcy, item['dcy'])
        return 1

    def release(self) -> None:
        """Read the sampled runs' products, then drop the program's state
        and the directory."""
        self.got = [(it['idx'], read_products(it['dcy'], it['files'],
                                              it['iterations']))
                    for it in self.sample.items]
        self.pipeline = None
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    def flux(self, idx: int, dtype=torch.float64) -> np.ndarray:
        """The reference jet's flux map of run ``idx`` in the FITS
        product's orientation (n_chan, nz, nx)."""
        epoch = self.setup_ref['times'][idx] * YEAR
        _, _, flux = Jet(self.params).continuum(
            [epoch], self.setup_ref['chan_freqs'], dtype, self.device)[0]
        return np.ascontiguousarray(flux.transpose(0, 2, 1))

    def check(self) -> Dict[str, float]:
        """Each sampled run's stages against the reference; the largest
        gaps."""
        gaps: Dict[str, float] = {}
        for idx, got in self.got:
            for k, v in compare(got, self.flux(idx), self.setup_ref,
                                self.device).items():
                gaps[k] = max(gaps.get(k, 0.0), v)
        return gaps

    def control(self, dtype) -> Dict[str, float]:
        """The reference in the program's place, at the seed's first run:
        the jet in :attr:`rt_control_dtype` (below the RT run's float32),
        the observation chain in ``dtype`` (below its float64)."""
        idx = int(self.order[0])
        s = self.setup_ref
        with ref.exact_matmul():
            p = ref.plan(s, dtype, self.device)
            sky = self.flux(idx, self.rt_control_dtype)
            out = ref.observe(torch.as_tensor(sky, device=self.device).to(
                dtype), s['sky_cell_rad'], p, s['chan_freqs'], s['seed'],
                s['niter'], s['nsigma'], s['gain'], s['robust'])
        got = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
               for k, v in out.items()}
        return compare(got, self.flux(idx), s, self.device)
