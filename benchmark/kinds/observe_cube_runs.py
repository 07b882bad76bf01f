"""``observe_cube_runs``: a closed loop of observed line-cube runs, one
client.  A request is ``Pipeline.execute_run(0, simobserve=True,
plot=False, resume=False, clobber=True)``: the campaign's one RRL run, its
RT products (the EM map, the tau and flux cubes as FITS), then the cube's
synthetic observation (uv plan, sampling with noise, the visibility sets,
the centre channel's PSF and the common beam, ``clean_cube`` over every
channel) and its products.  Every request is the same run.  The campaign
is the bundled pipeline parameters
(``rajepy_tpu_torch/data/example-pipeline-params.py``) with the
configuration's ``pipeline`` group in their place (``min_el``, the
continuum block with no epoch, the RRL block as shipped with one epoch),
in a fresh temporary directory, with ``params['synthobs']`` the mix's
``synthobs``.  Mix keys: ``synthobs``; ``observe`` (as
``observe_runs``'s); ``sample_runs``; ``sample_channels``;
``trace_requests``.

The check reads a sampled run's own products (its directory moved aside,
as ``observe_runs`` does): the flux cube, every channel, against the
reference jet; and for ``sample_channels`` channels (the centre channel
n_chan // 2, whose PSF the run writes, the first, and the rest drawn by
the seed) each stage against the plain reference
(``benchmark/reference/observe_cube.py``, float64) fed with the run's own
inputs to it: the clean visibilities against the direct transform of the
channel's sky map; the noise (noisy less clean) against sigma; the dirty
image against the reference's weights, gridding and FFT of the channel's
noisy set, and at the centre channel the PSF; the model and residual
against the reference's Hogbom from the run's dirty channel, its PSF (the
run's at the centre, the reference's elsewhere) and threshold; the
restored channel against the reference's restoration of the run's model
and residual with the common beam, the fit of the run's PSF."""
from __future__ import annotations

import math
import os
import shutil
import tempfile
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import clean_cube as counts
from benchmark.harness.workloads import (YEAR, Reservoir, channels,
                                         device_ms, map_gap, model_params,
                                         quiet_log)
from benchmark.kinds.observe_runs import _diff, _gap, bundled
from benchmark.reference import observe as ref
from benchmark.reference import observe_cube as ref_cube
from benchmark.reference.constants import AU, PARSEC
from benchmark.reference.jet import Jet, Line, grid_dims

COUNTERS = ('obs.runs', 'obs.clean_iterations', 'obs.cube_channels',
            'obs.cube_loop_iterations')
CHECKS = ('flux_gap', 'vis_gap', 'noise_gap', 'dirty_gap', 'psf_gap',
          'clean_gap', 'restored_gap')
#: the products a check reads, by the keys of ``run.products``
PRODUCTS = ('ms_clean', 'ms_noisy', 'clean_image', 'psf', 'dirty', 'model',
            'residual')


def campaign(config: Dict, mix: Dict, dcy: str) -> Dict:
    """The bundled pipeline parameters with the configuration's
    ``pipeline`` group over them (``min_el``, and each key of its
    ``continuum`` and ``rrls`` blocks), the products under ``dcy`` and the
    mix's ``synthobs``."""
    params = bundled()
    pipe = config['pipeline']
    params['min_el'] = float(pipe['min_el'])
    for block in ('continuum', 'rrls'):
        params[block].update((k, np.asarray(v))
                             for k, v in pipe[block].items())
    params['dcys'] = {'model_dcy': dcy}
    params['synthobs'] = dict(mix['synthobs'])
    return params


def reference_setup(config: Dict, mix: Dict) -> Dict:
    """What the reference's plan and chain are given: the configuration's
    one line, its channels about the line's rest frequency, the array,
    the target, the sky map's shape and cell, and the observation's
    settings."""
    config_params = model_params(config)
    rr = config['pipeline']['rrls']
    line = str(rr['lines'][0])
    nu0 = Line(line).nu0
    nx, _, nz = grid_dims(config_params)
    tg = config_params['target']
    settings = dict(mix['observe'])
    settings.update((k, v) for k, v in mix['synthobs'].items()
                    if k != 'save_products')
    return dict(settings, dec=tg['dec'], line=line,
                tscop=tuple(str(t) for t in rr['tscps'][0]),
                t_obs=float(rr['t_obs'][0]), t_int=float(rr['t_ints'][0]),
                min_el=float(config['pipeline']['min_el']),
                freq=nu0, chanwidth=float(rr['chanws'][0]),
                chan_freqs=channels({'bandwidth_hz': float(rr['bws'][0]),
                                     'chanwidth_hz': float(rr['chanws'][0])},
                                    nu0),
                time=float(rr['times'][0]), sky_shape=(nz, nx),
                sky_cell_rad=math.atan(config_params['grid']['c_size'] * AU /
                                       (tg['dist'] * PARSEC)))


def sample_channels(n_chan: int, k: int, seed: int) -> List[int]:
    """The check's channels: the centre n_chan // 2, the first, and the
    rest of ``k`` drawn by ``seed`` from the others; in order."""
    fixed = sorted({n_chan // 2, 0})
    rest = [c for c in range(n_chan) if c not in fixed]
    drawn = np.random.default_rng([seed, 2]).choice(
        rest, size=min(max(k - len(fixed), 0), len(rest)), replace=False)
    return sorted(fixed + [int(c) for c in drawn])


def fits_planes(path: str, planes=None) -> np.ndarray:
    """Planes ``planes`` (all if None) of a FITS file's primary image, as
    float64, read through a map of the file: (n, NAXIS2, NAXIS1) of a
    cube, (NAXIS2, NAXIS1) of an image."""
    with open(path, 'rb') as f:
        head = b''
        while True:
            head += f.read(2880)
            cards = [head[i:i + 80].decode('ascii')
                     for i in range(0, len(head), 80)]
            if any(c[:8].strip() == 'END' for c in cards):
                break
    hdr = {c[:8].strip(): c[10:].split('/')[0].strip() for c in cards
           if c[8:10] == '= '}
    shape = tuple(int(hdr[f'NAXIS{i}'])
                  for i in range(int(hdr['NAXIS']), 0, -1))
    data = np.memmap(path, dtype={'-32': '>f4', '-64': '>f8'}[hdr['BITPIX']],
                     mode='r', offset=len(head), shape=shape)
    if planes is not None:
        data = data[np.asarray(planes)]
    return np.array(data, dtype=np.float64)


def read_products(dcy: str, files: Dict[str, str], chans) -> Dict:
    """A run's products under ``dcy`` (``files``: name -> path relative to
    it) as the compare reads them: the whole flux cube, and the channels
    ``chans`` of the rest; None for a product the run did not write."""
    def path(k):
        return os.path.join(dcy, files[k])

    out = {'chans': list(chans), 'sky': fits_planes(path('flux'))}
    out['sky_chans'] = list(range(out['sky'].shape[0]))
    for key, name in (('clean', 'ms_clean'), ('noisy', 'ms_noisy')):
        with np.load(path(name)) as f:
            out[key] = f['vis_re'][chans] + 1j * f['vis_im'][chans]
    out['psf'] = fits_planes(path('psf'))
    for key, name in (('dirty', 'dirty'), ('model', 'model'),
                      ('residual', 'residual'), ('restored', 'clean_image')):
        out[key] = fits_planes(path(name), chans) if name in files else None
    return out


def compare(got: Dict, flux: np.ndarray, setup: Dict, device) -> Dict:
    """Each stage of ``got`` (a run's products, :func:`read_products`, or
    the control's) against the float64 reference fed with ``got``'s inputs
    to it; ``flux`` is the reference's flux cube on ``got``'s
    ``sky_chans`` (n, ny, nx).  Each gap is the largest over the sampled
    channels ``got['chans']``."""
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(f64)

    def planes(key, k):
        return None if got[key] is None else t(got[key][k])

    def c128(a):
        return torch.as_tensor(np.asarray(a), device=device).to(
            torch.complex128)

    p = ref.plan(setup, f64, device)
    freqs, centre = setup['chan_freqs'], len(setup['chan_freqs']) // 2
    gaps = dict.fromkeys(CHECKS, math.inf)
    gaps['flux_gap'] = map_gap(np.asarray(got['sky']), flux)
    if np.shape(got['sky']) != flux.shape or centre not in got['chans']:
        return gaps
    plane = {c: i for i, c in enumerate(got['sky_chans'])}
    g_psf = t(got['psf'])
    beam = ref.fit_beam(g_psf, p['cell_rad'])
    stages = {k: [] for k in CHECKS if k not in ('flux_gap', 'psf_gap')}
    for k, c in enumerate(got['chans']):
        f = float(freqs[c])
        want = ref.visibilities(t(got['sky'][plane[c]])[None],
                                setup['sky_cell_rad'], p['uvw'], [f],
                                p['dish'])[0]
        clean, noisy = c128(got['clean'][k]), c128(got['noisy'][k])
        if clean.shape != want.shape or noisy.shape != want.shape:
            return gaps
        stages['vis_gap'].append(_gap(clean, want))
        # the rms of n draws of N(0, sigma) is sigma within
        # sigma / sqrt(2 n): the gap counts those standard errors
        noise = noisy - clean
        stages['noise_gap'].extend(
            abs(float(torch.sqrt(torch.mean(part ** 2))) / p['sigma'] - 1.0)
            * math.sqrt(2.0 * noise.shape[0])
            for part in (noise.real, noise.imag))
        dirty, psf = ref_cube.image_channel(p, noisy, f, setup['robust'])
        g_dirty, g_model, g_res = (planes(key, k) for key in
                                   ('dirty', 'model', 'residual'))
        if g_dirty is None or g_dirty.shape != dirty.shape:
            return gaps
        stages['dirty_gap'].append(_gap(g_dirty, dirty))
        if c == centre:
            gaps['psf_gap'] = _gap(g_psf, psf)
            psf = g_psf
        if any(a is None or a.shape != dirty.shape for a in (g_model, g_res)):
            # no CLEAN model or residual: those stages read inf
            stages['clean_gap'].append(math.inf)
            stages['restored_gap'].append(math.inf)
            continue
        model, res, _ = ref_cube.clean_channel(
            g_dirty, psf, p['mask'], setup['nsigma'], setup['gain'],
            setup['niter'])
        # an iteration more or less shows as one PSF's worth of residual
        stages['clean_gap'].append(
            max(_diff(g_model, model), _diff(g_res, res)) /
            float(torch.max(torch.abs(g_dirty))))
        stages['restored_gap'].append(_gap(
            got['restored'][k], ref.restore(g_model, g_res, beam,
                                            p['cell_rad'])))
    gaps.update((k, max(v)) for k, v in stages.items())
    return gaps


class Workload:
    unit = 'run'
    control_dtype = torch.float32      # below the chain's float64
    rt_control_dtype = torch.bfloat16  # below the RT run's float32

    def __init__(self, config: Dict, mix: Dict, seed: int, device: str):
        self.config, self.params = config, model_params(config)
        self.mix, self.device = mix, device
        self.setup_ref = reference_setup(config, mix)
        n_chan = len(self.setup_ref['chan_freqs'])
        self.chans = sample_channels(n_chan, int(mix['sample_channels']),
                                     seed)
        self.sample = Reservoir(mix['sample_runs'],
                                np.random.default_rng([seed, 1]))
        self.n = 0
        #: each request's advance of the program's observation counters
        #: (those the program keeps)
        self.deltas: List[Dict[str, int]] = []
        #: (image size, mask half-sizes, channels) of the cube's CLEAN
        self.cube_geometry = counts.geometry(
            ref.plan(self.setup_ref, torch.float64, 'cpu')) + (n_chan,)
        self.tmp = self.pipeline = None
        self.got: List[Dict] = []

    def setup(self) -> Dict:
        """Build and fill the model (the fill timed by CUDA events, ms),
        build the pipeline in a fresh directory, and warm with one run."""
        from rajepy_tpu_torch import JetModel, Pipeline
        log = quiet_log()
        jm = JetModel(model_params(self.params), log=log, device=self.device)
        fill_ms = device_ms(jm._ensure_fields, self.device)
        self.tmp = tempfile.mkdtemp(prefix='observe_cube_runs_')
        os.makedirs(os.path.join(self.tmp, 'sampled'))
        self.pipeline = Pipeline(
            jm, campaign(self.config, self.mix,
                         os.path.join(self.tmp, 'campaign')),
            log=log)
        self._run()
        return {'fill_ms': fill_ms}

    def _run(self) -> Dict[str, int]:
        from rajepy_tpu_torch.utils import profiling
        counters = getattr(profiling, 'COUNTERS', {})
        before = dict(counters)
        self.pipeline.execute_run(0, simobserve=True, plot=False,
                                  resume=False, clobber=True)
        return {k: counters[k] - before.get(k, 0) for k in COUNTERS
                if k in counters}

    def request(self) -> int:
        self.n += 1
        self.deltas.append(self._run())
        held = list(self.sample.items)
        item = {}
        self.sample.offer(item)
        for old in held:
            if not any(it is old for it in self.sample.items):
                shutil.rmtree(old['dcy'], ignore_errors=True)
        if any(it is item for it in self.sample.items):
            # the run's directory moves aside: no later run rewrites it
            run = self.pipeline.runs[0]
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
        self.got = [read_products(it['dcy'], it['files'], self.chans)
                    for it in self.sample.items]
        self.pipeline = None
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    def flux(self, chans=None, dtype=torch.float64) -> np.ndarray:
        """The reference jet's flux cube of the run in the FITS product's
        orientation (n_chan, nz, nx), on channels ``chans`` (all if
        None)."""
        s = self.setup_ref
        freqs = s['chan_freqs'] if chans is None else \
            s['chan_freqs'][np.asarray(chans)]
        _, _, flux = Jet(self.params).rrl(
            s['line'], [s['time'] * YEAR], freqs, False, dtype,
            self.device)[0]
        return np.ascontiguousarray(flux.transpose(0, 2, 1))

    def check(self) -> Dict[str, float]:
        """Each sampled run's stages against the reference; the largest
        gaps."""
        gaps: Dict[str, float] = {}
        flux = self.flux() if self.got else None
        for got in self.got:
            for k, v in compare(got, flux, self.setup_ref,
                                self.device).items():
                gaps[k] = max(gaps.get(k, 0.0), v)
        return gaps

    def control(self, dtype) -> Dict[str, float]:
        """The reference in the program's place on the seed's sampled
        channels: the jet in :attr:`rt_control_dtype` (below the RT run's
        float32), the observation chain in ``dtype`` (below its
        float64)."""
        s = self.setup_ref
        with ref.exact_matmul():
            p = ref.plan(s, dtype, self.device)
            sky = self.flux(self.chans, self.rt_control_dtype)
            out = ref_cube.observe(
                torch.as_tensor(sky, device=self.device).to(dtype),
                s['sky_cell_rad'], p,
                [float(f) for f in s['chan_freqs'][self.chans]],
                self.chans.index(len(s['chan_freqs']) // 2), s['seed'],
                s['niter'], s['nsigma'], s['gain'], s['robust'])
        got = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
               for k, v in out.items()}
        got.update(sky=sky, sky_chans=self.chans, chans=self.chans)
        return compare(got, self.flux(self.chans), s, self.device)
