"""Standard-format interchange: UVFITS export, import and file-based
inference.

The reference's synthetic observations live in CASA measurement sets
that any radio package can reprocess.  This package's native path keeps
visibilities in ``.vis.npz`` sets — and, with ``export_uvfits=True``,
ALSO as random-groups UVFITS files (AIPS AN antenna table included) that
real CASA (``importuvfits``), AIPS and difmap open directly.  This
example:

1. runs a quick VLA-B continuum observation with UVFITS export on,
2. reads the exported file back (``synthobs.uvfits.read_uvfits``) and
   summarises it the way a downstream package would see it,
3. fits the jet mass-loss rate STRAIGHT off the file
   (``fit.fit_uvfits`` — the path real observed data would take into
   this package's differentiable inference).

    python -m rajepy_tpu_torch.examples.uvfits_interchange

On the CPU (float64): ``main(device='cpu')``.
"""
import copy
import os
import tempfile

import numpy as np

from rajepy_tpu_torch import JetModel, Pipeline
from rajepy_tpu_torch import fit as jfit
from rajepy_tpu_torch.examples import bundled_params
from rajepy_tpu_torch.synthobs import uvfits


def main(*, device='cuda', out=None, steps=120) -> dict:
    """Export, read back and fit on ``device``, the files under ``out`` (a
    new temporary directory by default); returns the printed numbers."""
    params = copy.deepcopy(bundled_params())
    params['grid'].update(n_x=16, n_y=40, n_z=16, l_z=None)

    td = tempfile.mkdtemp(prefix='uvfits_example_') if out is None else out
    pipeline_params = {
        'min_el': 20.,
        'dcys': {'model_dcy': os.path.join(td, 'run')},
        'continuum': {'times': np.array([0.]), 'freqs': np.array([2.2e10]),
                      't_obs': np.array([1200]),
                      'tscps': np.array([('VLA', 'B')]),
                      't_ints': np.array([60]), 'bws': np.array([1e8]),
                      'chanws': np.array([5e7])},
        'rrls': {'times': np.array([]), 'lines': None, 't_obs': None,
                 'tscps': None, 't_ints': None, 'bws': None, 'chanws': None},
        # forwarded to every simulate_observation call: write UVFITS copies
        # of the visibility sets; skip CLEAN (we only want the data here)
        'synthobs': {'export_uvfits': True, 'niter': 0},
    }

    print("== 1. simulate with UVFITS export ==")
    pline = Pipeline(JetModel(copy.deepcopy(params), device=device),
                     pipeline_params)
    pline.execute(simobserve=True, verbose=False, resume=False, clobber=True,
                  plot=False)
    run = pline.runs[0]
    print("products:")
    for key in ('ms_noisy', 'uvfits_clean', 'uvfits_noisy'):
        print(f"  {key}: {os.path.basename(run.products[key])}")

    print("\n== 2. read the standard file back ==")
    obs = uvfits.read_uvfits(run.products['uvfits_noisy'])
    n_chan, n_vis = obs['vis_re'].shape
    uv = np.hypot(*obs['uvw'][:, :2].T)
    print(f"source {obs['source']!r} at RA {obs['ra_deg']:.3f} "
          f"DEC {obs['dec_deg']:+.3f} deg")
    print(f"{n_vis} visibilities x {n_chan} channels "
          f"({obs['freqs'][0] / 1e9:.2f}-{obs['freqs'][-1] / 1e9:.2f} GHz), "
          f"{len(obs['ant_names'])} antennas "
          f"({', '.join(obs['ant_names'][:4])}, ...)")
    print(f"|uv| range {uv.min():.0f}-{uv.max():.0f} m; "
          f"weights {obs['weights'].min():.3g}-{obs['weights'].max():.3g} "
          "(1/sigma^2)")

    print("\n== 3. fit the mass-loss rate straight off the file ==")
    jm = JetModel(copy.deepcopy(params), device=device)
    jm.time = 0.0
    res = jfit.fit_uvfits(jm, run.products['uvfits_noisy'],
                          free=('properties.mlr_bj',), steps=steps,
                          learning_rate=0.05)
    truth = params['properties']['mlr_bj']
    fitted = res.values['properties.mlr_bj']
    print(f"mlr_bj: fitted {fitted:.4g}  truth {truth:.4g}  "
          f"({100 * (fitted / truth - 1):+.2f}%)")
    print(f"chi-squared/vis: {res.loss[0]:.3f} -> {res.loss[-1]:.3f} "
          "(2.0 = thermal-noise floor)")
    return {'out': td, 'products': dict(run.products), 'obs': obs,
            'n_vis': n_vis, 'n_chan': n_chan,
            'n_ant': len(obs['ant_names']), 'uv_min': uv.min(),
            'uv_max': uv.max(), 'fit': res, 'fitted': fitted,
            'truth': truth, 'chi2_first': res.loss[0],
            'chi2_last': res.loss[-1]}


if __name__ == '__main__':
    main()
