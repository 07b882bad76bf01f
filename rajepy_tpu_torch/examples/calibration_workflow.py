"""Gain errors, self-calibration and closure-quantity fitting.

The reference's CASA boundary corrupts synthetic observations with
thermal noise only; this example walks the full calibration story
rajepy_tpu_torch adds on top (``synthobs.calibration``):

1. observe a jet model with antenna-based gain corruption
   (AR(1) phase/amplitude tracks — CASA ``sm.setgain``'s role),
2. recover the image dynamic range by iterative self-calibration
   (StEFCal solves + applycal inside ``simulate_observation``),
3. inspect the solutions and data with ``uv_plot`` (skipped, with a
   printed line, where matplotlib cannot be imported),
4. fit jet parameters DIRECTLY to closure observables of the
   uncalibrated visibilities (``fit.fit_closures``) — the VLBI
   workflow for data whose gains cannot be solved at all.

Visibilities are complex tensors on the model's device.

    python -m rajepy_tpu_torch.examples.calibration_workflow

On the CPU (float64): ``main(device='cpu')``.
"""
import copy
import os
import tempfile

import numpy as np

from rajepy_tpu_torch import JetModel, Pipeline
from rajepy_tpu_torch import fit as jfit
from rajepy_tpu_torch.examples import bundled_params, host
from rajepy_tpu_torch.synthobs import calibration as cal, simulate_observation


def main(*, device='cuda', out=None, closure_steps=300) -> dict:
    """The calibration story on ``device``, its files under ``out`` (a new
    temporary directory by default); returns the printed numbers."""
    if out is None:
        out = tempfile.mkdtemp(prefix='rajepy_cal_')
    params = bundled_params()
    params['grid'].update(n_x=16, n_y=40, n_z=16, l_z=None)

    pparams = {
        'min_el': 20.,
        'dcys': {'model_dcy': os.path.join(out, 'pipeline')},
        'continuum': {'times': np.array([0.]), 'freqs': np.array([2.2e10]),
                      't_obs': np.array([3600]),
                      'tscps': np.array([('VLA', 'B')]),
                      't_ints': np.array([60]), 'bws': np.array([1e8]),
                      'chanws': np.array([5e7])},
        'rrls': {'times': np.array([]), 'lines': None, 't_obs': None,
                 'tscps': None, 't_ints': None, 'bws': None, 'chanws': None},
    }

    jm = JetModel(params, device=device)
    pline = Pipeline(jm, pparams)
    pline.execute(simobserve=False, verbose=False, resume=False,
                  clobber=True, plot=False)
    run = pline.runs[0]

    # ---- 1 + 2: corrupt, then self-calibrate -------------------------- #
    products = simulate_observation(
        pline, run,
        corruption={'amp_rms': 0.15, 'phase_rms_deg': 50.,
                    'coherence_s': 1800., 'seed': 42},
        selfcal='amp+phase', selfcal_solint_s=600., selfcal_rounds=2)
    sc = run.results['selfcal']
    print(f"selfcal ({sc['rounds']} rounds, {sc['n_sol']} solints): "
          f"dynamic range {sc['dynamic_range_before']:.1f} -> "
          + ' -> '.join(f"{d:.1f}" for d in sc['dynamic_range_rounds']))

    # ---- 3: diagnostics ------------------------------------------------ #
    figure = os.path.join(out, 'uv_diagnostics.png')
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        figure = None
        print("matplotlib cannot be imported: uv_diagnostics.png skipped")
    else:
        from rajepy_tpu_torch.plotting import functions as pfunc
        pfunc.uv_plot(products['ms_selfcal'], savefig=figure)
        print("wrote", figure)

    # ---- 4: closure-quantity fitting of uncalibrated data -------------- #
    # synthesise uncalibrated visibilities of a 'true' jet and recover its
    # mass-loss rate from closure phases + log closure amplitudes alone
    p = copy.deepcopy(params)
    p['grid'].update(n_x=16, n_y=16, n_z=16)
    rng = np.random.default_rng(3)
    n_ant, n_t = 8, 6
    pairs = np.stack(np.triu_indices(n_ant, k=1), axis=1)
    a1, a2, tix = cal.vis_metadata(n_t, pairs)
    uvw = rng.normal(0, 2e4, (n_t * pairs.shape[0], 3))
    freqs = np.array([5e9, 2.2e10])

    true = copy.deepcopy(p)
    true['properties'].update(mlr_bj=2e-7)
    jm_t = JetModel(true, device=device)
    jm_t.time = 0.0
    fwd, th = jfit.build_vis_forward(jm_t, freqs, uvw,
                                     ('properties.mlr_bj',))
    vis = fwd(th).detach()
    g_re, g_im = cal.simulate_gain_errors(7, n_t, n_ant, amp_rms=0.3,
                                          phase_rms_deg=80.0)
    vis_corr = host(cal.apply_gains(vis, g_re + 1j * g_im, a1, a2, tix))

    jm_fit = JetModel(p, device=device)
    jm_fit.time = 0.0
    res = jfit.fit_closures(jm_fit, freqs, uvw, vis_corr, n_ant=n_ant,
                            n_t=n_t, free=('properties.mlr_bj',),
                            steps=closure_steps)
    mlr_bj = res.values['properties.mlr_bj']
    print(f"closure fit under 80-deg gain errors: mlr_bj = "
          f"{mlr_bj:.4e} (truth 2e-07)")
    return {'out': out, 'selfcal': sc,
            'dynamic_range_before': sc['dynamic_range_before'],
            'dynamic_range_rounds': list(sc['dynamic_range_rounds']),
            'products': products, 'figure': figure, 'uvw': uvw,
            'freqs': freqs, 'vis': host(vis), 'gains': g_re + 1j * g_im,
            'vis_corr': vis_corr, 'closure': res, 'mlr_bj': mlr_bj,
            'truth': 2e-7}


if __name__ == '__main__':
    main()
