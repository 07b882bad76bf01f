#!/usr/bin/env python3
"""Wide-field / long-baseline observing: the non-coplanar toolchain.

Demonstrates, on a VLBA-scale configuration where the coplanar
small-field approximation fails:

1. the a-priori w-term bound (`w_term_max_phase_error`) and automatic
   plane-count selection (`n_wplanes_for`);
2. w-stacked Kaiser-Bessel visibility sampling
   (`sample_vis_wstack` — what `simulate_observation` switches to on
   its own when the bound exceeds 0.1 rad), validated here against the
   exact w-term DFT;
3. fitting jet parameters directly to the wide-field visibilities
   through the same differentiable w-stacked forward
   (`fit_visibilities(..., w_planes=...)`).

    python -m rajepy_tpu_torch.examples.wide_field_vlbi

On the CPU (float64): ``main(device='cpu')``.
"""
import numpy as np
import torch

from rajepy_tpu_torch import JetModel, constants, fit
from rajepy_tpu_torch.examples import bundled_params, host
from rajepy_tpu_torch.synthobs import observatories, sampler, uvgen


def main(*, device='cuda', steps=150) -> dict:
    """The w-term toolchain on ``device``; returns the printed numbers."""
    # --- a VLBA uv track ------------------------------------------------ #
    ant = observatories.read_antenna_config(
        observatories.cfg_file('VLBA', '0'))
    bl, _ = uvgen.baselines(ant['xyz'])
    has = np.linspace(-2.0, 2.0, 16)
    uvw = uvgen.uvw_tracks(bl, has, dec_deg=30.0,
                           lon_deg=-100.0).reshape(-1, 3)
    freq = 5e9
    lam = 299792458.0 / freq

    # --- jet model + sky image ------------------------------------------ #
    params = bundled_params()
    params['grid'].update(n_x=24, n_y=48, n_z=24, l_z=None, c_size=2.0)
    # an (artificially) nearby target so the jet subtends arcseconds — the
    # field scale where VLBI baselines leave the coplanar regime
    params['target'] = dict(params['target'], dist=2.0)
    jm = JetModel(params, device=device)
    jm.time = 0.0
    flux = np.asarray(jm.flux_ff(np.array([freq])))[0]   # (nx, nz) Jy/px
    sky = torch.as_tensor(np.nan_to_num(flux).T, device=jm.device)
    cell_rad = float(np.arctan(params['grid']['c_size'] * constants.AU
                               / (params['target']['dist'] *
                                  constants.PARSEC)))

    # --- 1. how non-coplanar is this? ----------------------------------- #
    field_radius = 0.5 * max(sky.shape) * cell_rad
    bound = sampler.w_term_max_phase_error(uvw, freq, field_radius)
    n_pl = sampler.n_wplanes_for(uvw, freq, field_radius)
    print(f"w-term phase bound {bound:.2f} rad at the field edge "
          f"-> {n_pl} w-plane(s)")

    # --- 2. w-stacked sampling vs the exact measurement equation -------- #
    # (scale u, v onto the FFT grid while keeping the VLBI-scale w: the
    #  long-baseline worst case for the w term)
    uvw_demo = uvw.copy()
    uvw_demo[:, :2] *= 5e-4
    u, v, w = (uvw_demo[:, i] / lam for i in range(3))
    vis_exact = host(sampler.sample_vis_dft_w(sky, cell_rad, u, v, w))
    vis_cop = host(sampler.sample_vis_dft(sky, cell_rad, u, v))
    n_pl_demo = sampler.n_wplanes_for(uvw_demo, freq, field_radius)
    vis_wst = host(sampler.sample_vis_wstack(
        sky, cell_rad, u, v, w, n_wplanes=n_pl_demo))
    tot = float(torch.abs(sky).sum())
    err_cop = np.max(np.abs(vis_cop - vis_exact)) / tot
    err_wst = np.max(np.abs(vis_wst - vis_exact)) / tot
    print(f"coplanar error {err_cop:.2e} "
          f"of total flux; w-stacked ({n_pl_demo} planes) "
          f"{err_wst:.2e}")

    # --- 3. fit the mass-loss rate straight to the wide-field visibilities #
    freqs_fit = np.array([1e11, 3e11])    # optically-thin channels pin mlr
    true = {k: dict(v) if isinstance(v, dict) else v
            for k, v in params.items()}
    true['properties'] = dict(params['properties'], mlr_bj=2e-7)
    jm_true = JetModel(true, device=device)
    jm_true.time = 0.0
    fwd, th = fit.build_vis_forward(jm_true, freqs_fit, uvw_demo,
                                    ('properties.mlr_bj',),
                                    w_planes=n_pl_demo)
    vis_obs = host(fwd(th))
    res = fit.fit_visibilities(jm, freqs_fit, uvw_demo, vis_obs,
                               free=('properties.mlr_bj',), steps=steps,
                               learning_rate=0.05, w_planes=n_pl_demo)
    mlr_bj = res.values['properties.mlr_bj']
    print(f"recovered mlr_bj = {mlr_bj:.3e} (true 2.000e-07)")
    return {'uvw': uvw, 'bound': bound, 'n_wplanes': n_pl,
            'cell_rad': cell_rad, 'sky': host(sky), 'uvw_demo': uvw_demo,
            'vis_exact': vis_exact, 'vis_coplanar': vis_cop,
            'vis_wstack': vis_wst, 'n_wplanes_demo': n_pl_demo,
            'total_flux': tot, 'coplanar_error': err_cop,
            'wstack_error': err_wst, 'vis_obs': vis_obs, 'fit': res,
            'mlr_bj': mlr_bj, 'truth': 2e-7}


if __name__ == '__main__':
    main()
