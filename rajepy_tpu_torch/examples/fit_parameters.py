"""Differentiable parameter inference: recover jet physical parameters
from synthetic observations by exact-gradient optimisation.

The whole radiative-transfer forward model is differentiable in
``torch.autograd``, so ``rajepy_tpu_torch.fit`` can pose the inverse
problems the reference's forward-only CASA pipeline cannot:

1. fit mass-loss rate + temperature to an observed SED,
2. recover ejection-burst parameters (epoch, half-life, amplitude)
   from a flux light curve,
3. fit an RRL line profile: Doppler width -> temperature, centroid ->
   systemic velocity (through the Faddeeva function's autograd rule).

The fits run on the model's device at its precision (``'auto'``:
float32 on a GPU, float64 on the CPU).

    python -m rajepy_tpu_torch.examples.fit_parameters

On the CPU (float64), smaller and shorter:
``main(device='cpu', grid=(16, 16, 16), sed_steps=20, ...)``.
"""
import copy

import numpy as np

from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch import fit as jfit
from rajepy_tpu_torch.constants import YEAR
from rajepy_tpu_torch.examples import bundled_params
from rajepy_tpu_torch.ops import rrls as mrrl


def main(*, device='cuda', grid=(32, 32, 32), sed_steps=500,
         mala_steps=2000, mala_burn=400, chains=2, lc_steps=800,
         rrl_steps=700) -> dict:
    """The three fits on ``device``; returns the printed numbers and the
    fit results."""
    base = bundled_params()
    base['grid'].update(n_x=grid[0], n_y=grid[1], n_z=grid[2], l_z=None)

    # ------------------------------------------------------------------- #
    # 1. SED fit: synthesise an SED from 'true' parameters, start elsewhere
    # ------------------------------------------------------------------- #
    # include optically-thin channels: at tau >> 1 the SED is blackbody and
    # carries no density information (see fit module docstring)
    freqs = np.array([6e9, 4.4e10, 1e11, 3e11])

    true = copy.deepcopy(base)
    true['properties'].update(mlr_bj=2.5e-7, T_0=6000.0)
    jm_true = JetModel(true, device=device)
    jm_true.time = 2.0 * YEAR
    observed = np.nansum(jm_true.flux_ff(freqs), axis=(1, 2))

    jm_guess = JetModel(copy.deepcopy(base), device=device)  # 1e-7, 1e4
    jm_guess.time = 2.0 * YEAR
    free = ('properties.mlr_bj', 'properties.T_0')
    res = jfit.fit_sed(jm_guess, freqs, observed, free=free,
                       steps=sed_steps, learning_rate=0.05)
    fwd, _ = jfit.build_sed_forward(jm_guess, freqs, free)
    sig, _cov = jfit.laplace_uncertainties(fwd, res.theta, observed, free)
    print("SED fit:")
    print(f"  mlr_bj: {res.values['properties.mlr_bj']:.3e} "
          f"+- {sig['properties.mlr_bj']:.1e} (true 2.500e-07)")
    print(f"  T_0:    {res.values['properties.T_0']:.1f} "
          f"+- {sig['properties.T_0']:.1f} (true 6000.0)")
    print(f"  loss:   {res.loss[0]:.3e} -> {res.loss[-1]:.3e}")

    # Full posterior around the MAP (preconditioned MALA)
    post = jfit.sample_posterior(fwd, res.theta, observed, free, cov=_cov,
                                 steps=mala_steps, burn=mala_burn,
                                 chains=chains)
    mlr_q = np.percentile(post.samples['properties.mlr_bj'], [16, 50, 84])
    print(f"  posterior mlr_bj: {mlr_q[1]:.3e} "
          f"[+{mlr_q[2]-mlr_q[1]:.1e} / -{mlr_q[1]-mlr_q[0]:.1e}], "
          f"acceptance {post.acceptance:.2f}, "
          f"R-hat {post.r_hat['properties.mlr_bj']:.3f}")

    # ------------------------------------------------------------------- #
    # 2. Light curve: recover an ejection event from 12 epochs at 44 GHz
    # ------------------------------------------------------------------- #
    burst_true = copy.deepcopy(base)
    burst_true['ejection'] = {'t_0': np.array([1.2]), 'hl': np.array([0.4]),
                              'chi': np.array([4.0]),
                              'which': np.array(['B'])}
    jm_b = JetModel(burst_true, device=device)
    times = np.linspace(0.5, 4.0, 12) * YEAR
    lc = []
    for t in times:
        jm_b.time = t
        lc.append(np.nansum(jm_b.flux_ff(np.array([4.4e10])), axis=(1, 2)))
    lc = np.asarray(lc)

    guess = copy.deepcopy(base)
    guess['ejection'] = {'t_0': np.array([1.8]), 'hl': np.array([0.7]),
                         'chi': np.array([2.0]), 'which': np.array(['B'])}
    res_lc = jfit.fit_light_curve(JetModel(guess, device=device), times,
                                  np.array([4.4e10]), lc, steps=lc_steps,
                                  learning_rate=0.03)
    print("Light-curve fit (true: t_0=1.2 yr, hl=0.4 yr, chi=4.0):")
    print(f"  t_0: {res_lc.t_0[0]:.4f} yr")
    print(f"  hl:  {res_lc.hl[0]:.4f} yr")
    print(f"  chi: {res_lc.chi[0]:.4f}")

    # ------------------------------------------------------------------- #
    # 3. RRL line profile: temperature from the Doppler width, systemic
    #    velocity from the centroid (channels spanning the H58a line)
    # ------------------------------------------------------------------- #
    nu0 = mrrl.rrl_nu_0('H', 58, 1)
    chan = nu0 * (1.0 + np.linspace(-4e-4, 4e-4, 17))

    line_true = copy.deepcopy(base)
    line_true['properties']['T_0'] = 7000.0
    line_true['target']['v_lsr'] = 25.0            # receding at 25 km/s
    jm_l = JetModel(line_true, device=device)
    jm_l.time = 2.0 * YEAR
    spectrum = np.nansum(jm_l.flux_rrl('H58a', chan, contsub=True),
                         axis=(1, 2))

    jm_guess = JetModel(copy.deepcopy(base), device=device)  # 1e4, 6.2
    jm_guess.time = 2.0 * YEAR
    res_l = jfit.fit_rrl_spectrum(jm_guess, 'H58a', chan, spectrum,
                                  steps=rrl_steps, learning_rate=0.2)
    print("RRL line-profile fit (true: T_0=7000 K, v_lsr=25 km/s):")
    print(f"  T_0:   {res_l.values['properties.T_0']:.1f} K")
    print(f"  v_lsr: {res_l.values['target.v_lsr']:.3f} km/s")
    return {'sed_freqs': freqs, 'sed_observed': observed, 'sed': res,
            'sigma': sig, 'cov': _cov, 'posterior': post,
            'posterior_mlr_bj': mlr_q, 'lc_times': times, 'lc_observed': lc,
            'light_curve': res_lc, 'rrl_chans': chan,
            'rrl_observed': spectrum, 'rrl': res_l,
            'truth': {'properties.mlr_bj': 2.5e-7, 'properties.T_0': 6000.0,
                      't_0': 1.2, 'hl': 0.4, 'chi': 4.0,
                      'rrl.properties.T_0': 7000.0,
                      'rrl.target.v_lsr': 25.0}}


if __name__ == '__main__':
    main()
