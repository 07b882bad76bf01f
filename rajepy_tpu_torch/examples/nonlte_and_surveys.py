"""Non-LTE recombination lines and batched parameter surveys.

Two capabilities the reference RaJePy has no analogue for:

1. **Non-LTE RRLs from the params alone** — the reference ships the
   Gordon & Sorochenko non-LTE slab scaffolding but raises on
   ``lte=False`` (classes.py:1258-1262) because it has no
   departure-coefficient source.  Here ``ops.departure`` solves the
   case-B hydrogenic statistical-equilibrium problem once and bundles
   b_n(n, T_e, n_e); ``lte=False`` just works, with scalar coefficients
   at the jet's emission-weighted conditions or per-sightline maps.

2. **Batched parameter surveys** (``fit.sweep``) — a Cartesian grid of
   jet models evaluated one after another on the model's device (spread
   over a device mesh with ``mesh=``), where the reference's equivalent
   is a job array of full Python processes.

    python -m rajepy_tpu_torch.examples.nonlte_and_surveys

On the CPU (float64): ``main(device='cpu')``.
"""
import copy

import numpy as np

from rajepy_tpu_torch import JetModel, fit
from rajepy_tpu_torch.constants import YEAR
from rajepy_tpu_torch.examples import bundled_params
from rajepy_tpu_torch.ops import departure, rrls


def main(*, device='cuda', grid=(24, 60, 24)) -> dict:
    """The non-LTE lines and the survey on ``device``; returns the printed
    numbers."""
    params = bundled_params()
    p = copy.deepcopy(params)
    p['grid'].update(n_x=grid[0], n_y=grid[1], n_z=grid[2], l_z=None)
    jm = JetModel(p, device=device)
    jm.time = 2.0 * YEAR

    # --- 1. non-LTE H58a, no user-supplied coefficients ----------------- #
    nu0 = rrls.rrl_nu_0('H', 58, 1)
    freqs = np.linspace(nu0 - 2e6, nu0 + 2e6, 9)

    b1, b2 = jm.departure_coefficients('H58a')
    t_c, ne_c = jm.characteristic_conditions()
    print(f"jet EM-weighted conditions: T_e = {t_c:.0f} K, "
          f"n_e = {ne_c:.2e} cm^-3")
    print(f"auto departure coefficients: b_58 = {b1:.4f}, b_59 = {b2:.4f}")

    s_lte = np.nansum(jm.flux_rrl('H58a', freqs), axis=(1, 2))
    s_nl = np.nansum(jm.flux_rrl('H58a', freqs, lte=False), axis=(1, 2))
    print("line-centre flux: LTE {:.3e} Jy, non-LTE {:.3e} Jy "
          "(ratio {:.3f} — b_n2 > b_n1 drives stimulated amplification)"
          .format(s_lte[4], s_nl[4], s_nl[4] / s_lte[4]))

    # per-sightline coefficient maps (the slab composition's granularity)
    b1m, b2m = jm.departure_coefficient_maps('H58a')
    s_map = np.nansum(jm.flux_rrl('H58a', freqs, lte=False,
                                  departure_coeffs=(b1m, b2m)), axis=(1, 2))
    print(f"per-sightline maps: b_58 spans "
          f"[{b1m.min():.4f}, {b1m.max():.4f}]; line-centre flux "
          f"{s_map[4]:.3e} Jy")

    # the underlying solver is open: inspect b_n at any conditions
    b = departure.solve_bn(1e4, 1e6)
    b_58, b_100 = round(float(b[56]), 4), round(float(b[98]), 4)
    print("b_n(T=1e4 K, n_e=1e6): n=58 ->", b_58, " n=100 ->", b_100)

    # the table's collisional-rate systematic is quantified — the bundled
    # file carries x0.5/x2 rate-scaled edge solutions, and any non-LTE fit
    # with table-derived coefficients should propagate it
    # (fit.rrl_departure_systematic) on top of the statistical sigmas
    s1, s2 = departure.b_n_pair_systematic(58, 1, t_c, ne_c)
    print(f"rate-prescription systematic at the jet's conditions: "
          f"b_58 +- {s1:.1e}, b_59 +- {s2:.1e} "
          f"(JetModel.departure_coefficient_systematic('H58a'))")

    # --- 2. a 12-model survey, one forward per model ------------------- #
    sed_freqs = np.array([6e9, 2.2e10, 1e11, 3e11])
    grid_values = {'properties.mlr_bj': np.geomspace(5e-8, 4e-7, 4),
                   'properties.T_0': np.array([8e3, 1e4, 1.25e4])}
    res = fit.sweep(jm, sed_freqs, grid_values)
    print(f"\nsweep: {res.values.shape[0]} models x "
          f"{sed_freqs.size} channels in one program")
    cube = res.reshaped()          # (4 mlr, 3 T_0, n_chan)
    alpha = (np.log10(cube[..., 1] / cube[..., 0]) /
             np.log10(sed_freqs[1] / sed_freqs[0]))
    print("spectral index alpha(6->22 GHz) vs mlr (rows) x T_0 (cols):")
    print(np.array_str(alpha, precision=3))
    print("\nOK")
    return {'T_e': t_c, 'n_e': ne_c, 'b_58': b1, 'b_59': b2,
            'freqs': freqs, 's_lte': s_lte, 's_nonlte': s_nl,
            'ratio': s_nl[4] / s_lte[4], 'b1_map': b1m, 'b2_map': b2m,
            's_map': s_map, 'b_n': b, 'b_n58': b_58, 'b_n100': b_100,
            'systematic': (s1, s2), 'sed_freqs': sed_freqs,
            'sweep_grid': grid_values, 'sweep': res.values, 'alpha': alpha}


if __name__ == '__main__':
    main()
