#!/usr/bin/env python3
"""Production single-card run: 512^3 float32 model, multi-frequency SED,
spectral-index/turnover maps, RRL cube, multi-epoch light curve.

On an NVIDIA GPU the free-free maps of ``analysis.sed``,
``spectral_index_map``, ``turnover_map`` and each of the light curve's 25
epochs come from the single-base epoch tile kernel
(``csrc/epoch_maps.cu``), and the 128-channel H58a optical-depth cube from
the RRL tile kernel (``csrc/rrl_maps.cu``).  The first call of a process
that launches a kernel builds every kernel of ``csrc/`` (one ``nvcc`` per
source, cached under ``rajepy_tpu_torch/_build/``).  Float32 selects the
fast Faddeeva path of the RRL kernel.

    python -m rajepy_tpu_torch.examples.single_chip_production

On the CPU (the kernels' plain versions), at a smaller grid:
``main(device='cpu', grid=(32, 32, 32))``.
"""
import time

import numpy as np
import torch

from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.examples import bundled_params
from rajepy_tpu_torch.models import analysis
from rajepy_tpu_torch.ops.radtrans import RRLCoeffs


def main(*, device='cuda', grid=(512, 512, 512)) -> dict:
    """The production run on ``device``; returns its printed numbers, the
    model and its products."""
    params = bundled_params()
    params['grid'].update(n_x=grid[0], n_y=grid[1], n_z=grid[2], l_z=None,
                          c_size=0.25)
    times = {}

    t0 = time.perf_counter()
    jm = JetModel(params, dtype=torch.float32, device=device)
    jm._ensure_fields()
    if jm.device.type == 'cuda':
        torch.cuda.synchronize()
    times['fill'] = time.perf_counter() - t0
    print(f"grid fill (fields + travel times): {times['fill']:.1f}s")

    # 0.3-300 GHz SED + derived maps (BASELINE config 4)
    freqs = np.logspace(np.log10(3e8), np.log10(3e11), 24).astype(np.float32)
    t0 = time.perf_counter()
    seds = analysis.sed(jm, freqs)
    alpha = analysis.spectral_index_map(jm, 5e9, 1.5e10, min_flux_jy=1e-12)
    nu_turn = analysis.turnover_map(jm, freqs)
    times['sed_maps'] = time.perf_counter() - t0
    print(f"SED + index + turnover maps: {times['sed_maps']:.1f}s")
    print("  S(1.5GHz, 44GHz) =", seds[8], seds[18], "Jy")

    # H58a RRL cube (BASELINE config 3) through the RRL tile kernel
    nu0 = RRLCoeffs('H58a').nu0
    chans = np.linspace(nu0 - 5e6, nu0 + 5e6, 128)
    t0 = time.perf_counter()
    tau_cube = jm.optical_depth_rrl('H58a', chans)
    times['rrl_cube'] = time.perf_counter() - t0
    print(f"H58a 128-channel cube: {times['rrl_cube']:.1f}s "
          f"(shape {tau_cube.shape})")

    # multi-epoch light curve (BASELINE config 2)
    lc_years = np.linspace(0., 3., 25)
    lc_freqs = [6e9, 2.2e10]
    t0 = time.perf_counter()
    lc = analysis.light_curve(jm, lc_years, lc_freqs)
    times['light_curve'] = time.perf_counter() - t0
    print(f"25-epoch light curve: {times['light_curve']:.1f}s; "
          f"6GHz range {lc[:,0].min():.3e} - {lc[:,0].max():.3e} Jy")

    # conservation diagnostics (mass / angular momentum per r-slice, any
    # inclination) and the three-projection occupancy maps — the device-side
    # reductions behind plotting.diagnostic_plot / geometry_plot
    t0 = time.perf_counter()
    prof = jm.conservation_profiles()
    proj = jm.occupancy_projections()
    times['diagnostics'] = time.perf_counter() - t0
    total_mass = prof['mass'].sum()
    n_rbins = int((prof['mass'] > 0).sum())
    print(f"conservation + occupancy diagnostics: "
          f"{times['diagnostics']:.1f}s; total jet mass "
          f"{total_mass:.3e} kg over {n_rbins} r-bins")
    return {'model': jm, 'times': times, 'freqs': freqs, 'sed': seds,
            'S_1.5GHz': seds[8], 'S_44GHz': seds[18], 'alpha': alpha,
            'turnover': nu_turn, 'chans': chans, 'tau_cube': tau_cube,
            'lc_years': lc_years, 'lc_freqs': lc_freqs, 'light_curve': lc,
            'lc_6GHz_min': lc[:, 0].min(), 'lc_6GHz_max': lc[:, 0].max(),
            'profiles': prof, 'projections': proj, 'total_mass': total_mass,
            'n_rbins': n_rbins}


if __name__ == '__main__':
    main()
