"""Example pipeline parameter file for rajepy_tpu.

Defines the observational campaign: epochs, frequencies/lines, telescopes
and integration setup for the radiative-transfer + synthetic-observation
pipeline.  Schema-compatible with the reference RaJePy's
files/example-pipeline-params.py.

Use: pipeline = rajepy_tpu.Pipeline(jet_model, '/path/to/this/file')
"""
import os

import numpy as np

params = {
    'min_el': 20.,            # minimum observing elevation [deg]
    'dcys': {
        "model_dcy": os.sep.join([os.path.expanduser('~'),
                                  'rajepy_tpu_output']),
    },
    # Continuum observations
    'continuum': {
        'times': np.linspace(0., 5., 6),      # model epochs [yr]
        'freqs': np.array([6.]) * 1e9,        # centre frequencies [Hz]
        't_obs': np.array([59400]),           # on-source times [s]
        'tscps': np.array([('VLA', 'A')]),    # (telescope, configuration)
        't_ints': np.array([5]),              # integration times [s]
        'bws': np.array([.5e9]),              # bandwidths [Hz]
        'chanws': np.array([2.e8]),           # channel widths [Hz]
    },
    # Radio recombination line observations
    'rrls': {
        'times': np.array([]),                # model epochs [yr]
        'lines': np.array(['H58a']),          # lines (element + n + dn)
        't_obs': np.array([30000]),
        'tscps': np.array([('VLA', 'A')]),
        't_ints': np.array([60]),
        'bws': np.array([1e8]),
        'chanws': np.array([1e5]),
        # optional (beyond-reference): per-line non-LTE radiative
        # transfer — departure coefficients auto-derived from the
        # bundled case-B b_n table at the jet's conditions
        # 'lte': np.array([False]),
    },
}

# Optional synthetic-observation overrides, forwarded verbatim to
# rajepy_tpu.synthobs.simulate_observation — e.g. atmosphere-aware noise,
# tclean knobs, antenna gain corruption and self-calibration:
# params['synthobs'] = {
#     'thermalnoise': 'tsys-atm', 'user_pwv': 2.0,
#     'weighting': 'briggs', 'robust': 0.5, 'niter': 500,
#     'corruption': {'phase_rms_deg': 30., 'coherence_s': 600.},
#     'selfcal': 'phase', 'selfcal_solint_s': 300., 'selfcal_rounds': 2,
# }
