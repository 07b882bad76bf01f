"""Example model parameter file for rajepy_tpu.

Defines the physical jet model (geometry, power laws, base properties,
variable ejection).  Schema-compatible with the reference RaJePy's
files/example-model-params.py (same sections/keys/units); note that n_0 is
optional here — it is derived from mlr_bj.

Use: jet_model = rajepy_tpu.JetModel('/path/to/example-model-params.py')
"""
import numpy as np

params = {
    "target": {
        "name": "example",          # model/source name
        "ra": "04:31:34.07736",     # right ascension [HH:MM:SS.S]
        "dec": "+18:08:04.9020",    # declination [DD:MM:SS.S]
        "epoch": "J2000",           # coordinate epoch
        "dist": 120.,               # distance [pc]
        "v_lsr": 6.2,               # systemic LSR velocity [km/s]
        "M_star": 0.55,             # central mass [Msol]
        "R_1": 0.25,                # inner launch radius in the disc [au]
        "R_2": 2.5,                 # outer launch radius in the disc [au]
    },
    "grid": {
        "n_x": 50,                  # cells in x
        "n_y": 400,                 # cells in y (the line of sight)
        "n_z": 50,                  # cells in z
        "l_z": 2.,                  # plane-of-sky jet length [arcsec];
        #                             overrides n_x/n_y/n_z when not None
        "c_size": 0.5,              # cell size [au]
    },
    "geometry": {
        "epsilon": 7. / 9.,         # jet-width power-law index
        "opang": 25.,               # opening angle [deg]
        "w_0": 1.,                  # half-width at the base [au]
        "r_0": 1.,                  # launching radius [au]
        "inc": 90.,                 # inclination [deg]
        "pa": 0.,                   # blue-jet position angle [deg]
        "rotation": "CCW",          # rotation sense, "CCW" or "CW"
    },
    "power_laws": {
        "q_v": 0.,                  # velocity vs r
        "q_T": 0.,                  # temperature vs r
        "q_x": 0.,                  # ionisation fraction vs r
        "q^d_n": 0.,                # density vs launch radius (disc wind)
        "q^d_T": 0.,                # temperature vs launch radius
        "q^d_v": 0.,                # velocity vs launch radius
        "q^d_x": 0.,                # ionisation vs launch radius
    },
    "properties": {
        "v_0": 150.,                # base velocity [km/s]
        "x_0": 0.1,                 # base ionisation fraction
        "T_0": 1e4,                 # base temperature [K]
        "mu": 1.3,                  # mean atomic weight [u]
        "mlr_bj": 1e-7,             # blue-jet steady MLR [Msol/yr]
        "mlr_rj": 5e-8,             # red-jet steady MLR [Msol/yr]
    },
    "ejection": {
        "t_0": np.array([0.5, 0.75, 1., 2.]),     # burst peak times [yr]
        "hl": np.array([0.15, 0.15, 0.45, 0.5]),  # burst half-lives [yr]
        "chi": np.array([5., 5., 2.5, 10.]),      # burst factors
        "which": np.array(["R", "B", "B", "RB"]),  # target jet(s)
    },
}
