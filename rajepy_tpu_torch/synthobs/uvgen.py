"""uv-coverage generation: antenna positions + hour-angle windows -> uvw.

This is the geometry half of the CASA ``simobserve`` replacement (reference
classes.py:2490-2608 drives the external binary; here the baseline tracks
are computed directly from the bundled ITRF antenna positions).

Conventions (Thompson, Moran & Swenson eq. 4.1): for a baseline vector
(Lx, Ly, Lz) in the equatorial frame whose X axis pierces the local
meridian, target hour angle H and declination delta,

    u =  sin H * Lx + cos H * Ly
    v = -sin d cos H * Lx + sin d sin H * Ly + cos d * Lz
    w =  cos d cos H * Lx - cos d sin H * Ly + sin d * Lz

ECEF (ITRF) baselines have X through Greenwich, so the local-meridian frame
is reached by using the Greenwich hour angle H_G = H - longitude_east.

A copy of rajepy_tpu.synthobs.uvgen, which holds no JAX.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def baselines(xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All antenna pairs: returns ((n_bl, 3) baseline vectors [m],
    (n_bl, 2) antenna index pairs)."""
    n = xyz.shape[0]
    i, j = np.triu_indices(n, k=1)
    return xyz[j] - xyz[i], np.stack([i, j], axis=1)


def uvw_tracks(bl_ecef: np.ndarray, ha_hours: np.ndarray, dec_deg: float,
               lon_deg: float) -> np.ndarray:
    """uvw [m] for every (baseline, hour angle): shape (n_t, n_bl, 3).

    ``ha_hours`` are the target's local hour angles at the array.
    """
    h = np.radians((np.asarray(ha_hours) * 15.0) - lon_deg)[:, None]
    d = np.radians(dec_deg)
    lx, ly, lz = bl_ecef[None, :, 0], bl_ecef[None, :, 1], bl_ecef[None, :, 2]
    sh, ch = np.sin(h), np.cos(h)
    sd, cd = np.sin(d), np.cos(d)
    u = sh * lx + ch * ly
    v = -sd * ch * lx + sd * sh * ly + cd * lz
    w = cd * ch * lx - cd * sh * ly + sd * lz
    return np.stack([u, v, w], axis=-1)


def scan_hour_angles(ha_centre_hours: float, duration_s: float,
                     t_int_s: float, max_samples: int = 4096) -> np.ndarray:
    """Integration-centre hour angles for one scan of ``duration_s`` centred
    on ``ha_centre_hours``.  When duration/t_int exceeds ``max_samples``
    the cadence is decimated (uv-coverage morphology is preserved; noise
    scaling accounts for the true integration time elsewhere)."""
    n = max(1, int(round(duration_s / t_int_s)))
    n = min(n, max_samples)
    dt = duration_s / n
    offsets = (np.arange(n) - (n - 1) / 2.0) * dt
    # sidereal rate: 1.0027379 rotations of HA per solar day
    return ha_centre_hours + offsets / 3600.0 * 1.0027379093


def elevation_track(ha_hours: np.ndarray, dec_deg: float,
                    lat_deg: float) -> np.ndarray:
    """Elevation [deg] of the target at each hour angle."""
    h = np.radians(np.asarray(ha_hours) * 15.0)
    d = np.radians(dec_deg)
    phi = np.radians(lat_deg)
    sin_el = np.sin(phi) * np.sin(d) + np.cos(phi) * np.cos(d) * np.cos(h)
    return np.degrees(np.arcsin(np.clip(sin_el, -1.0, 1.0)))


def plan_scans(t_obs: float, time_up: float, ew_int: bool,
               ew_split_final_n: int = 8) -> Dict[str, np.ndarray]:
    """Split the total on-source time into per-'day' scans exactly as the
    reference does (classes.py:2546-2586): full days of ``time_up`` seconds
    plus a remainder; for east-west interferometers the final day is split
    into ``ew_split_final_n`` scans spread across the full hour-angle
    window to fill the aperture.

    Returns {'durations': seconds per scan, 'ha_centres': hours per scan}.
    """
    t_obs = float(t_obs)
    time_up = float(time_up)
    durations = [time_up] * int(t_obs // time_up)
    durations += [t_obs - (t_obs // time_up) * time_up]
    # NB deliberate deviation: the reference keeps a zero-second
    # remainder (classes.py:2549-2550) and, for EW arrays, splits THAT
    # into 8 zero-length scans while the full days all sit at HA 0.
    # Dropping the empty entry first means an exact-multiple t_obs
    # spreads the final FULL day across the HA window instead — the same
    # uv coverage (contiguous scans spanning the same window) without
    # zero-duration scans downstream (PARITY.md "deliberate deviations").
    durations = [d for d in durations if d > 0]
    ha_centres = [0.0] * len(durations)

    if ew_int and durations:
        final_t_obs = durations.pop(-1)
        ha_centres.pop(-1)
        total_gap = time_up - final_t_obs
        t_gap = 0 if ew_split_final_n <= 1 else \
            int(total_gap / (ew_split_final_n - 1))
        # float division, unlike the reference's int() (classes.py:2581):
        # a remainder below ew_split_final_n seconds would truncate to
        # eight zero-length scans and silently drop the observing time
        t_scan = final_t_obs / ew_split_final_n
        for n in range(1, ew_split_final_n + 1):
            ha = -time_up / 2 + t_scan / 2 + (t_gap + t_scan) * (n - 1)
            ha_centres.append(ha / 3600.0)
            durations.append(float(t_scan))

    return {'durations': np.asarray(durations, dtype=float),
            'ha_centres': np.asarray(ha_centres, dtype=float)}
