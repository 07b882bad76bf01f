"""Antenna-based gain corruption and self-calibration (PyTorch port of
rajepy_tpu.synthobs.calibration).

The reference's synthetic observations corrupt with thermal noise only
(CASA simobserve, the reference's casa/tasks.py:196-206); real reductions
of such data additionally suffer — and then solve for — antenna-based
complex gain errors (tropospheric phase, electronic amplitude drifts).
This module supplies the missing half of that workflow, the analogue of
CASA's ``sm.setgain`` / ``gaincal(gaintype='G')`` / ``applycal``:

* :func:`simulate_gain_errors` — per-antenna complex gain tracks
  (amplitude and phase AR(1) random walks with a coherence time), host
  numpy, the JAX package's draws bit for bit;
* :func:`apply_gains` — corrupt (or, with ``invert=True``, correct)
  visibilities with per-time per-antenna gains;
* :func:`solve_gains` — StEFCal (Salvini & Wijnholds 2014, A&A 571 A97)
  antenna-gain solutions against a model visibility set, batched over
  solution intervals (and, for the bandpass, over channels): the working
  set is a dense (n_sol, n_ant, n_ant) stack of visibility matrices;
* :func:`correct_vis` — expand interval solutions to the time axis and
  apply their inverse (``applycal``);
* the closure quantities (bispectra, closure phases, log closure
  amplitudes), immune to antenna-based gains.

Visibilities and gains are complex tensors; a function runs on the device
of the visibilities it is given (numpy input runs on the CPU) and returns
tensors there.  Visibilities are shaped ``(..., n_vis)`` (leading channel
axes allowed) with per-visibility ``ant1``/``ant2``/``t_index`` integer
metadata, the flattening produced by :func:`simulate_observation`
(time-major, baseline-minor; :func:`vis_metadata`).
"""
from __future__ import annotations

from itertools import combinations
from typing import Optional, Tuple

import numpy as np
import torch

from . import sampler


def simulate_gain_errors(seed: int, n_t: int, n_ant: int,
                         amp_rms: float = 0.0,
                         phase_rms_deg: float = 0.0,
                         coherence_s: Optional[float] = None,
                         t_int_s: Optional[float] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-antenna complex gain error tracks (re, im), shape (n_t, n_ant)
    each.

    Phases (and fractional amplitude offsets) follow stationary AR(1)
    processes with marginal standard deviations ``phase_rms_deg`` /
    ``amp_rms``: when ``coherence_s`` and ``t_int_s`` are given the
    lag-1 correlation is ``exp(-t_int_s / coherence_s)`` (a discretised
    Ornstein-Uhlenbeck track — adjacent integrations share the same
    atmosphere); otherwise samples are independent per integration.

    Host numpy, as in the JAX package: the same seed gives the same
    tracks bit for bit in both packages.
    """
    rng = np.random.default_rng(seed)
    if coherence_s is not None and t_int_s is not None and coherence_s > 0:
        rho = float(np.exp(-float(t_int_s) / float(coherence_s)))
    else:
        rho = 0.0

    def ar1(rms):
        if rms == 0.0 or n_t == 0:
            return np.zeros((n_t, n_ant))
        x = np.empty((n_t, n_ant))
        x[0] = rng.standard_normal(n_ant)
        innov = np.sqrt(1.0 - rho ** 2)
        for t in range(1, n_t):
            x[t] = rho * x[t - 1] + innov * rng.standard_normal(n_ant)
        return x * rms

    phase = ar1(np.radians(phase_rms_deg))
    amp = 1.0 + ar1(amp_rms)
    return amp * np.cos(phase), amp * np.sin(phase)


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           device=device).to(torch.int64)


def apply_gains(vis, gains, ant1, ant2, t_index, invert: bool = False):
    """Corrupt (or correct) visibilities with per-time antenna gains.

    V'_ij(t) = g_i(t) conj(g_j(t)) V_ij(t); ``invert=True`` divides
    instead (``applycal``).  ``gains``: complex (n_t, n_ant), cast to the
    visibilities' dtype; ``vis``: complex (..., n_vis) broadcast over
    leading axes; ``ant1/ant2/t_index``: (n_vis,) int.
    """
    vis = torch.as_tensor(vis)
    g = torch.as_tensor(gains, device=vis.device).to(vis.dtype)
    a1, a2, ti = (_index(a, vis.device) for a in (ant1, ant2, t_index))
    f = g[ti, a1] * g[ti, a2].conj()
    return vis / f if invert else vis * f


def apply_bandpass(vis, gains, ant1, ant2, t_index, invert: bool = False):
    """Per-channel variant of :func:`apply_gains`: gains shaped
    (n_chan, n_t, n_ant) applied to (n_chan, n_vis) visibilities."""
    vis = torch.as_tensor(vis)
    g = torch.as_tensor(gains, device=vis.device).to(vis.dtype)
    a1, a2, ti = (_index(a, vis.device) for a in (ant1, ant2, t_index))
    f = g[:, ti, a1] * g[:, ti, a2].conj()
    return vis / f if invert else vis * f


def _stefcal(R, M, n_iter: int, phase_only: bool, ref_ant: int):
    """StEFCal ADI iterations on a batch of solution intervals.

    R, M: dense hermitian (..., n_ant, n_ant) observed / model visibility
    matrices with zero diagonals.  Returns the complex gains (..., n_ant)
    with R ~= diag(g) M diag(g)^H, phase-referenced to ``ref_ant``.  The
    loop queues its operations without reading anything back.
    """
    g = torch.ones(R.shape[:-1], dtype=R.dtype, device=R.device)
    Rc = R.conj().resolve_conj()
    for k in range(n_iter):
        # column j model: R_ij ~= z_ij conj(g_j) with z_ij = g_i M_ij;
        # least squares for g_j gives sum_i z_ij conj(R_ij) / sum |z_ij|^2
        z = g[..., :, None] * M
        num = (z * Rc).sum(-2)
        den = (z.abs() ** 2).sum(-2)
        pos = den > 0
        g_new = torch.where(pos, num / torch.where(pos, den, 1.0), g)
        if k % 2 == 1:
            # ADI averaging on odd steps (Salvini & Wijnholds alg. 2):
            # plain alternating updates oscillate between two fixed points
            g_new = 0.5 * (g_new + g)
        if phase_only:
            # project AFTER the average: averaging two unit phasors gives
            # |g| = cos(dphi/2) < 1, and the iterate (hence the returned
            # solution) must honour the |g| = 1 contract
            a = g_new.abs()
            g_new = torch.where(a > 0, g_new / torch.where(a > 0, a, 1.0),
                                g_new)
        g = g_new
    # reference-antenna phase convention: angle(g[ref_ant]) = 0
    ref = g[..., ref_ant:ref_ant + 1]
    a = ref.abs()
    ref_phase = torch.where(a > 0, ref / torch.where(a > 0, a, 1.0),
                            torch.ones_like(ref))
    return g * ref_phase.conj()


def _interval_matrices(vis, ant1, ant2, t_index, n_ant: int, n_sol: int,
                       n_t: int):
    """Interval-averaged hermitian visibility matrices, (B, n_sol, n_ant,
    n_ant), of (B, n_vis) complex visibilities.

    Each (interval, ant1, ant2) segment's mean is taken in a fixed order:
    the visibilities are stably sorted by segment, laid out one segment a
    row (zero-padded to the longest) and each row summed, so that two
    calls give the same bits on every device (a scatter-add sums in an
    order that changes from call to call on a GPU)."""
    dev = vis.device
    sol = (t_index * n_sol) // n_t
    flat = (sol * n_ant + ant1) * n_ant + ant2
    nseg = n_sol * n_ant * n_ant
    order = torch.argsort(flat, stable=True)
    keys = flat[order]
    counts = torch.bincount(keys, minlength=nseg)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(keys.numel(), device=dev) - start[keys]
    width = max(int(counts.max()), 1) if keys.numel() else 1
    dense = vis.new_zeros((vis.shape[0], nseg, width))
    dense[:, keys, pos] = vis[:, order]
    avg = dense.sum(-1) / torch.clamp(counts, min=1).to(vis.real.dtype)
    A = avg.view(-1, n_sol, n_ant, n_ant)
    return A + A.transpose(-1, -2).conj()


def solve_gains(vis, mdl, ant1, ant2, t_index, n_ant: int, n_t: int,
                n_sol: int = 1, mode: str = 'amp+phase', n_iter: int = 50,
                ref_ant: int = 0, per_channel: bool = False):
    """Antenna gain solutions against a model visibility set.

    Splits the time axis into ``n_sol`` equal solution intervals, averages
    observed and model visibilities per (interval, baseline) — and over
    any leading channel axes — into dense hermitian (n_ant, n_ant)
    matrices, and runs the StEFCal alternating solver on every interval
    at once.  ``mode='phase'`` constrains |g| = 1 (phase-only selfcal);
    ``mode='amp+phase'`` solves the full complex gain.

    ``per_channel=True`` is the bandpass solve (gaincal ``'B'``): no
    channel averaging — every channel gets its own gain solution,
    returned as (n_chan, n_sol, n_ant) and applicable with
    :func:`apply_bandpass` / :func:`correct_vis`.

    Returns complex gains (n_sol, n_ant) — or (n_chan, n_sol, n_ant) with
    ``per_channel`` — on the visibilities' device, phase-referenced so
    antenna ``ref_ant`` has zero phase per interval.
    """
    if mode not in ('phase', 'amp+phase'):
        raise ValueError(f"unknown mode {mode!r}")
    vis = torch.as_tensor(vis)
    if per_channel and vis.ndim != 2:
        raise ValueError("per_channel solve needs (n_chan, n_vis) "
                         "visibilities")
    mdl = torch.as_tensor(mdl).to(device=vis.device, dtype=vis.dtype)
    n_vis = vis.shape[-1]
    if per_channel:
        both = torch.cat((vis, mdl))
    else:
        # channel-average first (gaincal 'G' solves one gain per solint
        # from all channels in the spw); leading axes are channels
        both = torch.stack((vis.reshape(-1, n_vis).mean(0),
                            mdl.reshape(-1, n_vis).mean(0)))
    a1, a2, ti = (_index(a, vis.device) for a in (ant1, ant2, t_index))
    mats = _interval_matrices(both, a1, a2, ti, int(n_ant), int(n_sol),
                              int(n_t))
    n_b = mats.shape[0] // 2
    g = _stefcal(mats[:n_b], mats[n_b:], int(n_iter), mode == 'phase',
                 int(ref_ant))
    return g if per_channel else g[0]


def expand_solutions(gains, n_t: int):
    """Map (..., n_sol, n_ant) interval solutions onto the time axis
    (..., n_t, n_ant) with the same equal-interval rule as the solver."""
    gains = torch.as_tensor(gains)
    n_sol = gains.shape[-2]
    sol = (torch.arange(n_t, device=gains.device) * n_sol) // n_t
    return gains[..., sol, :]


def correct_vis(vis, gains_sol, ant1, ant2, t_index, n_t: int):
    """``applycal``: expand interval solutions to per-time gains and
    divide them out of the visibilities.  Dispatches on the solution
    shape: (n_sol, n_ant) applies one gain across all channels
    (gaincal 'G'); (n_chan, n_sol, n_ant) applies each channel its own
    solution (bandpass 'B')."""
    vis = torch.as_tensor(vis)
    g = expand_solutions(torch.as_tensor(gains_sol, device=vis.device),
                         n_t)
    fn = apply_bandpass if g.ndim == 3 else apply_gains
    return fn(vis, g, ant1, ant2, t_index, invert=True)


# --------------------------------------------------------------------------- #
# Closure quantities — gain-immune observables
# --------------------------------------------------------------------------- #
def baseline_index_table(n_ant: int) -> np.ndarray:
    """(n_ant, n_ant) lookup from an (i, j) antenna pair (i < j) to its
    row in the triu-ordered baseline list of :func:`uvgen.baselines`."""
    tab = np.full((n_ant, n_ant), -1, dtype=np.int32)
    i, j = np.triu_indices(n_ant, k=1)
    tab[i, j] = np.arange(i.size, dtype=np.int32)
    return tab


def closure_triangles(n_ant: int) -> np.ndarray:
    """All antenna triangles (i < j < k), shape (n_tri, 3).  The full
    set is redundant (rank n_bl - n_ant + 1) but loses no information
    and keeps the arrays static-shaped."""
    tri = np.asarray(list(combinations(range(n_ant), 3)), dtype=np.int32)
    return tri.reshape(-1, 3)   # shape (0, 3), not (0,), when n_ant < 3


def closure_quads(n_ant: int) -> np.ndarray:
    """All antenna quadrangles (i < j < k < l), shape (n_quad, 4), read
    as the canonical amplitude ratio |V_ij V_kl| / |V_ik V_jl|."""
    quad = np.asarray(list(combinations(range(n_ant), 4)), dtype=np.int32)
    return quad.reshape(-1, 4)  # shape (0, 4), not (0,), when n_ant < 4


def _gathers(n_ant: int, sets, pairs, device):
    tab = baseline_index_table(n_ant)
    sets = np.asarray(sets, dtype=np.int32)
    return tuple(torch.as_tensor(tab[sets[:, a], sets[:, b]],
                                 dtype=torch.int64, device=device)
                 for a, b in pairs)


_TRI_PAIRS = ((0, 1), (1, 2), (0, 2))
_QUAD_PAIRS = ((0, 1), (2, 3), (0, 2), (1, 3))


def closure_index_arrays(n_ant: int, device='cpu'):
    """Baseline-index gather tensors on ``device`` for the full
    triangle/quadrangle sets: ``{'tri': (ij, jk, ik), 'quad': (ij, kl,
    ik, jl)}`` — the shared indexing of the closure functions here and
    of the closure losses of a fit."""
    return {'tri': _gathers(n_ant, closure_triangles(n_ant), _TRI_PAIRS,
                            device),
            'quad': _gathers(n_ant, closure_quads(n_ant), _QUAD_PAIRS,
                             device)}


def bisp_core(v, bl_ij, bl_jk, bl_ik):
    """Bispectrum of complex visibilities (..., n_t, n_bl) over
    triangle gathers: B = V_ij V_jk conj(V_ik)."""
    return v[..., bl_ij] * v[..., bl_jk] * v[..., bl_ik].conj()


def logclamp_core(v, q_ij, q_kl, q_ik, q_jl, eps: float = 1e-30):
    """Log closure amplitudes of complex visibilities (..., n_t, n_bl)
    over quadrangle gathers: ln(|V_ij||V_kl| / |V_ik||V_jl|)."""
    a2 = v.real ** 2 + v.imag ** 2
    return 0.5 * (torch.log(a2[..., q_ij] + eps) +
                  torch.log(a2[..., q_kl] + eps) -
                  torch.log(a2[..., q_ik] + eps) -
                  torch.log(a2[..., q_jl] + eps))


def _per_time(vis, n_t: int) -> torch.Tensor:
    """(..., n_t * n_bl) visibilities as (..., n_t, n_bl)."""
    vis = torch.as_tensor(vis)
    return vis.reshape(vis.shape[:-1] + (n_t, -1))


def bispectrum(vis, n_ant: int, n_t: int, triangles=None):
    """Bispectra B = V_ij V_jk conj(V_ik) over antenna ``triangles``
    (default: all of them).

    ``vis``: complex (..., n_t * n_bl) in the time-major full-pair layout
    of :func:`simulate_observation`.  Returns complex (..., n_t, n_tri).
    Under antenna gains g the bispectrum picks up only the REAL factor
    |g_i g_j g_k|^2, so its phase — the closure phase — is immune to
    antenna-based phase corruption.
    """
    v = _per_time(vis, n_t)
    tri = closure_triangles(n_ant) if triangles is None else triangles
    return bisp_core(v, *_gathers(n_ant, tri, _TRI_PAIRS, v.device))


def closure_phases(vis, n_ant: int, n_t: int, triangles=None):
    """Closure phases [rad], (..., n_t, n_tri): the bispectrum phases —
    immune to antenna-based gain phases (VLBI's primary observable when
    phase calibration is impossible)."""
    return torch.angle(bispectrum(vis, n_ant, n_t, triangles))


def log_closure_amplitudes(vis, n_ant: int, n_t: int, quads=None):
    """Log closure amplitudes ln(|V_ij||V_kl| / |V_ik||V_jl|) over
    antenna ``quads`` (default: all of them), (..., n_t, n_quad): immune
    to antenna-based gain AMPLITUDES (each |g| enters numerator and
    denominator once)."""
    v = _per_time(vis, n_t)
    quad = closure_quads(n_ant) if quads is None else quads
    return logclamp_core(v, *_gathers(n_ant, quad, _QUAD_PAIRS, v.device))


def model_vis(image, cell_rad, u_wav, v_wav, w_wav=None,
              n_wplanes: int = 0):
    """Complex model visibilities of ``image`` (a real tensor) at (u, v)
    [wavelengths], on its device: the Kaiser-Bessel degridding forward
    model.

    When ``n_wplanes >= 1`` (and ``w_wav`` is given) the degrid routes
    through :func:`sampler.sample_vis_wstack` so selfcal model
    visibilities carry the SAME non-coplanar w phases as wide-field data
    sampled with w-stacking — a flat model against w-stacked data leaves
    a baseline-dependent phase mismatch no antenna-based gain solve can
    absorb."""
    image = torch.as_tensor(image)
    if n_wplanes >= 1 and w_wav is not None:
        return sampler.sample_vis_wstack(image, float(cell_rad), u_wav,
                                         v_wav, w_wav,
                                         n_wplanes=int(n_wplanes))
    return sampler.sample_vis(image, float(cell_rad), u_wav, v_wav)


def vis_metadata(n_t: int, pairs: np.ndarray):
    """Per-visibility (ant1, ant2, t_index) for the time-major,
    baseline-minor flattening used by :func:`simulate_observation`
    (``uvw = concat(per-scan tracks).reshape(-1, 3)``)."""
    n_bl = pairs.shape[0]
    ant1 = np.tile(pairs[:, 0], n_t)
    ant2 = np.tile(pairs[:, 1], n_t)
    t_index = np.repeat(np.arange(n_t), n_bl)
    return ant1, ant2, t_index
