"""Uncertainties at a fit optimum: Gauss-Newton (Laplace) sigmas from the
exact residual Jacobian, and posterior sampling by preconditioned MALA
(the JAX package's ``fit/__init__.py:381-636``).

The Jacobian is built in forward mode (``torch.autograd.forward_ad``), one
product per free parameter: the residual may have n_chan * nx * nz rows
and p is a handful, so p forward products cost far less than one backward
pass per row.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import forward_ad

from ._params import SUPPORTED_FREE, _grad


def _theta64(theta) -> torch.Tensor:
    """``theta`` as a float64 tensor, detached (numpy lands on the CPU:
    the callers move it to the residual's device)."""
    if isinstance(theta, torch.Tensor):
        return theta.detach().to(torch.float64)
    return torch.as_tensor(np.asarray(theta, np.float64))


def _jacobian(fn, theta) -> torch.Tensor:
    """d fn / d theta, (n, p), by p forward-mode products."""
    cols = []
    with forward_ad.dual_level():
        for i in range(theta.shape[0]):
            tangent = torch.zeros_like(theta)
            tangent[i] = 1.0
            out = forward_ad.unpack_dual(
                fn(forward_ad.make_dual(theta, tangent)))
            cols.append(out.tangent if out.tangent is not None
                        else torch.zeros_like(out.primal))
    return torch.stack(cols, dim=1)


def _resid_fn(forward, observed, errors):
    """``resid(theta) -> 1-D residuals`` of :func:`laplace_uncertainties`
    and :func:`sample_posterior`: log-flux residuals, or whitened ones
    with ``errors``."""
    obs = torch.as_tensor(np.asarray(observed, float).ravel())
    if errors is None:
        log_obs = torch.log(obs)

        def resid(th):
            m = torch.ravel(forward(th))
            return torch.log(m) - log_obs.to(m.device)
    else:
        err = torch.as_tensor(np.asarray(errors, float).ravel())

        def resid(th):
            m = torch.ravel(forward(th))
            return (m - obs.to(m.device)) / err.to(m.device)
    return resid


def laplace_uncertainties(forward, theta, observed, free: Sequence[str],
                          errors=None) -> Tuple[Dict[str, float],
                                                np.ndarray]:
    """Gauss-Newton 1-sigma uncertainties at a fit optimum.

    ``(sigmas, cov)`` where ``sigmas[path]`` is the 1-sigma uncertainty
    of the fitted *value* (delta method for log-space parameters) and
    ``cov`` the covariance in optimisation (theta) space.

    With ``errors`` the residuals are the absolute chi-squared ones; with
    ``errors=None`` they are log-flux residuals and the noise scale is
    estimated from the residual variance s^2 = RSS/(n-p) (the
    scipy.optimize.curve_fit ``absolute_sigma=False`` convention).
    Covariance is s^2 (J^T J)^-1 with the exact residual Jacobian.
    """
    return _gauss_newton_sigmas(_resid_fn(forward, observed, errors),
                                theta, free, estimate_scale=errors is None)


def _gauss_newton_sigmas(resid, theta, free: Sequence[str],
                         estimate_scale: bool = True
                         ) -> Tuple[Dict[str, float], np.ndarray]:
    """Gauss-Newton ``(sigmas, cov)`` from a residual function
    ``resid(theta) -> 1-D residuals``.  With ``estimate_scale`` the noise
    scale is s^2 = RSS/(n - p) (curve_fit's ``absolute_sigma=False``);
    otherwise the residuals are taken as whitened."""
    theta = _theta64(theta)
    with torch.no_grad():
        r = resid(theta)
    theta = theta.to(r.device)
    J = _jacobian(resid, theta).cpu().numpy()          # (n, p)
    r = r.cpu().numpy()
    n, p = J.shape
    jtj = J.T @ J
    cov = np.linalg.pinv(jtj)
    if estimate_scale:
        cov = cov * (float(r @ r) / max(n - p, 1))
    theta = theta.cpu().numpy()
    sigmas = {}
    for i, path in enumerate(free):
        s_theta = float(np.sqrt(max(cov[i, i], 0.0)))
        if SUPPORTED_FREE[path] == 'log':
            sigmas[path] = float(np.exp(theta[i])) * s_theta  # delta method
        else:
            sigmas[path] = s_theta
    return sigmas, cov


class PosteriorResult(NamedTuple):
    """MCMC posterior samples over the freed parameters."""
    samples: Dict[str, np.ndarray]   # per-path samples in VALUE space
    theta_samples: np.ndarray        # (n_chains, n_kept, p) in opt space
    acceptance: float                # MH acceptance fraction
    r_hat: Dict[str, float]          # split-R-hat convergence per path


def _split_r_hat(chains_2d: np.ndarray) -> float:
    """Gelman split-R-hat for one parameter: (n_chains, n_samples)."""
    m, n = chains_2d.shape
    half = n // 2
    split = chains_2d[:, :2 * half].reshape(2 * m, half)
    means = split.mean(axis=1)
    b = half * means.var(ddof=1)
    w = split.var(axis=1, ddof=1).mean()
    if w <= 0:
        return 1.0
    var_plus = (half - 1) / half * w + b / half
    return float(np.sqrt(var_plus / w))


def sample_posterior(forward, theta0, observed, free: Sequence[str], *,
                     errors=None, cov=None, steps: int = 3000,
                     burn: int = 500, step_scale: float = 0.6,
                     seed: int = 0, chains: int = 2) -> PosteriorResult:
    """Posterior sampling by preconditioned MALA (Metropolis-adjusted
    Langevin) with exact gradients — full posteriors where
    :func:`laplace_uncertainties` gives only the Gaussian approximation.

    The target is the Gaussian likelihood of the fit residuals with flat
    priors in the transformed (log/linear) parameter space; with
    ``errors=None`` the log-flux noise scale is estimated once at
    ``theta0`` (s^2 = RSS/(n-p)) and held fixed.  ``cov`` (e.g. the
    Laplace covariance) preconditions the proposal.  ``step_scale``
    ~0.5-1 targets the MALA-optimal ~0.57 acceptance in low dimensions.

    ``chains`` independent chains run one after another from 2-sigma
    over-dispersed starts, drawing from one ``torch.Generator`` seeded
    with ``seed`` on the forward's device; ``r_hat`` reports the Gelman
    split-R-hat per parameter.
    """
    resid = _resid_fn(forward, observed, errors)
    theta0 = _theta64(theta0)
    p = theta0.shape[0]
    with torch.no_grad():
        r0 = resid(theta0)
    dev = r0.device
    theta0 = theta0.to(dev)
    s2 = (float(r0 @ r0) / max(r0.numel() - p, 1) if errors is None
          else 1.0)

    if cov is None:
        cov = np.eye(p)
    # proposal scale: eps^2 C preconditioner, d^(-1/3) MALA dimension rule
    chol = torch.as_tensor(np.linalg.cholesky(cov + 1e-30 * np.eye(p)),
                           device=dev)
    cov_t = torch.as_tensor(np.asarray(cov, float), device=dev)
    eps = step_scale * p ** (-1.0 / 3.0)

    def energy(th):
        """(nll, grad nll) at ``th``."""
        th = th.detach().requires_grad_(True)
        r = resid(th)
        e = 0.5 * (r @ r) / s2
        return e.detach(), _grad(e, th)

    def drift(th, g):
        return th - 0.5 * eps ** 2 * (cov_t @ g)

    def log_q(a, b, g_b):
        # log q(a | b): Gaussian with mean drift(b), covariance eps^2 C
        d = a - drift(b, g_b)
        sol = torch.cholesky_solve(d[:, None], chol, upper=False)[:, 0]
        return -0.5 * (d @ sol) / eps ** 2

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    # over-dispersed starts: ~2-sigma preconditioned jitter per chain, so
    # split-R-hat tests convergence to the common target
    jitter = 2.0 * torch.randn((chains, p), generator=gen,
                               dtype=torch.float64, device=dev) @ chol.T
    runs, accepts = [], []
    for th in theta0[None, :] + jitter:
        e_th, g_th = energy(th)
        chain, acc = [], []
        for _ in range(steps):
            z = torch.randn(p, generator=gen, dtype=torch.float64,
                            device=dev)
            prop = drift(th, g_th) + eps * (chol @ z)
            e_prop, g_prop = energy(prop)
            log_alpha = (e_th - e_prop + log_q(th, prop, g_prop) -
                         log_q(prop, th, g_th))
            u = torch.rand((), generator=gen, dtype=torch.float64,
                           device=dev)
            accept = torch.log(u) < log_alpha
            th = torch.where(accept, prop, th)
            e_th = torch.where(accept, e_prop, e_th)
            g_th = torch.where(accept, g_prop, g_th)
            chain.append(th)
            acc.append(accept)
        runs.append(torch.stack(chain))
        accepts.append(torch.stack(acc))
    kept = torch.stack(runs).cpu().numpy()[:, burn:, :]   # (chains, n, p)
    r_hat = {path: _split_r_hat(kept[:, :, i])
             for i, path in enumerate(free)}
    flat = kept.reshape(-1, p)
    samples = {}
    for i, path in enumerate(free):
        col = flat[:, i]
        samples[path] = np.exp(col) if SUPPORTED_FREE[path] == 'log' \
            else col
    acceptance = float(torch.stack(accepts).double().mean())
    return PosteriorResult(samples=samples, theta_samples=kept,
                           acceptance=acceptance, r_hat=r_hat)
