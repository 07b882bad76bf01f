"""The plain reference of an RRL line-profile fit: the spatially integrated
LTE spectrum as a function of theta = (log T_0 [K], v_lsr [km/s]), its
power-normalised least-squares loss and gradient (torch.autograd), and
Adam with optax's formulas, from the same jet fields as :mod:`.jet`.

T_0 scales the temperature field and v_lsr shifts the LOS velocity; no
other field depends on them, so the jet cells' other fields are gathered
once and each evaluation recomputes the opacities, the LOS sums and the
fluxes."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .gaunt import gff
from .jet import Jet, Line

FREE = ('properties.T_0', 'target.v_lsr')


class LineFit:
    """Spectrum, loss and gradient of ``line`` over ``freqs`` [Hz] at the
    epoch ``time`` [s], in ``dtype`` on ``device``."""

    def __init__(self, params: Dict, line: str, freqs, time: float,
                 contsub: bool = True, dtype=torch.float64, device='cpu'):
        self.jet = jet = Jet(params)
        self.line = Line(line)
        self.contsub = contsub
        self.dtype, self.device = dtype, device
        f64 = np.asarray(freqs, np.float64)
        self.f = torch.as_tensor(f64, device=device).to(dtype)
        self.d_f = torch.as_tensor(f64 - self.line.nu0, device=device
                                   ).to(dtype)
        keep = {n: [] for n in ('n_es', 'ds', 'tshape', 'vy0', 'pix')}
        nz, t_0, v_lsr = jet.nz, jet.pr['T_0'], jet.tg['v_lsr']
        for x0 in range(0, jet.nx, jet.rows()):
            x1 = min(jet.nx, x0 + jet.rows())
            s = jet.slab(x0, x1, dtype, device)
            ins = s['inside']
            n_es = s['nd'] * jet.chi(s['red'], time - s['ts']) * s['xi']
            pix = ((torch.arange(x0, x1, device=device)[:, None, None] * nz +
                    torch.arange(nz, device=device)[None, None])
                   .expand(ins.shape)[ins])
            keep['n_es'].append(n_es[ins])
            keep['ds'].append(jet.ds_cm(s)[ins])
            keep['tshape'].append(s['temp'][ins] / t_0)
            keep['vy0'].append(s['vy'][ins] - v_lsr)
            keep['pix'].append(pix)
        cells = {n: torch.cat(v) for n, v in keep.items()}
        # only the pixels that hold a jet cell carry flux
        self.pixels, cells['pix'] = torch.unique(cells['pix'],
                                                 return_inverse=True)
        self.cells = cells
        self.count = torch.zeros(len(self.pixels), dtype=dtype,
                                 device=device).index_add_(
            0, cells['pix'], torch.ones_like(cells['ds']))

    def spectrum(self, theta: torch.Tensor) -> torch.Tensor:
        """(n_chan,) flux [Jy] summed over the image."""
        c, jet = self.cells, self.jet
        t_0 = torch.exp(theta[0])
        temp = t_0 * c['tshape']
        vy = c['vy0'] + theta[1]
        n_pix, pix = len(self.pixels), c['pix']

        def los(v):        # (..., n_cells) -> (..., n_pix)
            z = v.new_zeros(v.shape[:-1] + (n_pix,))
            return z.index_add(v.dim() - 1, pix, v)

        base = 0.018 * temp ** -1.5 * c['n_es'] ** 2 * c['ds'] if \
            jet.van_hoof else \
            0.018 * 11.95 * temp ** -1.35 * c['n_es'] ** 2 * c['ds']
        if jet.van_hoof:
            scale = self.f ** -2.0 * gff(self.f, t_0)
        else:
            scale = self.f ** -2.1
        tau_c = scale[:, None] * los(base)[None]
        tau_l = los(Jet.line_tau(self.line, self.d_f, self.f, temp,
                                 c['n_es'], vy, c['ds']))
        tbar = los(temp) / self.count
        ones = torch.ones_like(tbar, dtype=torch.bool)
        ints = Jet.line_intensity(self.f, tbar[:, None], ones[:, None],
                                  tau_c[..., None], tau_l[..., None])[..., 0]
        flux = ints * jet.flux_scale()
        if not self.contsub:
            flux = flux + jet.ff_flux(self.f, tau_c[..., None],
                                      tbar[:, None], ones[:, None])[..., 0]
        return flux.sum(1)

    def loss_grad(self, theta, observed):
        """(loss, d loss / d theta) of sum (model - obs)^2 / sum obs^2."""
        th = torch.as_tensor(np.asarray(theta, np.float64),
                             device=self.device).to(self.dtype)
        th.requires_grad_(True)
        obs = torch.as_tensor(np.asarray(observed, np.float64),
                              device=self.device).to(self.dtype)
        loss = torch.sum((self.spectrum(th) - obs) ** 2) / torch.sum(obs ** 2)
        g, = torch.autograd.grad(loss, th)
        return float(loss.detach()), g.to(torch.float64).cpu().numpy()


def theta_of(values: Dict[str, float]) -> np.ndarray:
    """theta of ``{path: value}`` for :data:`FREE`."""
    return np.array([math.log(values['properties.T_0']),
                     values['target.v_lsr']])


def adam_follow(fit: LineFit, theta0, observed, steps: int, lr: float,
                b1=0.9, b2=0.999, eps=1e-8):
    """``steps`` Adam steps (optax's formulas) from ``theta0``: the loss and
    gradient before each step and theta after the last."""
    theta = np.asarray(theta0, np.float64).copy()
    mu, nu = np.zeros_like(theta), np.zeros_like(theta)
    losses, grads = [], []
    for n in range(1, steps + 1):
        loss, g = fit.loss_grad(theta, observed)
        losses.append(loss)
        grads.append(g)
        mu = (1.0 - b1) * g + b1 * mu
        nu = (1.0 - b2) * g ** 2 + b2 * nu
        theta = theta - lr * (mu / (1.0 - b1 ** n)) / (
            np.sqrt(nu / (1.0 - b2 ** n)) + eps)
    return np.array(losses), np.array(grads), theta


def observed_spectrum(params, line, freqs, time, truth: Dict[str, float],
                      contsub=True, dtype=torch.float64, device='cpu'):
    """The spectrum of the jet at ``truth`` ({path: value} of FREE)."""
    fit = LineFit(params, line, freqs, time, contsub, dtype, device)
    with torch.no_grad():
        th = torch.as_tensor(theta_of(truth), device=device).to(dtype)
        return fit.spectrum(th).to(torch.float64).cpu().numpy()
