"""Differentiable parameter inference: gradient fitting of jet models on
``torch.autograd`` (PyTorch port of rajepy_tpu.fit).

The radiative-transfer forward model (``models.fields`` grid fill through
the ``ops.radtrans`` opacity and flux chain) is a differentiable function
of the physical parameters, so observed SEDs, flux maps, visibilities,
closure quantities, RRL spectra and cubes and light curves are fitted by
exact-gradient optimisation on the model's device (``JetModel(...,
device='cuda')`` by default; a CPU model fits on the CPU).

Entry points
------------
``fit_sed(jm, freqs, observed)``           — integrated fluxes [Jy]
``fit_map(jm, freq, observed_map)``        — a flux map [Jy/pixel]
``fit_grid_refine(jm, freqs, observed, grid=...)`` — coarse grid over
                                             mask-moving geometry + refine
``fit_visibilities`` / ``fit_uvfits`` / ``fit_closures`` — uv plane
``fit_rrl_spectrum`` / ``fit_rrl_cube``    — RRL line profiles and cubes
``fit_joint(jm, components)``              — one theta, several observables
``fit_light_curve(jm, times, freqs, obs)`` — ejection-burst parameters
``laplace_uncertainties``, ``closure_uncertainties``,
``sample_posterior``, ``rrl_departure_systematic`` — uncertainties
``sweep(jm, freqs, grid)``                 — parameter surveys

Free parameters are dotted params-dict paths (``SUPPORTED_FREE``).  The
derived quantities follow JetModel's chain on 0-d tensors: ``mod_r_0``
from (opang, epsilon, w_0), ``q_n`` from (epsilon, q_v), ``n_0`` from
``mlr_bj``, the red/blue ratio from ``mlr_rj/mlr_bj``.  Positive
parameters are optimised in log space, angles and indices linearly.

What the JAX package's transforms became: ``jax.value_and_grad`` is
``torch.autograd.grad``; ``jax.jacobian`` is one forward-mode product per
free parameter (``torch.autograd.forward_ad``); ``lax.scan`` over steps
and ``vmap`` over starts, MALA chains and sweep combos are Python loops
(each chain's and combo's numbers are those of the single evaluation);
``jax.random`` is a ``torch.Generator`` seeded from ``seed`` on the
model's device; optax.adam is :class:`Adam` (optax's formulas and
defaults), and ``optimizer=`` takes None or a callable ``params ->
torch.optim.Optimizer``.  ``mesh=`` (a ``parallel.sharding.Mesh``)
spreads the starts of a fit and the combos of a sweep over the devices of
the mesh's first axis, item k to device k mod n.  A derivative through the travel times' 2F1 series (a model with
bursts and q^d_v != 0, freeing inc/pa/opang/epsilon/q_v) raises
``ValueError``, as the JAX package cannot take it either.

Caveat — geometry parameters and the voxel mask: the jet silhouette is a
hard 8-corner threshold, so the loss along parameters that move the mask
(``inc``, ``pa``, ``opang``, ``epsilon``) is a staircase; the gradient
holds only the smooth in-mask dependence.  Fit those with multi-start or
``fit_grid_refine``.

Submodules: ``_params`` (paths and the derivation chain), ``forwards``
(flux and SED), ``driver`` (Adam, the driver, ``fit_sed``/``fit_map``/
``fit_grid_refine``), ``uncertainty``, ``uv``, ``rrl``, ``joint``,
``light_curve``, ``survey`` (``sweep``).
"""
from ._params import SUPPORTED_FREE, YEAR
from .driver import (Adam, FitResult, GridFitResult, fit_grid_refine,
                     fit_map, fit_sed)
from .forwards import build_flux_forward, build_sed_forward
from .joint import fit_joint
from .light_curve import (BurstFitResult, build_light_curve_forward,
                          fit_light_curve)
from .rrl import (build_rrl_forward, build_rrl_spectrum_forward,
                  fit_rrl_cube, fit_rrl_spectrum, rrl_departure_systematic)
from .survey import SweepResult, sweep
from .uncertainty import (PosteriorResult, laplace_uncertainties,
                          sample_posterior)
from .uv import (build_vis_forward, closure_uncertainties, fit_closures,
                 fit_uvfits, fit_visibilities)

__all__ = [
    'SUPPORTED_FREE', 'YEAR', 'Adam', 'FitResult', 'PosteriorResult',
    'GridFitResult', 'BurstFitResult', 'SweepResult',
    'build_flux_forward', 'build_sed_forward', 'build_vis_forward',
    'build_rrl_forward', 'build_rrl_spectrum_forward',
    'build_light_curve_forward', 'fit_sed', 'fit_map', 'fit_grid_refine',
    'fit_visibilities', 'fit_uvfits', 'fit_closures', 'fit_rrl_spectrum',
    'fit_rrl_cube', 'fit_joint', 'fit_light_curve',
    'laplace_uncertainties', 'closure_uncertainties', 'sample_posterior',
    'rrl_departure_systematic', 'sweep',
]
