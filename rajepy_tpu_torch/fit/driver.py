"""The optimisation driver and the image-plane fits: Adam with optax's
formulas, ``_run_fit`` (steps, multi-start chains, the post-fit model) and
``fit_sed``, ``fit_map``, ``fit_grid_refine`` (the JAX package's
``fit/__init__.py:282-682``)."""
from __future__ import annotations

import copy
import itertools
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from ..utils.profiling import span
from ._params import (_check_free, _check_mesh, _grad, _mesh_devices,
                      _values)
from .forwards import build_flux_forward, build_sed_forward


class FitResult(NamedTuple):
    """Outcome of a gradient fit."""
    values: Dict[str, float]     # fitted value per freed path
    theta: np.ndarray            # final optimisation vector
    loss: np.ndarray             # loss per step
    model: np.ndarray            # forward model at the fitted parameters
    #                              (a tuple of arrays for fit_joint)
    grad_norm: float             # |grad| at the final step
    notes: tuple = ()            # advisory strings (e.g. freed q_T ~ 0:
    #                              the fit used the smooth Reynolds gaunt
    #                              where JetModel would take van Hoof)

    def param_dict(self, params: Dict) -> Dict:
        """``params`` (deep-copied) with the fitted values substituted —
        ready for ``JetModel(...)`` (n_0 etc. re-derived there)."""
        out = copy.deepcopy(params)
        for p, v in self.values.items():
            sec, key = p.split('.')
            if sec == 'nonlte':   # pseudo path, not a params entry
                continue
            out[sec][key] = float(v)
        return out


class Adam(torch.optim.Optimizer):
    """Adam with optax's formulas and defaults (``optax.adam``): moments
    ``mu = (1 - b1) g + b1 mu`` and ``nu = (1 - b2) g^2 + b2 nu``, bias
    corrections by ``1 - b^count``, step ``-lr mu_hat / (sqrt(nu_hat) +
    eps)``.  (``torch.optim.Adam`` puts eps inside its bias-corrected
    denominator in another order.)"""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, b1, b2, eps = (group[k] for k in ('lr', 'b1', 'b2', 'eps'))
            for p in group['params']:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st['count'] = 0
                    st['mu'] = torch.zeros_like(p)
                    st['nu'] = torch.zeros_like(p)
                g = p.grad
                st['mu'] = (1.0 - b1) * g + b1 * st['mu']
                st['nu'] = (1.0 - b2) * g ** 2 + b2 * st['nu']
                st['count'] += 1
                mu_hat = st['mu'] / (1.0 - b1 ** st['count'])
                nu_hat = st['nu'] / (1.0 - b2 ** st['count'])
                p.add_(-lr * (mu_hat / (torch.sqrt(nu_hat) + eps)))


def _to_numpy(x):
    if isinstance(x, (tuple, list)):
        return tuple(_to_numpy(v) for v in x)
    return x.detach().cpu().numpy()


def _f64(a, device):
    """A float64 tensor of ``a`` (array-like or tensor) on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def _descend(loss_fn, theta0, steps, make_opt):
    """One optimiser chain from ``theta0``: the loss before each step,
    the final theta and |grad| there."""
    theta = theta0.detach().clone().requires_grad_(True)
    opt = make_opt([theta])
    hist = []
    for _ in range(steps):
        with span('rajepy.fit.step'):
            with span('rajepy.fit.forward'):
                val = loss_fn(theta)
            with span('rajepy.fit.backward'):
                grad = _grad(val, theta)
            hist.append(val.detach())
            theta.grad = grad
            with span('rajepy.fit.optimizer'):
                opt.step()
    with span('rajepy.fit.finish'):
        grad = _grad(loss_fn(theta), theta)
        hist = torch.stack(hist) if hist else theta.new_zeros(0)
        return theta.detach(), hist, torch.linalg.norm(grad)


def _run_fit(build, jm, free, steps, learning_rate, optimizer,
             n_starts: int = 1, start_spread: float = 0.3, seed: int = 0,
             mesh=None) -> FitResult:
    """Optimisation driver.  ``build(model) -> (forward, theta0,
    loss_of_model)`` makes the fit's forward and loss on ``model``'s
    device; ``optimizer`` is None (Adam at ``learning_rate``) or a
    callable ``params -> torch.optim.Optimizer``.  ``n_starts > 1`` runs
    that many chains — theta0 plus jittered copies (``start_spread`` sigma
    in the transformed log/linear space, drawn once from a
    ``torch.Generator`` seeded with ``seed`` on the model's device, so
    chain k is the same on every mesh) — and keeps the chain with the
    lowest final loss; chain 0 is the single start.  With ``mesh``, chain
    k runs on device k mod n of the mesh's first axis, with the forward
    built again (on ``jm._replica``) on a device other than the model's;
    the chains are issued in turn, so devices overlap.  The results equal
    those with ``mesh=None``, bit for bit where every device of the mesh
    is the model's."""
    _check_mesh(mesh)
    with span('rajepy.fit.run'):
        with span('rajepy.fit.build'):
            forward, theta0, loss_of_model = build(jm)
        theta0 = _f64(theta0, theta0.device)
        make_opt = optimizer if optimizer is not None else (
            lambda ps: Adam(ps, lr=learning_rate))

        def loss_on(fwd, loss):
            return lambda theta: loss(fwd(theta))

        loss_fns = {theta0.device: loss_on(forward, loss_of_model)}
        if n_starts > 1:
            gen = torch.Generator(device=theta0.device)
            gen.manual_seed(seed)
            jitter = start_spread * torch.randn(
                (n_starts - 1, theta0.shape[0]), generator=gen,
                dtype=theta0.dtype, device=theta0.device)
            devs = _mesh_devices(mesh, theta0.device)
            chains = []
            for k, th in enumerate(torch.cat([theta0[None],
                                              theta0[None] + jitter])):
                dev = devs[k % len(devs)]
                if dev not in loss_fns:
                    with span('rajepy.fit.build'):
                        fwd_d, _, loss_d = build(jm._replica(dev))
                    loss_fns[dev] = loss_on(fwd_d, loss_d)
                chains.append(_descend(loss_fns[dev], th.to(dev), steps,
                                       make_opt))
            finals = np.asarray([float(h[-1]) for _, h, _ in chains])
            best = int(np.nanargmin(np.where(np.isfinite(finals), finals,
                                             np.inf)))
            theta, hist, gnorm = chains[best]
        else:
            theta, hist, gnorm = _descend(loss_fns[theta0.device], theta0,
                                          steps, make_opt)
        with span('rajepy.fit.finish'), torch.no_grad():
            theta_np = theta.cpu().numpy()
            model = _to_numpy(forward(theta.to(theta0.device)))
            loss, gnorm = hist.cpu().numpy(), float(gnorm)
    values = _values(free, theta_np)
    notes = []
    if abs(values.get('power_laws.q_T', 1.0)) < 1e-3:
        # a freed q_T always fits with the smooth Reynolds gaunt (the
        # exact-zero van Hoof switch has no derivative); at q_T ~ 0
        # JetModel itself takes the van Hoof branch
        notes.append(
            "freed q_T converged to ~0 ({:+.2e}): the fit forward used "
            "the smooth Reynolds gaunt, but JetModel at q_T == 0 takes "
            "the van Hoof table — re-evaluate with JetModel to check the "
            "difference matters".format(values['power_laws.q_T']))
    return FitResult(notes=tuple(notes), values=values, theta=theta_np,
                     loss=loss, model=model, grad_norm=gnorm)


def _power_norm_loss(observed, errors, device):
    """Least squares normalised by the observed power (for observables
    that pass through zero — line profiles, maps), or per-point
    chi-squared with ``errors``."""
    obs = _f64(observed, device)
    if errors is None:
        norm = torch.sum(obs ** 2)

        def loss(model):
            return torch.sum((model - obs) ** 2) / norm
    else:
        err = _f64(errors, device)

        def loss(model):
            return torch.mean(((model - obs) / err) ** 2)
    return loss


def _sed_loss(observed, errors, device):
    """Least squares in log flux, or chi-squared with ``errors``."""
    observed = _f64(observed, device)
    if errors is None:
        log_obs = torch.log(observed)

        def loss(model):
            return torch.mean((torch.log(model) - log_obs) ** 2)
    else:
        err = _f64(errors, device)

        def loss(model):
            return torch.mean(((model - observed) / err) ** 2)
    return loss


def fit_sed(jm, freqs, observed, *, errors=None,
            free: Sequence[str] = ('properties.mlr_bj', 'properties.T_0'),
            steps: int = 400, learning_rate: float = 0.05, time=None,
            optimizer=None, n_starts: int = 1,
            start_spread: float = 0.3, seed: int = 0,
            mesh=None) -> FitResult:
    """Fit freed parameters to an observed SED (fluxes [Jy] at ``freqs``),
    in float64 on the model's device.

    With ``errors=None`` the loss is least-squares in log flux (radio
    SEDs span decades; relative residuals weight every channel equally);
    with per-channel ``errors`` it is the standard chi-squared.
    """
    _check_mesh(mesh)

    def build(model):
        forward, theta0 = build_sed_forward(model, freqs, free, time)
        return forward, theta0, _sed_loss(observed, errors, theta0.device)

    return _run_fit(build, jm, free, steps, learning_rate, optimizer,
                    n_starts, start_spread, seed, mesh)


def fit_map(jm, freq, observed_map, *, errors=None,
            free: Sequence[str] = ('properties.mlr_bj', 'properties.T_0'),
            steps: int = 400, learning_rate: float = 0.05, time=None,
            optimizer=None, n_starts: int = 1,
            start_spread: float = 0.3, seed: int = 0,
            mesh=None) -> FitResult:
    """Fit freed parameters to an observed flux map [Jy/pixel] at one
    frequency (image-plane fitting — morphology constrains geometry
    parameters an SED cannot).  ``FitResult.model`` is the (1, nx, nz)
    map stack."""
    _check_mesh(mesh)

    def build(model):
        fwd, theta0 = build_flux_forward(model, np.atleast_1d(freq), free,
                                         time)
        base = _power_norm_loss(observed_map, errors, theta0.device)
        return fwd, theta0, lambda m: base(m[0])

    return _run_fit(build, jm, free, steps, learning_rate, optimizer,
                    n_starts, start_spread, seed, mesh)


class GridFitResult(NamedTuple):
    """Outcome of a coarse-grid + gradient-refine fit."""
    node: Dict[str, float]       # winning grid-node values per path
    best: 'FitResult'            # gradient fit at the winning node
    table: list                  # [(node_dict, final_loss)] per node


def fit_grid_refine(jm, freqs, observed, *, grid: Dict[str, Sequence],
                    errors=None,
                    free: Sequence[str] = ('properties.mlr_bj',
                                           'properties.T_0'),
                    steps: int = 200, learning_rate: float = 0.05,
                    time=None) -> GridFitResult:
    """Coarse grid over mask-moving geometry parameters + gradient
    refinement of the smooth ones at every node.

    The jet silhouette is a hard voxel threshold, so the loss along
    ``inc``/``pa``/``opang``/``epsilon`` is a staircase that defeats pure
    gradient descent.  This enumerates candidate values for those
    (``grid``, cartesian product), runs a short float64 ``fit_sed`` of the
    smooth ``free`` parameters on a model built at each node (on ``jm``'s
    device) and keeps the node with the lowest converged loss.
    """
    from ..models.jetmodel import JetModel
    _check_free(list(grid))
    t_model = jm.time if time is None else time
    paths = list(grid)
    table = []
    best = None
    for combo in itertools.product(*(grid[p] for p in paths)):
        node = dict(zip(paths, (float(v) for v in combo)))
        q = copy.deepcopy(jm.params)
        for p, v in node.items():
            sec, key = p.split('.')
            q[sec][key] = v
        jm_node = JetModel(q, log=jm.log, device=jm.device,
                           dtype=torch.float64)
        jm_node.time = t_model
        res = fit_sed(jm_node, freqs, observed, errors=errors, free=free,
                      steps=steps, learning_rate=learning_rate)
        table.append((node, float(res.loss[-1])))
        if best is None or table[-1][1] < best[1]:
            best = (node, table[-1][1], res)
    return GridFitResult(node=best[0], best=best[2], table=table)
