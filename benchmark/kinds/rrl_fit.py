"""``rrl_fit``: back-to-back line-profile fits, one client; a request is a
whole ``fit.fit_rrl_spectrum`` of the mix's free parameters from a seeded
start to an observed spectrum that the benchmark's reference makes in
set-up (at the mix's ``truth``).  Keys: ``line``, ``channels`` (about the
line's rest frequency), ``epoch_yr``, ``contsub``, ``truth``, ``start``,
``start_sigma``, ``steps``, ``learning_rate``, ``sample_fits``,
``trace_requests``.

The check follows each sampled fit through all its steps with the
reference's own Adam from the same start: every step's loss, every step's
signed gradient and theta's change over the fit."""
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.workloads import (YEAR, Reservoir, channels,
                                         model_params, quiet_log)
from benchmark.reference import rrl_fit as ref_fit
from benchmark.reference.jet import Line

CHECKS = ('loss_gap', 'grad_gap', 'step_gap')


class Workload:
    unit = 'step'
    control_dtype = torch.float32      # below the fit's float64

    def __init__(self, config: Dict, mix: Dict, seed: int, device: str):
        self.params = model_params(config)
        self.mix, self.device = mix, device
        self.line = mix['line']
        self.freqs = channels(mix['channels'], Line(self.line).nu0)
        self.time = mix['epoch_yr'] * YEAR
        rng = np.random.default_rng([seed, 0])
        start, sig = mix['start'], mix['start_sigma']
        self.starts = [{'properties.T_0': start['properties.T_0'] *
                        math.exp(sig['log properties.T_0'] * a),
                        'target.v_lsr': start['target.v_lsr'] +
                        sig['target.v_lsr'] * b}
                       for a, b in rng.standard_normal((256, 2))]
        self.sample = Reservoir(mix['sample_fits'],
                                np.random.default_rng([seed, 1]))
        self.n = 0
        self.observed = None

    def setup(self) -> Dict:
        """The observed spectrum from the reference (float64; its seconds
        are ``reference_s``), then one short fit to warm the program's
        shapes."""
        t0 = time.perf_counter()
        self.observe()
        if self.device != 'cpu':
            torch.cuda.synchronize()
        reference_s = time.perf_counter() - t0
        if self.device != 'cpu':
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self._fit(self.starts[-1], steps=1)
        return {'reference_s': reference_s}

    def observe(self) -> None:
        """The observed spectrum: the reference's at the mix's truth."""
        self.observed = ref_fit.observed_spectrum(
            self.params, self.line, self.freqs, self.time, self.mix['truth'],
            self.mix['contsub'], torch.float64, self.device)

    def _fit(self, start, steps=None):
        from rajepy_tpu_torch import JetModel, fit
        p = model_params(self.params)
        for path, v in start.items():
            sec, key = path.split('.')
            p[sec][key] = v
        jm = JetModel(p, log=quiet_log(), device=self.device)
        jm.time = self.time
        rec = _recorder(fit.driver.Adam)
        lr = self.mix['learning_rate']
        res = fit.fit_rrl_spectrum(
            jm, self.line, self.freqs, self.observed,
            free=tuple(start), steps=steps or self.mix['steps'],
            learning_rate=lr, contsub=self.mix['contsub'],
            optimizer=lambda ps: rec(ps, lr=lr))
        return res, rec.steps

    def request(self) -> int:
        start = self.starts[self.n % len(self.starts)]
        self.n += 1
        res, steps = self._fit(start)
        self.sample.offer((start, res.loss, steps))
        return self.mix['steps']

    def release(self) -> None:
        pass

    def reference(self, dtype=torch.float64):
        return ref_fit.LineFit(self.params, self.line, self.freqs, self.time,
                               self.mix['contsub'], dtype, self.device)

    def follow(self, ref, start):
        """The reference's fit from ``start``, all the mix's steps:
        (losses, gradients, theta after the last step)."""
        return ref_fit.adam_follow(ref, ref_fit.theta_of(start),
                                   self.observed, self.mix['steps'],
                                   self.mix['learning_rate'])

    def compare(self, start, got, want) -> Dict[str, float]:
        """Gaps of a fit ``got`` against ``want``, each (losses per step,
        gradients per step, theta after the last step): the loss's, the
        signed gradient's per step and parameter, and the signed change
        of theta over the fit."""
        k = self.mix['steps']
        th0 = ref_fit.theta_of(start)
        (loss, grad, th), (r_loss, r_grad, r_th) = got, want
        if len(loss) != k or len(grad) != k:
            return {n: math.inf for n in CHECKS}
        return {'loss_gap': float(np.max(np.abs(np.asarray(loss) - r_loss)
                                         / np.abs(r_loss))),
                'grad_gap': leaf_gap(np.asarray(grad), r_grad),
                'step_gap': leaf_gap((th - th0)[None], (r_th - th0)[None])}

    def check(self) -> Dict[str, float]:
        """Each sampled fit against the reference's from the same start
        (float64); the largest gaps."""
        ref = self.reference()
        gaps = {}
        for start, loss, steps in self.sample.items:
            got = (np.asarray(loss), [_np(g) for g, _ in steps],
                   _np(steps[-1][1]) if steps else np.full(2, np.nan))
            for n, v in self.compare(start, got,
                                     self.follow(ref, start)).items():
                gaps[n] = max(gaps.get(n, 0.0), v)
        return gaps

    def control(self, dtype) -> Dict[str, float]:
        """The reference in ``dtype`` in the program's place, from the
        seed's first start."""
        self.observe()
        start = self.starts[0]
        return self.compare(start, self.follow(self.reference(dtype), start),
                            self.follow(self.reference(), start))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float64).cpu().numpy()


def leaf_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| over (step, parameter), signed values, each
    against the larger of the reference's |value| and the median of its
    parameters' |values| at that step (a gradient near nought, as
    v_lsr's far from the line, is held against the step's scale)."""
    mag = np.abs(want)
    scale = np.maximum(mag, np.median(mag, axis=1, keepdims=True))
    gap = np.abs(np.asarray(got, np.float64) - want) / scale
    return float(np.max(np.where(np.isnan(gap), np.inf, gap)))


def _recorder(adam_cls):
    """A subclass of the program's Adam that keeps, at every step, the
    gradient it is given and theta after the step."""

    class Recorder(adam_cls):
        steps: List[tuple] = []

        def step(self, closure=None):
            (p,), = (g['params'] for g in self.param_groups)
            grad = p.grad.detach().clone()
            out = super().step(closure)
            Recorder.steps.append((grad, p.detach().clone()))
            return out

    Recorder.steps = []
    return Recorder
