"""What the benchmark's kinds of request share.  A traffic mix
(``benchmark/traffic/<mix>.json``) is data: its ``kind`` names the module
``benchmark/kinds/<kind>.py`` whose ``Workload`` serves it, and its other
keys set the sizes, epochs, starts and how many answers the check
samples.  Everything is drawn from the run's seed.

A workload's class takes ``(config, mix, seed, device)`` and has
``unit`` (what ``request`` counts: ``'run'``, ``'step'``), ``setup() ->
dict`` (build and warm; the dict holds set-up readings, and
``reference_s``, the seconds the benchmark's own reference took in it,
which ``setup_s`` leaves out), ``request() -> int`` (one request, the
units it completed), ``release()`` (drop the program's state) and
``check() -> {number: gap}`` (the sampled answers against the plain
reference, after the window), and ``control(dtype)``: the same numbers
with the reference computed in ``dtype`` put in the program's place
(``control_dtype``, the precision below the configuration's).  A new kind
is a new file there.
"""
from __future__ import annotations

import importlib.util
import math
import os
import time
from typing import Dict, List

import numpy as np
import torch

YEAR = 31536000.0
PARAM_GROUPS = ('target', 'grid', 'geometry', 'power_laws', 'properties',
                'ejection')


def model_params(config: Dict) -> Dict:
    """The model parameters of a configuration file (or a copy of them),
    each group a dict of its own and the ejection arrays numpy arrays (the
    parameter schema of RaJePy; ``JetModel`` adds derived keys)."""
    p = {g: dict(config[g]) for g in PARAM_GROUPS}
    p['ejection'] = {key: np.asarray(v) for key, v in p['ejection'].items()}
    return p


def channels(spec: Dict, nu0: float = 0.0) -> np.ndarray:
    """Channel frequencies [Hz] of a mix's ``freqs_hz``/``channels`` entry:
    ``{"geomspace": [lo, hi, n]}``; ``{"bandwidth_hz": bw,
    "chanwidth_hz": cw}`` centred on the line (the pipeline's channels);
    or ``{"relative": [lo, hi, n]}``: nu0 (1 + linspace(lo, hi, n))."""
    if 'geomspace' in spec:
        lo, hi, n = spec['geomspace']
        return np.geomspace(lo, hi, int(n))
    if 'bandwidth_hz' in spec:
        bw, cw = spec['bandwidth_hz'], spec['chanwidth_hz']
        return nu0 - bw / 2.0 + cw / 2.0 + np.arange(int(bw / cw)) * cw
    lo, hi, n = spec['relative']
    return nu0 * (1.0 + np.linspace(lo, hi, int(n)))


class Reservoir:
    """A uniform sample of ``k`` of the items offered (algorithm R)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item


def map_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| of a product's maps, each map's as a share of
    its own largest |want| (a channel of small values is held as tightly
    as the brightest)."""
    if got.shape != want.shape:
        return math.inf
    got, want = (a.reshape((-1,) + a.shape[-2:]) for a in (got, want))
    scale = np.max(np.abs(want), axis=(1, 2))
    gap = np.max(np.abs(got - want), axis=(1, 2))
    return float(np.max(gap / np.where(scale > 0, scale, 1.0)))


def quiet_log():
    from rajepy_tpu_torch.utils.logger import Log
    return Log(os.devnull, verbose=False)


def device_ms(fn, device: str) -> float:
    """Milliseconds of ``fn`` between CUDA events (host clock on a CPU)."""
    if device == 'cpu':
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


class Runs:
    """A closed loop of RT runs, one client: a request sets the model's
    epoch to the next of a seeded draw and asks for the run's (em, tau,
    flux) maps on the host.  A kind says what it asks (``_call``) and how
    the reference makes the same maps (``reference``)."""
    unit = 'run'
    products = ('em', 'tau', 'flux')
    control_dtype = torch.bfloat16     # below the configurations' float32

    def __init__(self, config: Dict, mix: Dict, seed: int, device: str,
                 nu0: float = 0.0):
        self.params = model_params(config)
        self.mix, self.device = mix, device
        self.freqs = channels(mix.get('freqs_hz') or mix['channels'], nu0)
        lo, hi = mix['epochs_yr']
        rng = np.random.default_rng([seed, 0])
        self.epochs = rng.uniform(lo, hi, 4096) * YEAR
        self.sample = Reservoir(mix['sample_runs'],
                                np.random.default_rng([seed, 1]))
        self.n = 0
        self.jm = None

    def setup(self) -> Dict:
        """Build the model, fill its grid (timed by CUDA events, ms) and
        warm every shape the requests use."""
        from rajepy_tpu_torch import JetModel
        self.jm = JetModel(model_params(self.params), log=quiet_log(),
                           device=self.device)
        fill_ms = device_ms(self.jm._ensure_fields, self.device)
        # as many answers alive at once as the window holds (the sample
        # and the newest)
        held = []
        for _ in range(self.sample.k + 2):
            held = held[-self.sample.k:] + [self._call(self.epochs[-1])]
        return {'fill_ms': fill_ms}

    def _call(self, epoch):
        raise NotImplementedError

    def reference(self, epochs, dtype) -> List[tuple]:
        """(em, tau, flux) of the plain reference at ``epochs``."""
        raise NotImplementedError

    def request(self) -> int:
        epoch = self.epochs[self.n % len(self.epochs)]
        self.n += 1
        self.sample.offer((epoch, self._call(epoch)))
        return 1

    def release(self) -> None:
        self.jm = None

    def compare(self, got: List[tuple], want: List[tuple]
                ) -> Dict[str, float]:
        """Per product, the largest gap over the runs between ``got`` and
        ``want`` ((em, tau, flux) maps per run)."""
        return {f'{p}_gap': max(map_gap(g[i], w[i])
                                for g, w in zip(got, want))
                for i, p in enumerate(self.products)}

    def check(self) -> Dict[str, float]:
        """The sampled runs against the reference (float64)."""
        epochs = [e for e, _ in self.sample.items]
        return self.compare([out for _, out in self.sample.items],
                            self.reference(epochs, torch.float64))

    def control(self, dtype) -> Dict[str, float]:
        """The reference in ``dtype`` in the program's place, over as many
        of the seed's epochs as the check samples."""
        epochs = list(self.epochs[:self.sample.k])
        return self.compare(self.reference(epochs, dtype),
                            self.reference(epochs, torch.float64))


def kind_class(root: str, kind: str):
    """The ``Workload`` class of ``<root>/benchmark/kinds/<kind>.py``."""
    path = os.path.join(root, 'benchmark', 'kinds', kind + '.py')
    spec = importlib.util.spec_from_file_location(
        'benchmark.kinds.' + kind.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Workload
