"""The kind ``observe_runs`` on the CPU at a small size (the cell's
configuration on 64^3 cells, 4 time samples a scan, niter 50): the
configuration is the 512^3 jet observed as the bundled campaign ships; an
unbroken run of the cell is correct; the timed path broken four ways (the noise
dropped, the degridding kernel two taps narrow, the restoration skipped,
one CLEAN component altered) is not; a
traced run reports the cell's per-layer metrics, and the observation's
readers find nothing in a trace without its spans and counters."""
import math
import os
import types

import pytest

from benchmark.harness import core
from benchmark.harness.trace import REQUEST_SPAN, Trace
from benchmark.harness.workloads import PARAM_GROUPS
from conftest import _edit

CELL = 'example_jet_512.observe_vla_a'
METRICS = ('obs_plan_ms', 'obs_sample_ms', 'obs_image_ms', 'obs_clean_ms',
           'obs_imfit_ms', 'obs_write_ms', 'obs_outside_ms',
           'obs_clean_iters_per_run')


@pytest.fixture()
def small(tiny):
    _edit(os.path.join(tiny.root, 'benchmark', 'configs',
                       'example_jet_512_vla_a.json'),
          lambda c: c['grid'].update(n_x=64, n_y=64, n_z=64))
    _edit(os.path.join(tiny.root, 'benchmark', 'traffic',
                       'observe_vla_a.json'),
          lambda m: m['synthobs'].update(max_time_samples=4, niter=50))
    return core.Spec(tiny.root)


def _run(spec, trace=False, seed=2 ** 31 + 9):
    return core.run_cell(CELL, seed, 0.2, trace, 'cpu', spec=spec)


def test_configuration_observes_as_the_bundled_campaign():
    """The cell's configuration is the 512^3 jet of ``example_jet_512``
    observed with the bundled pipeline parameters' continuum block and
    minimum elevation as shipped."""
    import numpy as np
    from benchmark.kinds import observe_runs
    spec = core.Spec(core.ROOT)
    config = spec.config(spec.cell(CELL))
    jet = spec.config({'config': 'example_jet_512'})
    assert all(config[g] == jet[g] for g in PARAM_GROUPS)
    shipped = observe_runs.bundled()
    assert config['pipeline']['min_el'] == shipped['min_el']
    cont = config['pipeline']['continuum']
    assert sorted(cont) == sorted(shipped['continuum'])
    for key, value in shipped['continuum'].items():
        np.testing.assert_array_equal(np.asarray(cont[key]), value)
        assert np.asarray(cont[key]).dtype.kind == value.dtype.kind, key


def test_unbroken_observed_run_is_correct(small):
    out = _run(small)
    assert out['correct'] and out['failed'] == 0
    assert set(out['metrics']) == {'setup_s', 'peak_mem_gib'}


def _no_noise(mp):
    from rajepy_tpu_torch.synthobs import sampler
    mp.setattr(sampler, 'add_noise', lambda seed, vis, sigma: vis.clone())


def _narrow_kernel(mp):
    """The Kaiser-Bessel degridding kernel 4 cells wide, not 6."""
    from rajepy_tpu_torch.synthobs import sampler
    mp.setattr(sampler, '_KB_W', 4)


def _no_restore(mp):
    from rajepy_tpu_torch.synthobs import imaging
    mp.setattr(imaging, 'restore',
               lambda model, residual, beam_kernel: residual.clone())


def _altered_component(mp):
    """The brightest CLEAN component 1% brighter."""
    from rajepy_tpu_torch.synthobs import imaging
    hogbom = imaging.hogbom_clean

    def clean(*args, **kwargs):
        model, res, its = hogbom(*args, **kwargs)
        model = model.clone()
        model.view(-1)[int(model.abs().argmax())] *= 1.01
        return model, res, its
    mp.setattr(imaging, 'hogbom_clean', clean)


@pytest.mark.parametrize('fault', [_no_noise, _narrow_kernel, _no_restore,
                                   _altered_component])
def test_broken_observed_runs_are_not_correct(small, monkeypatch, fault):
    fault(monkeypatch)
    assert not _run(small)['correct']


def test_traced_run_reports_the_observation_metrics(small):
    out = _run(small, trace=True)
    assert set(out['metrics']) == set(METRICS) | {'fill_ms'}
    m = {n: v['value'] for n, v in out['metrics'].items()}
    assert all(math.isfinite(v) and v >= 0.0 for v in m.values()), m
    assert 0.0 < m['obs_clean_iters_per_run'] <= 50.0
    # nothing runs on a card here
    assert out['device']['busy_s'] == 0.0


def test_readers_find_nothing_without_the_observation():
    trace = Trace([('k', 10.0, 20.0)],
                  [(REQUEST_SPAN, 0.0, 100.0), ('rajepy.rt.run', 5.0, 60.0)],
                  (0.0, 100.0))
    for workload in (types.SimpleNamespace(unit='run'),
                     types.SimpleNamespace(unit='run', deltas=[{}, {}])):
        ctx = core.Context(trace, 1, 1, {}, workload, 'cpu')
        for name in METRICS:
            assert core.reader(name)(ctx) is None, name
