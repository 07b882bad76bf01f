"""The kind ``observe_cube_runs`` on the CPU at a small size (the cell's
configuration on the tiny grid, 8 channels of H58a, 4 time samples a scan,
niter 50): the configuration is the 512^3 jet observed as the bundled line
campaign ships, with one epoch; an unbroken run of the cell is correct; the
timed path broken four ways (the noise dropped in one channel, the common
beam replaced by each channel's own, one CLEAN component altered in one
sampled channel, one channel's threshold doubled) is not, and neither is a
run that writes no model or residual cube; a traced run reports the cell's
per-layer metrics; the cube's readers find nothing in a trace without its
spans and counters; the cube reference loads nothing of the program."""
import math
import os
import types

import numpy as np
import pytest
import torch

from benchmark.counts.clean_cube import least_bytes
from benchmark.harness import core
from benchmark.harness.peaks import bound_ms
from benchmark.harness.trace import REQUEST_SPAN, Trace
from benchmark.harness.workloads import PARAM_GROUPS
from conftest import _edit
from test_bench_imports import FORBIDDEN, _loaded

CELL = 'example_jet_512.h58a_observe'
CONFIG = 'example_jet_512_vla_a_h58a'
N_CHAN = 8
CUBE = ('obs_cube_prep_ms', 'obs_cube_prep_idle_ms', 'obs_cube_clean_ms',
        'obs_cube_clean_roofline', 'obs_cube_loop_iters_per_run')
SHARED = ('fill_ms', 'obs_plan_ms', 'obs_sample_ms', 'obs_write_ms',
          'obs_outside_ms')
H100 = 'NVIDIA H100 80GB HBM3'


def _cut(c):
    rrls = c['pipeline']['rrls']
    rrls['bws'] = [N_CHAN * rrls['chanws'][0]]


@pytest.fixture()
def small(tiny):
    _edit(os.path.join(tiny.root, 'benchmark', 'configs', CONFIG + '.json'),
          _cut)
    _edit(os.path.join(tiny.root, 'benchmark', 'traffic', 'h58a_observe.json'),
          lambda m: m['synthobs'].update(max_time_samples=4, niter=50))
    return core.Spec(tiny.root)


def _run(spec, trace=False, seed=2 ** 31 + 9):
    return core.run_cell(CELL, seed, 0.2, trace, 'cpu', spec=spec)


def _centre_freq(spec):
    from benchmark.kinds import observe_cube_runs as kind
    cell = spec.cell(CELL)
    freqs = kind.reference_setup(spec.config(cell),
                                 spec.traffic(cell))['chan_freqs']
    return float(freqs[len(freqs) // 2])


def test_configuration_observes_as_the_bundled_line_campaign():
    """The cell's configuration is the 512^3 jet of ``example_jet_512``
    observed with the bundled pipeline parameters' RRL block and minimum
    elevation as shipped, with the one epoch 2.0 yr, and no continuum
    epoch."""
    from benchmark.kinds import observe_runs
    spec = core.Spec(core.ROOT)
    config = spec.config(spec.cell(CELL))
    jet = spec.config({'config': 'example_jet_512'})
    assert all(config[g] == jet[g] for g in PARAM_GROUPS)
    shipped = observe_runs.bundled()
    assert config['pipeline']['min_el'] == shipped['min_el']
    assert config['pipeline']['continuum'] == {'times': []}
    rrls = config['pipeline']['rrls']
    assert sorted(rrls) == sorted(shipped['rrls'])
    assert rrls['times'] == [2.0] and shipped['rrls']['times'].size == 0
    for key, value in shipped['rrls'].items():
        if key != 'times':
            np.testing.assert_array_equal(np.asarray(rrls[key]), value)
            assert np.asarray(rrls[key]).dtype.kind == value.dtype.kind, key


def test_unbroken_observed_cube_run_is_correct(small):
    out = _run(small)
    assert out['correct'] and out['failed'] == 0
    assert set(out['metrics']) == {'setup_s', 'runs_per_s', 'peak_mem_gib'}


def _no_noise_in_one_channel(mp, spec):
    """The centre channel's noisy set is its clean set."""
    from rajepy_tpu_torch.synthobs import sampler
    sample = sampler.sample_vis_cube_with_noise

    def noiseless(*args, **kwargs):
        clean, noisy = sample(*args, **kwargs)
        noisy = noisy.clone()
        noisy[noisy.shape[0] // 2] = clean[noisy.shape[0] // 2]
        return clean, noisy
    mp.setattr(sampler, 'sample_vis_cube_with_noise', noiseless)


def _own_beams(mp, spec):
    """Each channel restored with the beam of its own PSF, not the
    centre channel's common beam."""
    from rajepy_tpu_torch.synthobs import imaging
    clean_cube = imaging.clean_cube

    def own(uvw, freqs, vis, weights, n_pix, cell, mask, beam_kernel,
            model_residual=False, **kw):
        out = list(clean_cube(uvw, freqs, vis, weights, n_pix, cell, mask,
                              beam_kernel, model_residual=True, **kw))
        rdt = vis.real.dtype
        uv = torch.as_tensor(np.asarray(uvw)[:, :2], dtype=rdt)
        inv = 1.0 - torch.as_tensor(mask, dtype=rdt)
        for c, f in enumerate(freqs):
            _, psf, _ = imaging._cube_channel(
                uv, float(f), vis[c], torch.as_tensor(weights, dtype=rdt),
                n_pix, cell, inv, inv.sum(), 'briggs', 0.5, 3.0)
            kern = imaging.gaussian_beam_kernel(
                n_pix, cell, *imaging.fit_psf_beam(psf, cell))
            out[0][c] = imaging.restore(out[2][c], out[3][c], kern)
        return tuple(out if model_residual else out[:2])
    mp.setattr(imaging, 'clean_cube', own)


def _altered_component(mp, spec):
    """The brightest CLEAN component of the centre channel 1% brighter
    (one block holds every channel here)."""
    from rajepy_tpu_torch.synthobs import imaging
    hogbom = imaging._hogbom

    def altered(*args, **kwargs):
        model, res, count = hogbom(*args, **kwargs)
        model = model.clone()
        c = model[model.shape[0] // 2].view(-1)
        c[int(c.abs().argmax())] *= 1.01
        return model, res, count
    mp.setattr(imaging, '_hogbom', altered)


def _doubled_threshold(mp, spec):
    """The centre channel's CLEAN threshold twice the nsigma one."""
    from rajepy_tpu_torch.synthobs import imaging
    channel = imaging._cube_channel
    centre = _centre_freq(spec)

    def doubled(uvw, freq, *args):
        dirty, psf, thr = channel(uvw, freq, *args)
        return dirty, psf, thr * 2.0 if math.isclose(
            freq, centre, rel_tol=1e-12) else thr
    mp.setattr(imaging, '_cube_channel', doubled)


@pytest.mark.parametrize('fault', [_no_noise_in_one_channel, _own_beams,
                                   _altered_component, _doubled_threshold])
def test_broken_observed_cube_runs_are_not_correct(small, monkeypatch,
                                                    fault):
    fault(monkeypatch, small)
    assert not _run(small)['correct']


def test_a_run_without_model_and_residual_cubes_is_not_correct(small):
    """A program that writes no CLEAN model or residual cube (as before
    the cube path kept them) reads inf in those stages, and no error."""
    _edit(os.path.join(small.root, 'benchmark', 'traffic',
                       'h58a_observe.json'),
          lambda m: m['synthobs'].update(save_products=['psf', 'dirty']))
    out = _run(small)
    assert not out['correct'] and out['failed'] == 0
    checks = {n: c['value'] for n, c in out['checks'].items()}
    assert checks['clean_gap'] == checks['restored_gap'] == math.inf
    assert checks['dirty_gap'] < 1e-10 and checks['psf_gap'] < 1e-10


def test_traced_run_reports_the_cube_metrics(small):
    """Every metric of the cell but the roofline, which needs the card's
    busy time (see the next test)."""
    out = _run(small, trace=True)
    assert set(out['metrics']) == (set(CUBE) | set(SHARED)) - {
        'obs_cube_clean_roofline'}
    m = {n: v['value'] for n, v in out['metrics'].items()}
    assert all(math.isfinite(v) and v >= 0.0 for v in m.values()), m
    assert 0.0 < m['obs_cube_loop_iters_per_run'] <= 50.0
    assert m['obs_cube_prep_idle_ms'] == m['obs_cube_prep_ms'] > 0.0
    # nothing runs on a card here
    assert out['device']['busy_s'] == 0.0


def _ctx(device, host, deltas, geometry=(500, 85, 85, 1000)):
    trace = Trace(device, [(REQUEST_SPAN, 0.0, 1e6)] + host, (0.0, 1e6))
    workload = types.SimpleNamespace(unit='run', deltas=deltas,
                                     cube_geometry=geometry)
    return core.Context(trace, len(deltas), len(deltas), {}, workload, H100)


def test_roofline_reads_the_least_bytes_over_the_busy_time():
    """The least time of the CLEAN's bytes over the card's busy time in the
    CLEAN spans (here 30 ms of operations, two overlapping, in two
    spans), below 100%."""
    ctx = _ctx([('k', 1e3, 2e4), ('k', 1.5e4, 2.1e4), ('k', 5e5, 5.1e5),
                ('outside', 7e5, 8e5)],
               [('rajepy.synthobs: cube CLEAN', 0.0, 3e5),
                ('rajepy.synthobs: cube CLEAN', 4e5, 6e5)],
               [{'obs.runs': 1, 'obs.clean_iterations': 2}])
    got = core.reader('obs_cube_clean_roofline')(ctx)
    want = 100.0 * bound_ms(H100, least_bytes(500, 85, 85, 1000, 2), 0.0) \
        / 30.0
    assert got == pytest.approx(want, rel=1e-12) and 0.0 < got < 100.0


def test_readers_find_nothing_without_the_cube():
    trace = Trace([('k', 10.0, 20.0)],
                  [(REQUEST_SPAN, 0.0, 100.0), ('rajepy.obs.run', 5.0, 60.0),
                   ('rajepy.obs.clean', 6.0, 50.0)],
                  (0.0, 100.0))
    for workload in (types.SimpleNamespace(unit='run'),
                     types.SimpleNamespace(unit='run', deltas=[{}, {}],
                                           cube_geometry=(500, 85, 85, 8)),
                     types.SimpleNamespace(
                         unit='run', cube_geometry=(500, 85, 85, 8),
                         deltas=[{'obs.runs': 1,
                                  'obs.clean_iterations': 9}])):
        ctx = core.Context(trace, 1, 1, {}, workload, H100)
        for name in CUBE:
            assert core.reader(name)(ctx) is None, name


def test_cube_reference_loads_nothing_of_the_program():
    mods = _loaded('import benchmark.reference.observe_cube')
    assert not mods & (FORBIDDEN | {'rajepy_tpu_torch'})
