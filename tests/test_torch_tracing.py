"""The port's spans and counters (``utils.profiling``) on the CPU:

* with no profiler recording, ``span`` never enters
  ``record_function`` (an RT run, a fit and a KernelTimer with it made
  to raise);
* under ``torch.profiler``, a continuum run, an RRL run and a 2-step
  ``fit_rrl_spectrum`` open each ``rajepy.*`` span once where it
  belongs, nested as the layers are, and the grid fill's KernelTimer
  shows as ``rajepy.<stage>``;
* ``rt.runs`` counts every RT products call and ``rt.products_out_bytes``
  the bytes of the numpy products, and nothing with ``as_numpy=False``;
* the products are bit for bit the same with the profiler on and off;
* an observed run (``Pipeline.execute_run``) opens each ``rajepy.obs.*``
  stage span once inside ``rajepy.obs.run`` (``.write`` twice: the
  visibility sets before imaging, the images after), covering at least
  nine tenths of it, and ``obs.runs``,
  ``obs.visibilities`` and ``obs.clean_iterations`` advance by one run, its
  visibilities and its Hogbom iterations; with no profiler it enters no
  ``record_function``.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rajepy_tpu_torch import JetModel, Pipeline, fit
from rajepy_tpu_torch.ops import rrls
from rajepy_tpu_torch.synthobs import imaging
from rajepy_tpu_torch.utils import profiling
from tests.torch_one_thread import one_thread  # noqa: F401

LINE = 'H58a'
FREQS_C = np.array([5e9, 2.2e10, 1e11])
FREQS_L = rrls.rrl_nu_0('H', 58, 1) * (1.0 + np.linspace(-3e-4, 3e-4, 4))
FREE = ('properties.T_0', 'target.v_lsr')
RUN_CHILDREN = ('rajepy.rt.statics', 'rajepy.rt.epoch_maps',
                'rajepy.rt.channel_stage', 'rajepy.rt.products_out')
STEP_CHILDREN = ('rajepy.fit.forward', 'rajepy.fit.backward',
                 'rajepy.fit.optimizer')
FILL = 'rajepy.grid fill (fields + fill factors)'
OBS_STAGES = ('rajepy.obs.plan', 'rajepy.obs.sample', 'rajepy.obs.image',
              'rajepy.obs.clean', 'rajepy.obs.restore', 'rajepy.obs.imfit')
OBS_COUNTERS = ('obs.runs', 'obs.visibilities', 'obs.clean_iterations')


def _model(params, dtype=torch.float64):
    params['grid'].update(n_x=16, n_y=40, n_z=16)
    jm = JetModel(params, device='cpu', dtype=dtype)
    jm.time = 2.0 * 31536000.0
    return jm


def _observed(jm):
    forward, theta0 = fit.build_rrl_spectrum_forward(jm, LINE, FREQS_L,
                                                     FREE)
    with torch.no_grad():
        return forward(theta0 + torch.tensor([-0.2, 5.0],
                                             dtype=torch.float64)).numpy()


def _spans(prof):
    """(name, start_ns, end_ns) of the program's spans in a profile."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith('rajepy.')]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_no_profiler_no_record_function(model_params, monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(profiling, 'record_function', refuse)
    jm = _model(model_params)
    assert profiling.span('rajepy.rt.run') is profiling.span('rajepy.x')
    jm.continuum_rt_products(FREQS_C)                  # fill, KernelTimer
    jm.rrl_rt_products(LINE, FREQS_L)
    res = fit.fit_rrl_spectrum(jm, LINE, FREQS_L, _observed(jm), free=FREE,
                               steps=1)
    assert res.loss.shape == (1,)
    with profiling.KernelTimer('stage'):
        pass


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_rt_spans_nest_and_products_are_unchanged(model_params, dtype):
    jm_off, jm_on = _model(model_params, dtype), _model(model_params, dtype)
    off = (jm_off.continuum_rt_products(FREQS_C),
           jm_off.rrl_rt_products(LINE, FREQS_L))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = (jm_on.continuum_rt_products(FREQS_C),
              jm_on.rrl_rt_products(LINE, FREQS_L))
    for got, want in zip(on, off):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    spans = _spans(prof)
    cont, line = sorted(_named(spans, 'rajepy.rt.run'), key=lambda s: s[1])
    for run, children in ((cont, RUN_CHILDREN),
                          (line, RUN_CHILDREN + ('rajepy.rt.line_opacity',))):
        inside = {s[0] for s in spans if s is not run and _inside(s, run)}
        assert inside >= set(children), inside
        for name in children:
            assert sum(_inside(s, run) for s in _named(spans, name)) == 1
    assert not any(_inside(s, cont)
                   for s in _named(spans, 'rajepy.rt.line_opacity'))
    # the first run fills the grid: its KernelTimer, inside the statics
    fill, = _named(spans, FILL)
    statics = min(_named(spans, 'rajepy.rt.statics'), key=lambda s: s[1])
    assert _inside(fill, statics) and _inside(statics, cont)


def test_fit_spans_nest(model_params):
    jm = _model(model_params)
    obs = _observed(jm)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fit.fit_rrl_spectrum(jm, LINE, FREQS_L, obs, free=FREE,
                                   steps=2)
    assert res.loss.shape == (2,)
    spans = _spans(prof)
    run, = _named(spans, 'rajepy.fit.run')
    build, = _named(spans, 'rajepy.fit.build')
    steps = _named(spans, 'rajepy.fit.step')
    finish = _named(spans, 'rajepy.fit.finish')
    assert len(steps) == 2 and len(finish) == 2
    for s in [build] + steps + finish:
        assert _inside(s, run)
    for name in STEP_CHILDREN:
        got = _named(spans, name)
        assert len(got) == 2
        assert all(sum(_inside(c, s) for s in steps) == 1 for c in got)
    for s in [build] + finish:
        assert not any(_inside(s, st) or _inside(st, s) for st in steps)
    assert build[2] <= min(st[1] for st in steps)
    assert max(st[2] for st in steps) <= min(f[1] for f in finish)


def test_counters_count_runs_and_bytes_out(model_params):
    jm = _model(model_params, torch.float32)
    c = profiling.COUNTERS
    for call in (lambda a: jm.continuum_rt_products(FREQS_C, as_numpy=a),
                 lambda a: jm.rrl_rt_products(LINE, FREQS_L, as_numpy=a)):
        runs, out = c.get('rt.runs', 0), c.get('rt.products_out_bytes', 0)
        maps = call(True)
        assert c['rt.runs'] == runs + 1
        assert c['rt.products_out_bytes'] == out + sum(m.nbytes
                                                       for m in maps)
        assert sum(m.nbytes for m in maps) == 4 * 16 * 16 * (
            1 + 2 * len(maps[1]))
        call(False)
        assert c['rt.runs'] == runs + 2
        assert c['rt.products_out_bytes'] == out + sum(m.nbytes
                                                       for m in maps)


def _observing(params, dcy):
    """A pipeline of one continuum run (VLA A, 6 GHz, one channel, one
    scan of 3600 s in 60 s integrations cut to 4 time samples) on the
    small model."""
    empty = np.array([])
    pp = {'min_el': 20., 'dcys': {'model_dcy': str(dcy)},
          'continuum': {'times': np.array([1.]), 'freqs': np.array([6e9]),
                        't_obs': np.array([3600]),
                        'tscps': np.array([('VLA', 'A')]),
                        't_ints': np.array([60]), 'bws': np.array([1e8]),
                        'chanws': np.array([1e8])},
          'rrls': {'times': empty, 'lines': empty, 't_obs': empty,
                   'tscps': empty, 't_ints': empty, 'bws': empty,
                   'chanws': empty},
          'synthobs': {'max_time_samples': 4, 'niter': 20}}
    return Pipeline(_model(params), pp)


def test_observation_spans_nest_and_counters_count(model_params, tmp_path,
                                                   monkeypatch):
    pl = _observing(model_params, tmp_path)
    its = []
    hogbom = imaging.hogbom_clean

    def spy(*args, **kwargs):
        out = hogbom(*args, **kwargs)
        its.append(out[2])
        return out
    monkeypatch.setattr(imaging, 'hogbom_clean', spy)
    before = {k: profiling.COUNTERS.get(k, 0) for k in OBS_COUNTERS}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pl.execute_run(0, plot=False)
    spans = _spans(prof)
    run, = _named(spans, 'rajepy.obs.run')
    for name in OBS_STAGES:
        stage, = _named(spans, name)
        assert _inside(stage, run), name
    writes = _named(spans, 'rajepy.obs.write')
    assert len(writes) == 2 and all(_inside(w, run) for w in writes)
    first = {name: _named(spans, name)[0][1] for name in OBS_STAGES}
    assert sorted(first, key=first.get) == list(OBS_STAGES)
    # the stages cover the observation but for a little glue
    covered = sum(e - b for name in OBS_STAGES + ('rajepy.obs.write',)
                  for _, b, e in _named(spans, name))
    assert 0.9 * (run[2] - run[1]) <= covered <= run[2] - run[1]
    # the RT run comes before the observation, outside it
    rt, = _named(spans, 'rajepy.rt.run')
    assert rt[2] <= run[1]
    with np.load(pl.runs[0].products['ms_noisy']) as f:
        n_vis = f['vis_re'].size
    assert n_vis == 4 * 351
    assert len(its) == 1 and 0 < its[0] <= 20
    got = {k: profiling.COUNTERS[k] - before[k] for k in OBS_COUNTERS}
    assert got == {'obs.runs': 1, 'obs.visibilities': n_vis,
                   'obs.clean_iterations': its[0]}


def test_observation_without_profiler_enters_no_span(model_params, tmp_path,
                                                     monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(profiling, 'record_function', refuse)
    pl = _observing(model_params, tmp_path)
    assert profiling.span('rajepy.obs.run') is profiling.span('rajepy.x')
    pl.execute_run(0, plot=False)
    assert pl.runs[0].completed and pl.runs[0].results['imfit'] is not None
