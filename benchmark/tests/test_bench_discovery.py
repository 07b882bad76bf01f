"""A cell, a traffic mix, a kind of request, its limits and a per-layer
metric added as files and entries are found by their names, with no file
of the harness edited."""
import json
import os
import shutil

from benchmark.harness import core


def _add(root, rel, text):
    path = os.path.join(root, rel)
    with open(path, 'w') as f:
        f.write(text)


def test_new_cell_and_metric_are_found(tiny):
    root = tiny.root
    _add(root, 'benchmark/traffic/sed4_runs.json', json.dumps({
        'kind': 'continuum_runs', 'why': 'four channels',
        'freqs_hz': {'geomspace': [1e9, 1e11, 4]}, 'epochs_yr': [1.0, 3.0],
        'sample_runs': 1, 'trace_requests': 3}))
    _add(root, 'benchmark/limits/example_jet_512.sed4_runs.json',
         json.dumps({'em_gap': 1e-6, 'tau_gap': 1e-6, 'flux_gap': 1e-6}))
    _add(root, 'benchmark/metrics/traced_requests.py',
         'def read(ctx):\n    return float(ctx.requests)\n')
    bench = tiny.bench
    bench['workloads'].append({'name': 'example_jet_512.sed4_runs',
                               'config': 'example_jet_512',
                               'traffic': 'sed4_runs', 'chips': 1,
                               'why': 'four channels'})
    bench['per_layer'].append({
        'name': 'traced_requests', 'unit': 'runs', 'better': 'higher',
        'source': 'program_counter', 'layer': 'run entry',
        'moves': 'runs_per_s', 'workloads': ['example_jet_512.sed4_runs']})
    for m in bench['end_to_end']:
        if m['name'] == 'runs_per_s':
            m['workloads'].append('example_jet_512.sed4_runs')
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    spec = core.Spec(root)
    out = core.run_cell('example_jet_512.sed4_runs', 11, 0.2, False, 'cpu',
                        spec=spec)
    assert out['correct'] and set(out['metrics']) == {
        'setup_s', 'runs_per_s', 'peak_mem_gib'}
    traced = core.run_cell('example_jet_512.sed4_runs', 12, 0.2, True,
                           'cpu', spec=spec)
    assert traced['metrics']['traced_requests']['value'] == 3.0
    assert list(traced)[-1] == 'checks'


def test_new_kind_of_request_is_found(tiny):
    root = tiny.root
    kinds = os.path.join(root, 'benchmark', 'kinds')
    shutil.copy(os.path.join(kinds, 'continuum_runs.py'),
                os.path.join(kinds, 'light_runs.py'))
    _add(root, 'benchmark/kinds/light_runs.py',
         open(os.path.join(kinds, 'light_runs.py')).read() +
         '\n\nWorkload.unit = "light run"\n')
    _add(root, 'benchmark/traffic/light2_runs.json', json.dumps({
        'kind': 'light_runs', 'why': 'two channels',
        'freqs_hz': {'geomspace': [1e9, 1e10, 2]}, 'epochs_yr': [0.0, 1.0],
        'sample_runs': 1, 'trace_requests': 2}))
    _add(root, 'benchmark/limits/example_jet_shipped.light2_runs.json',
         json.dumps({'em_gap': 1e-6, 'tau_gap': 1e-6, 'flux_gap': 1e-6}))
    bench = tiny.bench
    bench['workloads'].append({'name': 'example_jet_shipped.light2_runs',
                               'config': 'example_jet_shipped',
                               'traffic': 'light2_runs', 'chips': 1,
                               'why': 'two channels'})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    spec = core.Spec(root)
    cell = spec.cell('example_jet_shipped.light2_runs')
    assert spec.workload(cell, 1, 'cpu').unit == 'light run'
    out = core.run_cell(cell['name'], 13, 0.2, False, 'cpu', spec=spec)
    assert out['correct'] and set(out['metrics']) == {'setup_s',
                                                      'peak_mem_gib'}
