"""The port's CLI, ``python -m rajepy_tpu_torch.main`` with the reference's
flags (-v -rt -so -r -c), driven in-process through ``main(argv,
device='cpu')``, beside the JAX package's ``tests/test_cli.py``."""
import copy
import glob
import os
import sys

import numpy as np
import pytest
import torch

from rajepy_tpu_torch import JetModel, Pipeline, cfg
from rajepy_tpu_torch.io.fits import read_fits
from rajepy_tpu_torch.main import build_parser, main
from tests.torch_one_thread import one_thread  # noqa: F401


def _write_params(obj, path):
    """Write a dict as an executable-.py param file (py_to_dict schema).
    repr(np.ndarray) round-trips through the 'array' alias."""
    with open(path, 'w') as f:
        f.write("import numpy as np\n"
                "from numpy import array, float64, int64\n"
                "nan = float('nan')\n"
                f"params = {obj!r}\n")


@pytest.fixture
def param_files(model_params, tmp_path):
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=16, n_y=40, n_z=16)
    pline = {
        'min_el': 20.,
        'dcys': {'model_dcy': str(tmp_path / 'out')},
        'continuum': {'times': np.array([0.]),
                      'freqs': np.array([6e9]),
                      't_obs': np.array([1200]),
                      'tscps': np.array([('VLA', 'B')]),
                      't_ints': np.array([60]),
                      'bws': np.array([1e8]),
                      'chanws': np.array([1e8])},
        'rrls': {'times': np.array([]), 'lines': np.array([]),
                 't_obs': np.array([]), 'tscps': np.array([]),
                 't_ints': np.array([]), 'bws': np.array([]),
                 'chanws': np.array([])},
        'synthobs': {'niter': 100},
    }
    mf = str(tmp_path / 'model-params.py')
    pf = str(tmp_path / 'pipeline-params.py')
    _write_params(p, mf)
    _write_params(pline, pf)
    return mf, pf, str(tmp_path / 'out')


def test_parser_flags():
    args = build_parser().parse_args(['-v', '-rt', '-so', '-r', '-c',
                                      'm.py', 'p.py'])
    assert args.verbose and args.radiative_transfer and args.simobserve
    assert args.resume and args.clobber
    assert args.model_param_file == 'm.py'
    assert args.pipeline_param_file == 'p.py'
    args = build_parser().parse_args(['m.py', 'p.py'])
    assert not (args.verbose or args.radiative_transfer or
                args.simobserve or args.resume or args.clobber)
    with pytest.raises(SystemExit):
        build_parser().parse_args(['--device', 'cpu', 'm.py', 'p.py'])


def test_cli_dryrun_writes_nothing(param_files):
    mf, pf, out = param_files
    pline = main([mf, pf], device='cpu')           # no -rt: dryrun
    assert len(pline.runs) == 1
    assert not pline.runs[0].completed
    assert pline.model.device.type == 'cpu'
    assert not glob.glob(os.path.join(out, 'Day*', '*', '*.fits'))
    assert glob.glob(os.path.join(out, 'ModelRun_*.log'))


def test_cli_rt_and_so_end_to_end(param_files):
    """-rt -so -c: radiative transfer and the synthetic observation of the
    run, the shared log and the param files copied into model_dcy; the
    same products as a direct Pipeline.execute of the same files."""
    mf, pf, out = param_files
    pline = main(['-rt', '-so', '-c', mf, pf], device='cpu')
    run = pline.runs[0]
    assert run.completed
    assert os.path.exists(run.fits_flux)
    assert os.path.exists(run.products['clean_image'])
    assert run.results['imfit'] is not None
    # param files copied into the output directory (main.py:79-87)
    for name in ('model-params.py', 'pipeline-params.py'):
        with open(os.path.join(out, name)) as a, \
                open(os.path.dirname(mf) + os.sep + name) as b:
            assert a.read() == b.read()
    logs = glob.glob(os.path.join(out, 'ModelRun_*.log'))
    assert len(logs) == 1 and pline.log.filename == logs[0]
    with open(logs[0]) as f:
        text = f.read()
    assert 'Pipeline initiated using model parameters defined in ' \
        f'{mf}' in text
    assert '[timing] synthobs: mfs imaging (500px)' in text
    # a direct call with the same files builds the same pipeline
    direct = Pipeline(JetModel(mf, device='cpu'), Pipeline.py_to_dict(pf))
    assert [(r.year, r.freq, r.tscop, r.rt_dcy) for r in direct.runs] == \
        [(r.year, r.freq, r.tscop, r.rt_dcy) for r in pline.runs]
    img, _ = read_fits(run.products['clean_image'])
    direct.execute(resume=False, clobber=True, verbose=False, plot=False)
    np.testing.assert_array_equal(
        read_fits(direct.runs[0].products['clean_image'])[0], img)


def test_cli_resume_skips_completed(param_files):
    mf, pf, out = param_files
    pline = main(['-rt', mf, pf], device='cpu')
    # RT-only: the run still owes its configured synthetic observation,
    # so it must NOT be marked completed (PARITY.md)
    assert not pline.runs[0].completed
    flux0 = os.path.getmtime(pline.runs[0].fits_flux)
    # resume with -so: the RT FITS products are reused (not rewritten),
    # synthobs runs, and the run completes
    pline = main(['-rt', '-so', '-r', mf, pf], device='cpu')
    assert pline.runs[0].completed
    assert os.path.getmtime(pline.runs[0].fits_flux) == flux0
    assert os.path.exists(pline.runs[0].products['clean_image'])


def test_param_files_do_not_alias_by_name(model_params, tmp_path):
    """Two different param files with the SAME basename must not alias."""
    d1, d2 = tmp_path / 'a', tmp_path / 'b'
    d1.mkdir(), d2.mkdir()
    p1 = copy.deepcopy(model_params)
    p2 = copy.deepcopy(model_params)
    p2['properties']['T_0'] = 12345.0
    _write_params(p1, str(d1 / 'model-params.py'))
    _write_params(p2, str(d2 / 'model-params.py'))
    r1 = JetModel.py_to_dict(str(d1 / 'model-params.py'))
    r2 = JetModel.py_to_dict(str(d2 / 'model-params.py'))
    assert r1['properties']['T_0'] != r2['properties']['T_0']
    assert r2['properties']['T_0'] == 12345.0


def test_no_arguments_dry_runs_the_bundled_files(monkeypatch, tmp_path):
    """With no arguments the CLI dry-runs the bundled example files: the
    bundled campaign's run table, no FITS product, output under the
    bundled model_dcy (~/rajepy_tpu_output).  The figures of the dry run
    are left out here (tests/test_torch_plotting.py draws them)."""
    from rajepy_tpu_torch import main as cli
    monkeypatch.setenv('HOME', str(tmp_path))
    monkeypatch.setattr(sys, 'argv', ['rajepy_tpu_torch'])
    monkeypatch.setattr(cli, '_figures', lambda log: False)
    pline = main(device='cpu')
    assert [r.obs_type for r in pline.runs] == ['continuum'] * 6
    assert not any(r.completed for r in pline.runs)
    bundled = JetModel.py_to_dict(os.path.join(
        cfg.dcys['files'], 'example-model-params.py'))
    assert pline.model.params['target'] == bundled['target']
    out = os.path.join(str(tmp_path), 'rajepy_tpu_output')
    assert pline.dcy == out
    assert not glob.glob(os.path.join(out, '**', '*.fits'), recursive=True)


def test_main_defaults_to_the_card(param_files):
    """Without ``device``, main builds the model on 'cuda' and raises where
    no GPU exists: there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    mf, pf, out = param_files
    with pytest.raises(RuntimeError, match='CUDA'):
        main(['-rt', mf, pf])
    assert not glob.glob(os.path.join(out, 'Day*'))


def test_console_script_names_the_cli():
    """pyproject.toml installs ``rajepy-tpu-torch`` as this main."""
    import importlib
    import tomllib
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'pyproject.toml'), 'rb') as f:
        scripts = tomllib.load(f)['project']['scripts']
    mod, fn = scripts['rajepy-tpu-torch'].split(':')
    assert getattr(importlib.import_module(mod), fn) is main
