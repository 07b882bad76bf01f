#!/usr/bin/env python3
"""Command-line entry point (reference: main.py:14-87, same flags; the
PyTorch port of rajepy_tpu.main).

Usage:
    python -m rajepy_tpu_torch.main [-v] [-rt] [-so] [-r] [-c] \
        model_param_file pipeline_param_file

With no arguments it runs the bundled example parameter files as a dry
run.  The model runs on the port's default device, ``'cuda'``, and the
command fails where no GPU exists; :func:`main` takes ``device`` and
``dtype`` as keywords (``main([...], device='cpu')`` runs on the CPU).
The pipeline's figures are drawn where matplotlib can be imported; where
it cannot, the log says so and the run goes on without them.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="rajepy_tpu_torch",
        description="GPU radiative transfer and synthetic radio "
                    "observations of ionised YSO jets")
    parser.add_argument("model_param_file",
                        help="Full path to model parameter file", type=str)
    parser.add_argument("pipeline_param_file",
                        help="Full path to pipeline parameter file",
                        type=str)
    parser.add_argument("-v", "--verbose",
                        help="Increase output verbosity",
                        action="store_true")
    parser.add_argument("-rt", "--radiative-transfer",
                        help="Compute radiative transfer solutions",
                        action="store_true")
    parser.add_argument("-so", "--simobserve",
                        help="Conduct synthetic observations (on-device, "
                             "CASA-free)", action="store_true")
    parser.add_argument("-r", "--resume",
                        help="Resume previous pipeline run if present",
                        action="store_true")
    parser.add_argument("-c", "--clobber",
                        help="Overwrite any data products/files present",
                        action="store_true")
    return parser


def _figures(log) -> bool:
    """Whether ``execute`` can draw its figures: matplotlib imports."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        log.add_entry("WARNING", "matplotlib cannot be imported: the "
                                 "pipeline's figures are skipped")
        return False
    return True


def main(argv=None, *, device='cuda', dtype='auto'):
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    executed :class:`Pipeline`.  ``device`` and ``dtype`` are passed to
    the :class:`JetModel`."""
    from rajepy_tpu_torch import JetModel, Pipeline, cfg, logger

    if argv is None and len(sys.argv) == 1:
        # No arguments: run the bundled example parameter files as a
        # dry-run smoke test (the reference's no-args path, main.py:69-77)
        jet_param_file = os.path.join(cfg.dcys['files'],
                                      'example-model-params.py')
        pline_param_file = os.path.join(cfg.dcys['files'],
                                        'example-pipeline-params.py')
        pline = Pipeline(JetModel(jet_param_file, dtype=dtype,
                                  device=device), pline_param_file)
        pline.execute(resume=False, clobber=False, simobserve=False,
                      dryrun=True, plot=_figures(pline.log))
        return pline

    args = build_parser().parse_args(argv)
    jet_param_file = os.path.abspath(args.model_param_file)
    pline_param_file = os.path.abspath(args.pipeline_param_file)

    pline_params = Pipeline.py_to_dict(pline_param_file)

    # Shared log for JetModel and Pipeline (main.py:49-58)
    log_name = ("ModelRun_" +
                time.strftime("%Y-%m-%d-%H:%M:%S", time.localtime()) +
                ".log")
    model_dcy = os.path.expanduser(pline_params['dcys']['model_dcy'])
    os.makedirs(model_dcy, exist_ok=True)
    log = logger.Log(fname=os.path.join(model_dcy, log_name),
                     verbose=args.verbose)

    pline = Pipeline(JetModel(jet_param_file, log=log, dtype=dtype,
                              device=device), pline_params, log=log)
    pline.log.add_entry(
        "INFO", "Pipeline initiated using model parameters defined in "
                f"{jet_param_file}, and pipeline parameters defined in "
                f"{pline_param_file}")
    pline.execute(resume=args.resume, clobber=args.clobber,
                  simobserve=args.simobserve, verbose=args.verbose,
                  dryrun=not args.radiative_transfer,
                  plot=_figures(pline.log))

    # Copy the parameter files into the output directory (main.py:79-87)
    for f in (jet_param_file, pline_param_file):
        dest = os.path.join(model_dcy, os.path.basename(f))
        if os.path.abspath(f) != os.path.abspath(dest):
            try:
                shutil.copyfile(f, dest)
            except shutil.SameFileError:
                pass
    return pline


if __name__ == '__main__':
    main()
