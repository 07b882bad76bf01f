"""Pipeline — the multi-epoch, multi-frequency orchestrator (PyTorch port of
rajepy_tpu.pipeline).

API-compatible rebuild of the reference's ``Pipeline``
(classes.py:1970-2868): builds the run matrix (epochs x frequencies for the
continuum, epochs x lines for RRLs) and executes radiative transfer per run
with resume/clobber semantics and the reference's directory layout
(``<model_dcy>/Day<day>/<freq|line>/``).  State is checkpointed with pickle
exactly like the reference (save/load at classes.py:2215-2258, 1976-2017)
so pipelines resume across processes; the files interchange with the JAX
package's.

``execute`` runs each run of the list through ``execute_run``, which does
one run's whole per-run work and may be called alone (a single observed
run, without the campaign's pointings, plots and final checkpoint).
``execute(simobserve=True)`` runs the synthetic observations of continuum
and RRL runs (``synthobs``: uv tracks, visibilities, Briggs gridding,
CLEAN, restoration; imfit for continuum runs, restored cubes for RRL runs)
after each run's radiative transfer.  ``execute(plot=True)`` draws the
diagnostic figures of :mod:`.plotting` (matplotlib, imported only then):
the grid and mass-loss figures at the start, a model figure per epoch
directory and a radio SED per continuum epoch after the observations.

With two or more devices (``parallel.sharding.available_devices``: the
model's cards), ``execute`` computes the RT products of all pending runs in
a device fan-out (:mod:`.parallel.fanout`) before the per-run loop writes
them, and ``synthobs`` images line cubes channel-sharded; with one device
both run sequentially.

The products of a run leave the device in one copy: on a CUDA model the
three tensors go into pinned host buffers that the pipeline keeps from run
to run, and the FITS writers take numpy views of them.
"""
from __future__ import annotations

import os
import pickle
import time as _time
from typing import Dict, Optional, Union

import numpy as np
import torch

from . import constants as cnsts
from .io.fits import read_fits
from .models.jetmodel import JetModel
from .models.runs import ContinuumRun, RRLRun, _HDR, _UNITS, _fmt_row, \
    _tabulate
from .utils import misc as miscf
from .utils import profiling
from .utils.logger import Log
from .utils.validation import check_pline_params


def _relativise_home(path: str, home: str) -> str:
    """home -> '~' only as a path PREFIX: a bare str.replace corrupts
    paths that merely contain the home string as a substring
    ('/home/annex/...' with home '/home/ann')."""
    if path == home or path.startswith(home + os.sep):
        return '~' + path[len(home):]
    return path


def _expand_home(path: str, home: str) -> str:
    """'~' -> home only as a path PREFIX (inverse of _relativise_home);
    a literal '~' elsewhere in a path must survive a save/load round
    trip untouched."""
    if path == '~' or path.startswith('~' + os.sep):
        return home + path[1:]
    return path


_PORT = __name__.split('.')[0]
_JAX_PACKAGE_PREFIX = 'rajepy_tpu.'
_SAFE_BUILTINS = frozenset((
    'bool', 'bytearray', 'bytes', 'complex', 'dict', 'float', 'frozenset',
    'int', 'list', 'object', 'range', 'set', 'slice', 'str', 'tuple'))


class _PipelineUnpickler(pickle.Unpickler):
    """Reads a ``pipeline.save`` of either package.  The pickle names the
    run classes by module: a file written by the JAX package says
    ``rajepy_tpu.models.runs.ContinuumRun``, and importing that would pull
    in JAX.  Its module paths are mapped onto this package's; beyond that
    only numpy and a few builtin types are resolved."""

    def find_class(self, module: str, name: str):
        if module.startswith(_JAX_PACKAGE_PREFIX):
            module = _PORT + '.' + module[len(_JAX_PACKAGE_PREFIX):]
        top = module.split('.')[0]
        if top in (_PORT, 'numpy') or \
                (module == 'builtins' and name in _SAFE_BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"pipeline state names {module}.{name}, which is neither a "
            f"{_PORT} class, numpy nor a plain builtin type")


class Pipeline:
    """Creation of a physical jet model and FITS sky models
    (classes.py:1970-2868)."""

    @classmethod
    def load_pipeline(cls, load_file: str, dtype='auto',
                      device='cuda') -> "Pipeline":
        """Resume from a previously saved state (classes.py:1976-2017),
        written by this package or by the JAX package; the model is
        rebuilt on ``device`` at ``dtype`` (defaults as ``JetModel``'s)."""
        home = os.path.expanduser('~')
        load_file = os.path.expanduser(load_file)
        with open(load_file, 'rb') as f:
            loaded = _PipelineUnpickler(f).load()

        for run in loaded['runs']:
            run.dcy = _expand_home(run.dcy, home)
        loaded['model_file'] = _expand_home(loaded['model_file'], home)
        full_dcy = _expand_home(loaded['params']['dcys']['model_dcy'],
                                home)
        loaded['params']['dcys']['model_dcy'] = full_dcy

        jm = JetModel.load_model(loaded['model_file'], dtype=dtype,
                                 device=device)
        log = loaded.get('log')
        if log is None:
            dcy = os.path.dirname(loaded['model_file'])
            log = Log(os.sep.join(
                [dcy, os.path.basename(load_file).split('.')[0] + '.log']))
        new_pipeline = cls(jm, loaded['params'], log=log)
        new_pipeline.runs = loaded['runs']
        return new_pipeline

    @staticmethod
    def py_to_dict(py_file: str) -> Dict:
        """Import an executable-python pipeline params file and validate
        (classes.py:2019-2048)."""
        if not os.path.exists(py_file):
            raise FileNotFoundError(py_file + " does not exist")
        # execute by PATH, not by module import: __import__ caches on
        # the bare filename, so two different 'pipeline-params.py'
        # files loaded in one process would silently alias the first
        import runpy
        params = runpy.run_path(os.path.abspath(py_file))['params']
        err = check_pline_params(params)
        if err:
            raise err
        return params

    def __init__(self, jetmodel: JetModel, params: Union[dict, str],
                 log: Optional[Log] = None):
        if isinstance(jetmodel, JetModel):
            self.model = jetmodel
        else:
            raise TypeError("Supplied arg jetmodel must be JetModel instance"
                            " not {}".format(type(jetmodel)))

        if isinstance(params, dict):
            err = check_pline_params(params)
            if err:
                raise err
            self._params = params
        elif isinstance(params, str):
            self._params = Pipeline.py_to_dict(params)
        else:
            raise TypeError("Supplied arg params must be dict or full path "
                            "(str)")

        self.dcy = self.params['dcys']['model_dcy'].rstrip(os.sep)
        self.model_file = self.dcy + os.sep + "jetmodel.save"
        self.save_file = self.dcy + os.sep + "pipeline.save"
        self.ptgfile = self.dcy + os.sep + 'pointings.ptg'

        log_name = "Pipeline_{}.log".format(
            _time.strftime("%Y%m%d%H-%M-%S", _time.localtime()))
        if not os.path.exists(self.dcy):
            os.makedirs(self.dcy)
        self._log = log if log is not None else Log(
            fname=os.sep.join([self.dcy, log_name]))
        self.log.add_entry("INFO",
                           f"Pipeline directory is {self.dcy}")

        if self.model.log is None:
            self.model.log = self.log
        elif self.model.log is not self.log:
            new_log = Log.combine_logs(self.log, self.model.log,
                                       self.log.filename,
                                       delete_old_logs=True)
            self.log = self.model.log = new_log

        # Sort runs into time order (classes.py:2116-2125)
        for band in ('continuum', 'rrls'):
            if self.params[band]['times'] is not None:
                self.params[band]['times'] = np.sort(
                    np.asarray(self.params[band]['times']))
            else:
                self.params[band]['times'] = np.array([])

        # Run matrix (classes.py:2127-2178)
        runs = []
        cp = self.params['continuum']
        self.log.add_entry("INFO", "Reading continuum runs into pipeline")
        made_any = False
        for t in cp['times']:
            for idx2, freq in enumerate(np.atleast_1d(
                    np.asarray(cp['freqs'] if cp['freqs'] is not None
                               else []))):
                def pick(arr):
                    return (arr[idx2] if miscf.is_iter(arr) else arr)
                runs.append(ContinuumRun(
                    self.dcy, t, freq, pick(cp['bws']), pick(cp['chanws']),
                    pick(cp['t_obs']), pick(cp['t_ints']),
                    pick(cp['tscps'])))
                made_any = True
        if not made_any:
            self.log.add_entry("WARNING", "No continuum runs found")

        rp = self.params['rrls']
        self.log.add_entry(
            "INFO", "Reading radio recombination line runs into pipeline")
        made_any = False
        for t in rp['times']:
            for idx2, line in enumerate(np.atleast_1d(
                    np.asarray(rp['lines'] if rp['lines'] is not None
                               else []))):
                def pick(arr):
                    return (arr[idx2] if miscf.is_iter(arr) else arr)
                lte_arr = rp.get('lte')
                runs.append(RRLRun(
                    self.dcy, t, str(line), pick(rp['bws']),
                    pick(rp['chanws']), pick(rp['t_obs']),
                    pick(rp['t_ints']), pick(rp['tscps']),
                    lte=(bool(pick(lte_arr)) if lte_arr is not None
                         else True)))
                made_any = True
        if not made_any:
            self.log.add_entry("WARNING", "No RRL runs found")

        self._runs = runs
        self.log.add_entry("INFO", self.__str__())

    # ------------------------------------------------------------------ #
    def __str__(self):
        rows = []
        for run in self.runs:
            rows.append(_fmt_row([
                run.year, run.obs_type.capitalize(), run.tscop, run.t_obs,
                run.t_int,
                None if run.obs_type == 'continuum' else run.line,
                run.freq, run.bandwidth, run.chanwidth,
                run.radiative_transfer, run.simobserve, run.completed]))
        return _tabulate(rows, _HDR, _UNITS)

    # ------------------------------------------------------------------ #
    def save(self, save_file: str, absolute_directories: bool = False):
        """Pickle runs/params/model-file with ~-relativised paths
        (classes.py:2215-2258).

        Unlike the reference, the live object's paths are RESTORED after
        the dump: classes.py mutates ``run.dcy`` / ``params`` in place,
        so any further in-process use after ``execute()`` (which saves)
        saw literal '~'-prefixed paths — recomputing completed products
        and mkdir-ing a directory named '~'.
        """
        home = os.path.expanduser('~')
        rs = self.runs
        ps = self._params
        mf = self.model_file
        saved = None
        if not absolute_directories:
            saved = ([run.dcy for run in rs], ps['dcys']['model_dcy'])
            for run in rs:
                run.dcy = _relativise_home(run.dcy, home)
            ps['dcys']['model_dcy'] = _relativise_home(
                ps['dcys']['model_dcy'], home)
            mf = _relativise_home(mf, home)
        p = {"runs": rs, "params": ps, "model_file": mf, 'log': None}
        self.log.add_entry("INFO", "Saving pipeline to " + save_file)
        try:
            with miscf.atomic_write(save_file) as f:
                pickle.dump(p, f)
        finally:
            if saved is not None:
                for run, dcy in zip(rs, saved[0]):
                    run.dcy = dcy
                ps['dcys']['model_dcy'] = saved[1]

    # ------------------------------------------------------------------ #
    @property
    def params(self):
        return self._params

    @property
    def dcy(self):
        return self._dcy

    @dcy.setter
    def dcy(self, path):
        self._dcy = path

    @property
    def model(self):
        return self._model

    @model.setter
    def model(self, new_model):
        self._model = new_model

    @property
    def runs(self):
        return self._runs

    @runs.setter
    def runs(self, new_runs):
        self._runs = new_runs

    @property
    def log(self):
        return self._log

    @log.setter
    def log(self, new_log):
        self._log = new_log

    # ------------------------------------------------------------------ #
    def _prefan_rt_products(self, resume: bool, clobber: bool,
                            dryrun: bool, device_fanout) -> Dict[int, Dict]:
        """RT products of all pending runs computed by the device fan-out
        (:mod:`.parallel.fanout`) ahead of the per-run loop, which writes
        them: {run_idx: {'em', 'tau', 'flux'}} of numpy arrays.  Empty when
        the fan-out is off (one device, ``device_fanout=False``, or no group
        of two or more pending runs of one kind and channel count)."""
        from .parallel import fanout, sharding
        fanned: Dict[int, Dict] = {}
        if dryrun:
            return fanned
        n_dev = len(sharding.available_devices(self.model.device))
        if device_fanout is None:
            device_fanout = n_dev > 1
        if not device_fanout or n_dev < 2:
            return fanned

        def pending(run):
            if not run.radiative_transfer:
                return False
            if run.completed and resume and not clobber:
                return False
            return clobber or not (os.path.exists(run.fits_em) and
                                   os.path.exists(run.fits_tau) and
                                   os.path.exists(run.fits_flux))

        groups: Dict[tuple, list] = {}
        for idx, run in enumerate(self.runs):
            if not pending(run):
                continue
            nchan = len(np.atleast_1d(run.chan_freqs))
            # non-LTE RRL runs fan out too, with per-run departure
            # coefficients; grouped apart from LTE runs
            key = ('continuum', nchan) if run.obs_type == 'continuum' \
                else ('rrl', run.line, nchan, getattr(run, 'lte', True))
            groups.setdefault(key, []).append(idx)

        nx, nz = self.model.nx, self.model.nz
        itemsize = torch.empty((), dtype=self.model.dtype).element_size()
        cached_bytes = 0.0
        for key, idxs in groups.items():
            if len(idxs) < 2:
                continue  # nothing to fan out for a lone run
            # bound host memory: the fanned cache holds every run's tau
            # AND flux maps at once (the sequential loop holds one run's),
            # cumulatively over the groups until the loop pops them
            nchan = len(np.atleast_1d(self.runs[idxs[0]].chan_freqs))
            group_bytes = len(idxs) * nchan * nx * nz * itemsize * 2
            if cached_bytes + group_bytes > 8e9:
                self.log.add_entry(
                    "WARNING",
                    f"Skipping device fan-out for {len(idxs)} "
                    f"{key[0]} runs: cached products would need "
                    f"{(cached_bytes + group_bytes) / 1e9:.1f} GB of "
                    "host memory; running sequentially")
                continue
            cached_bytes += group_bytes
            years = [self.runs[i].year for i in idxs]
            freqs_mat = np.stack([np.atleast_1d(np.asarray(
                self.runs[i].chan_freqs, dtype=float)) for i in idxs])
            if key[0] == 'continuum':
                em, taus, fluxes = fanout.continuum_runs_fanout(
                    self.model, years, freqs_mat)
            else:
                b_pairs = None
                if not key[3]:
                    # each run's table coefficients at its model time, as
                    # the sequential rrl_rt_products derives them
                    t_saved = self.model.time
                    try:
                        pairs = []
                        for i in idxs:
                            self.model.time = \
                                self.runs[i].year * cnsts.YEAR
                            pairs.append(
                                self.model.departure_coefficients(key[1]))
                    finally:
                        self.model.time = t_saved
                    b_pairs = np.asarray(pairs, dtype=float)
                em, taus, fluxes = fanout.rrl_runs_fanout(
                    self.model, key[1], years, freqs_mat, contsub=False,
                    b_pairs=b_pairs)
            for k, i in enumerate(idxs):
                fanned[i] = {'em': em[k], 'tau': taus[k], 'flux': fluxes[k]}
            self.log.add_entry(
                "INFO",
                f"Fanned {len(idxs)} {key[0]} runs' radiative transfer "
                f"across {n_dev} devices")
        return fanned

    def execute(self, simobserve=True, verbose=True, dryrun=False,
                resume=True, clobber=False, plot=True, device_fanout=None):
        """Execute all runs: radiative transfer, FITS products, synthetic
        observations, imaging and source fitting (classes.py:2296-2868).

        The signature is the JAX package's.  ``simobserve=True`` observes
        every run configured with a telescope
        (``synthobs.simulate_observation``, with the keyword overrides of
        ``params['synthobs']``; for RRL runs without the continuum-only
        ones, as in the JAX package).  ``plot=True`` writes
        ``GridPlot.pdf`` and ``JMLPlot.pdf`` under the pipeline directory,
        ``ModelPlot.pdf`` in each epoch's directory and, after synthetic
        observations, ``RadioSED<year>yrPlot.{png,pdf}`` per continuum
        epoch; their time, less a grid fill they start, is recorded as the
        stage ``plots``.  ``device_fanout`` is the run-level multi-device
        fan-out (:mod:`.parallel.fanout`): None (the default) fans out
        whenever ``parallel.sharding.available_devices`` holds two or more
        devices, computing all pending runs' RT products before the per-run
        loop writes them; False forces the sequential loop, and with it
        unsharded cube imaging; with one device it does nothing."""
        self.log.add_entry("INFO", "Beginning pipeline execution")
        if verbose != self.log.verbose:
            self.log.verbose = verbose

        if simobserve:
            from .ops import astronomy as astro
            ra_deg = astro.parse_ra(self.model.params['target']['ra'])
            dec_deg = astro.parse_dec(self.model.params['target']['dec'])
            ptg_txt = "#Epoch     RA          DEC      TIME(optional)\n"
            ptg_txt += f"J2000 {astro.format_hmsdms(ra_deg, dec_deg)} "
            self.log.add_entry(
                "INFO", "Creating pointings and writing to file, "
                        f"{self.ptgfile}, for synthetic observations")
            with open(self.ptgfile, 'wt') as f:
                f.write(ptg_txt)

        if resume and os.path.exists(self.model_file):
            # on the device and at the precision of the model it replaces
            self.model = JetModel.load_model(self.model_file,
                                             dtype=self.model.dtype,
                                             device=self.model.device)

        if plot:
            from .plotting import functions as pfunc
            with profiling.KernelTimer("plots"):
                pfunc.geometry_plot(
                    self.model, show_plot=False,
                    savefig=os.sep.join([self.dcy, 'GridPlot.pdf']))
                pfunc.jml_profile_plot(
                    self, show_plot=False,
                    savefig=os.sep.join([self.dcy, 'JMLPlot.pdf']))

        fanned = self._prefan_rt_products(resume, clobber, dryrun,
                                          device_fanout)

        for idx in range(len(self.runs)):
            self._execute_run(idx, fanned.pop(idx, None), device_fanout,
                              simobserve=simobserve, resume=resume,
                              clobber=clobber, plot=plot, dryrun=dryrun)

        if not dryrun and simobserve and plot:
            for year in self.params['continuum']['times']:
                save_file = os.sep.join(
                    [self.dcy, f'RadioSED{year:.1f}yrPlot.png'])
                self.log.add_entry(
                    "INFO", "Saving radio SED figure to "
                            f"{save_file.replace('png', '(png,pdf)')} for "
                            f"time {year}yr")
                with profiling.KernelTimer("plots"):
                    pfunc.sed_plot(self, year, savefig=save_file)

        ckpt_t0 = _time.perf_counter()
        self.save(self.save_file)
        self.model.save(self.model_file)
        profiling.record_stage("checkpoint write",
                               _time.perf_counter() - ckpt_t0)
        return None

    def execute_run(self, idx: int, simobserve=True, resume=True,
                    clobber=False, plot=True, dryrun=False):
        """Execute run ``idx`` of the run list, as ``execute`` does for each
        run: set the model time, compute the RT products and copy them out,
        write the three FITS products, save the pipeline state (and the
        model, if no checkpoint exists yet), observe it
        (``synthobs.simulate_observation`` with the overrides of
        ``params['synthobs']``) and mark it completed.  The keywords are
        ``execute``'s.  The run computes its own products and its cube
        imaging is sharded as ``shard_imaging``'s default says."""
        self._execute_run(idx, None, None, simobserve=simobserve,
                          resume=resume, clobber=clobber, plot=plot,
                          dryrun=dryrun)

    def _execute_run(self, idx: int, fan: Optional[Dict[str, np.ndarray]],
                     device_fanout, simobserve, resume, clobber, plot,
                     dryrun):
        """:meth:`execute_run`, given the fan-out's products of the run
        (``fan``; None: compute them) and ``execute``'s
        ``device_fanout``."""
        run = self.runs[idx]
        self.model.time = run.year * cnsts.YEAR
        self.log.add_entry(
            "INFO", "Executing run #{} -> Details:\n{}".format(
                idx + 1, str(run)))
        if run.completed and resume and not clobber:
            self.log.add_entry(
                "INFO", f"Run #{idx + 1} previously completed, skipping",
                timestamp=False)
            return
        try:
            if run.rt_dcy and not os.path.exists(run.rt_dcy):
                self.log.add_entry(
                    "INFO", f"{run.rt_dcy} doesn't exist, creating",
                    timestamp=False)
                os.makedirs(run.rt_dcy)

            if plot and run.rt_dcy:
                model_plotfile = os.sep.join(
                    [os.path.dirname(run.rt_dcy), "ModelPlot.pdf"])
                if not os.path.exists(model_plotfile) or clobber:
                    from .plotting import functions as pfunc
                    with profiling.KernelTimer("plots"):
                        pfunc.model_plot(self.model,
                                         savefig=model_plotfile,
                                         show_plot=False)

            if not dryrun and run.radiative_transfer:
                self.log.add_entry(
                    "INFO",
                    "Conducting radiative transfer at "
                    f"{run.freq / 1e9:.1f}GHz for a model time of "
                    f"{run.year:.1f}yr")
                rt_t0 = _time.perf_counter()
                write_t0 = _time.perf_counter()
                if fan is None and (clobber or not (
                        os.path.exists(run.fits_em) and
                        os.path.exists(run.fits_tau) and
                        os.path.exists(run.fits_flux))):
                    # all products fresh: ONE pass computes EM + tau +
                    # flux together (JetModel.continuum_rt_products /
                    # rrl_rt_products), then the writes below consume
                    # the host copies.  as_numpy=False keeps the
                    # device->host copy OUT of the device-compute
                    # timer
                    with profiling.KernelTimer(
                            "rt stage: device compute", self.log) as kt:
                        if run.obs_type == 'continuum':
                            maps = self.model.continuum_rt_products(
                                run.chan_freqs, as_numpy=False)
                        else:
                            maps = self.model.rrl_rt_products(
                                run.line, run.chan_freqs, contsub=False,
                                lte=getattr(run, 'lte', True),
                                as_numpy=False)
                        kt.set_result(maps[2])
                    write_t0 = _time.perf_counter()
                    fan = dict(zip(('em', 'tau', 'flux'),
                                   self.model.products_to_host(maps)))
                    del maps
                    # a part of the "product transfer + FITS write"
                    # stage below, recorded on its own as well
                    profiling.record_stage(
                        "rt stage: product transfer",
                        _time.perf_counter() - write_t0)

                # NB within every write guard below fan is non-None:
                # fan skips computing only when all three products
                # exist and clobber is False, which falsifies the
                # guards
                if not os.path.exists(run.fits_em) or clobber:
                    self.log.add_entry(
                        "INFO",
                        f"Emission measures saved to {run.fits_em}")
                    self.model.save_fits(
                        miscf.reorder_axes(fan['em'], ra_axis=0,
                                           dec_axis=1),
                        run.fits_em, 'em')
                else:
                    self.log.add_entry(
                        "INFO", "Emission measures already exist -> "
                                f"{run.fits_em}", timestamp=False)

                if not os.path.exists(run.fits_tau) or clobber:
                    self.log.add_entry(
                        "INFO", "Computing optical depths and "
                                f"saving to {run.fits_tau}")
                    self.model._save_rt_fits(
                        fan['tau'], run.fits_tau, 'tau',
                        run.chan_freqs, False, True)
                if not os.path.exists(run.fits_flux) or clobber:
                    self.log.add_entry(
                        "INFO", "Calculating fluxes and saving to "
                                f"{run.fits_flux}")
                    fluxes = fan['flux']
                    self.model._save_rt_fits(
                        fluxes, run.fits_flux, 'flux',
                        run.chan_freqs, False, True)
                else:
                    fluxes = read_fits(run.fits_flux)[0]

                fluxes = np.asarray(fluxes)
                if run.obs_type == 'continuum':
                    # average over channels, sum over pixels
                    # (classes.py:2461-2467)
                    flux = float(np.nansum(np.nanmean(fluxes, axis=0)))
                    self.log.add_entry(
                        "INFO", "Total, average, channel flux of "
                                f"{flux:.2e}Jy calculated")
                else:
                    # per-channel summed fluxes (classes.py:2468-2471)
                    flux = np.nansum(np.nansum(fluxes, axis=1), axis=1)
                self.runs[idx].results['flux'] = flux
                # the model's pinned blocks go back to its pool here
                del fan, fluxes
                profiling.record_stage(
                    "rt stage: product transfer + FITS write",
                    _time.perf_counter() - write_t0)
                self.log.add_entry(
                    "INFO", "[timing] rt stage (compute + FITS): "
                    f"{_time.perf_counter() - rt_t0:.3f}s",
                    timestamp=False)

                ckpt_t0 = _time.perf_counter()
                if not os.path.exists(self.model_file):
                    self.model.save(self.model_file)
                self.save(self.save_file, absolute_directories=True)
                profiling.record_stage("checkpoint write",
                                       _time.perf_counter() - ckpt_t0)

        except KeyboardInterrupt:
            self.log.add_entry(
                "ERROR", "Pipeline interrupted by user, saving state")
            self.save(self.save_file)
            self.model.save(self.model_file)
            raise KeyboardInterrupt("Pipeline interrupted by user")

        # Synthetic observations — CASA-free, on the model's device
        # (replaces classes.py:2490-2851)
        if simobserve and run.simobserve and not dryrun:
            from .synthobs import simulate_observation
            self.log.add_entry(
                "INFO", "Running CASA-free synthetic observation "
                        f"({run.tscop[0]} config {run.tscop[1]})")
            # optional 'synthobs' params section: keyword overrides
            # forwarded to every run (thermalnoise/user_pwv,
            # weighting/robust/niter, uvtaper_as/pbcor, ...)
            so_kwargs = dict(self.params.get('synthobs') or {})
            so_kwargs.setdefault('min_el', self.params['min_el'])
            # stage-level resume: a rerun after an imaging-stage
            # failure reuses the pre-imaging visibility sets (same
            # model/plan/seed signature) instead of resampling
            so_kwargs.setdefault('reuse_vis', resume and not clobber)
            # device_fanout=False also pins cube imaging to the
            # unsharded CLEAN, so that a sequential execute is
            # sequential throughout
            if device_fanout is False:
                so_kwargs.setdefault('shard_imaging', False)
            if run.obs_type != 'continuum':
                # continuum-only knobs are stripped rather than
                # failing the line runs: a params file asking for
                # selfcal means "where applicable", and cube runs
                # always use the channel-batched Hogbom
                for k in ('selfcal', 'selfcal_solint_s',
                          'selfcal_rounds'):
                    so_kwargs.pop(k, None)
                if so_kwargs.get('deconvolver') in (
                        'multiscale', 'clark', 'mtmfs'):
                    for k in ('deconvolver', 'scales',
                              'smallscalebias', 'nterms', 'reffreq',
                              'cycleniter'):
                        so_kwargs.pop(k, None)
            products = simulate_observation(self, run, **so_kwargs)
            run.products.update(products)
            if run.obs_type == 'continuum' and \
                    'imfit' in run.results and \
                    run.results['imfit'] is None:
                self.log.add_entry(
                    "ERROR", f"Run #{idx + 1}'s source fit failed")

        # A run is complete only when every stage it is configured
        # for has actually run this call (or was found on disk): the
        # reference marks completed=True even under dryrun=True or
        # simobserve=False (classes.py:2853), which poisons a later
        # resume=True execute into skipping all real work — a
        # deliberate fidelity deviation (PARITY.md).
        rt_done = (not run.radiative_transfer) or not dryrun
        so_done = (not run.simobserve) or (simobserve and not dryrun)
        if rt_done and so_done:
            self.runs[idx].completed = True

    def radio_plot(self, run, percentile: float = 5.0, savefig: str = ''):
        """Plot flux/tau/EM from a run's FITS products
        (classes.py:3015-3183)."""
        from .plotting import functions as pfunc
        return pfunc.radio_plot(self.model, run, percentile=percentile,
                                savefig=savefig)
