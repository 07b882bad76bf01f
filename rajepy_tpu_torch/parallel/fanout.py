"""Run-level device fan-out for the pipeline's RT stage (PyTorch port of
rajepy_tpu.parallel.fanout).

The runs of the pipeline matrix (epochs x frequencies for the continuum,
epochs x lines for RRLs) are embarrassingly parallel: only the epoch time
(through the burst factor chi) and the channel frequencies differ between
them, while every expensive static (field cubes, the factorised base
cubes, their jet-occupied tiles, the LOS-mean temperature) is shared.

``continuum_runs_fanout`` / ``rrl_runs_fanout`` split a group of runs over
a 1-D ('run',) mesh (unevenly where the count does not divide; nothing is
padded).  Each shard computes its runs with the per-run method the
sequential ``Pipeline.execute`` loop calls (``continuum_rt_products`` /
``rrl_rt_products``: K2, and for RRL runs K4, on a float32 model with
bursts) at each run's epoch, on the model's statics on its device
(``JetModel._replica``: a cube is copied to another device the first time
a run there reads it, so only the cubes the runs read are copied, and none
where the device is the model's own).  Every shard's work is issued before
any product is copied out, so the devices overlap; the fanned products are
the sequential ones bit for bit on the same device, and each run's are
copied to the host as a sequential run's are (``JetModel.products_to_host``
of the replica that computed them).  The host then writes each run's FITS
products as the sequential path does (``Pipeline.execute`` consults the
fanned cache before calling the model).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import constants as cnsts
from . import sharding


def run_mesh(mesh: Optional[sharding.Mesh] = None,
             device=None) -> sharding.Mesh:
    """A 1-D ('run',) mesh over the devices of ``mesh``, or over
    ``sharding.available_devices(device)`` (``device`` defaults to the
    card when there is one)."""
    if mesh is not None:
        devices = list(mesh.devices.ravel())
    else:
        devices = sharding.available_devices(
            device if device is not None else sharding._default_device())
    return sharding.Mesh(devices, ('run',))


def _runs(model, years, freqs_mat, mesh):
    """(times [s], channel frequencies, [(replica, run indices)]): the
    runs split over the run mesh, each shard with the model's replica on
    its device."""
    times = np.atleast_1d(np.asarray(years, dtype=float)) * cnsts.YEAR
    freqs = np.atleast_2d(np.asarray(freqs_mat, dtype=float))
    if freqs.shape[0] != times.shape[0]:
        raise ValueError(f"{freqs.shape[0]} rows of frequencies for "
                         f"{times.shape[0]} runs")
    devs = run_mesh(mesh, model.device).devices
    shards = [(model._replica(d), idx) for d, idx in
              zip(devs, np.array_split(np.arange(times.size), len(devs)))
              if idx.size]
    return times, freqs, shards


def _to_host(products):
    """Per run ``(replica, (em, tau, flux))`` -> three numpy arrays with a
    leading run axis: each run's maps copied out by the replica that
    computed them (``JetModel.products_to_host``) and dropped in turn."""
    out = None
    for k in range(len(products)):
        rep, maps = products[k]
        products[k] = None
        host = rep.products_to_host(maps)
        if out is None:
            out = [np.empty((len(products),) + h.shape, h.dtype)
                   for h in host]
        for i in range(len(host)):
            out[i][k] = host[i]
        del maps, host       # the run's device maps, its host blocks
    return tuple(out)


def continuum_runs_fanout(model, years, freqs_mat,
                          mesh: Optional[sharding.Mesh] = None):
    """All continuum runs of one channel count, split over the devices.

    ``years``: (n_runs,) epoch times [yr]; ``freqs_mat``: (n_runs, n_chan)
    channel frequencies [Hz].  Returns numpy ``(em, taus, fluxes)`` of
    shapes (n_runs, nx, nz) / (n_runs, n_chan, nx, nz) x2, each run's
    ``continuum_rt_products`` at its epoch (classes.py:2397-2423 per-run
    products)."""
    times, freqs, shards = _runs(model, years, freqs_mat, mesh)
    products = [None] * times.size
    for rep, idx in shards:
        for k in idx:
            rep.time = times[k]
            products[k] = rep, rep.continuum_rt_products(freqs[k],
                                                         as_numpy=False)
    return _to_host(products)


def rrl_runs_fanout(model, line: str, years, freqs_mat,
                    mesh: Optional[sharding.Mesh] = None,
                    contsub: bool = False, b_pairs=None):
    """All epochs of one RRL line, split over the devices.

    Returns numpy ``(em, tau_l, fluxes)``: per run, ``rrl_rt_products``
    at its epoch (classes.py:2437-2450 per-run products).

    ``b_pairs``: optional (n_runs, 2) per-run departure coefficients
    (b_n1, b_n2), host scalars (``JetModel.departure_coefficients`` at each
    run's epoch), which switch the runs to the G&S non-LTE form."""
    times, freqs, shards = _runs(model, years, freqs_mat, mesh)
    if b_pairs is not None:
        b_pairs = np.atleast_2d(np.asarray(b_pairs, dtype=float))
        if b_pairs.shape != (times.size, 2):
            raise ValueError(f"b_pairs shape {b_pairs.shape} != "
                             f"({times.size}, 2)")
    products = [None] * times.size
    for rep, idx in shards:
        for k in idx:
            rep.time = times[k]
            products[k] = rep, rep.rrl_rt_products(
                line, freqs[k], contsub=contsub, lte=b_pairs is None,
                departure_coeffs=None if b_pairs is None else
                tuple(b_pairs[k]), as_numpy=False)
    return _to_host(products)
