#!/usr/bin/env python3
"""Multi-device execution over a ``parallel.sharding.Mesh``: the voxel
grid sharded along the line of sight, its partial maps summed over the
LOS shards, channels split over a second mesh axis, epochs split across
devices, and a group of pipeline runs fanned out.

One process drives a list of devices, as the JAX package's single
controller drives its mesh: no ``torch.distributed``, no launcher.  The
devices are ``parallel.sharding.available_devices(device)``: every card
of the machine, or the one CPU.

    python -m rajepy_tpu_torch.examples.multi_chip_sharded

To put several shards on one device (a one-card machine, or the CPU),
replace that function for the run, as ``tests/test_torch_fanout.py``
does::

    import torch
    from rajepy_tpu_torch.parallel import sharding
    from rajepy_tpu_torch.examples import multi_chip_sharded
    sharding.available_devices = lambda device: [torch.device('cpu')] * 8
    multi_chip_sharded.main(device='cpu')
"""
import numpy as np
import torch

from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.examples import bundled_params
from rajepy_tpu_torch.parallel import fanout, sharding


def main(*, device='cuda') -> dict:
    """The sharded run over ``available_devices(device)``; returns its
    printed numbers, the model and its products."""
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("multi_chip_sharded(device='cuda') needs a CUDA "
                           "device; pass device='cpu' to run on the CPU")
    devices = sharding.available_devices(device)
    print("devices:", devices)
    n_dev = len(devices)
    n_chan_axis = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = sharding.make_mesh(n_los=n_dev // n_chan_axis, n_chan=n_chan_axis,
                              devices=devices)
    print("mesh:", mesh.shape)

    params = bundled_params()
    params['grid'].update(n_x=64, n_y=16 * (n_dev // n_chan_axis), n_z=64,
                          l_z=None)
    jm = JetModel(params, device=device)

    freqs = np.linspace(1e9, 5e10, 4 * n_chan_axis)
    step = sharding.sharded_rt_products(
        mesh, jm.params['properties']['T_0'], False, jm.csize,
        jm.params['target']['dist'])
    # the grid fill itself runs mesh-sharded: no unsharded cube is ever
    # materialised, so the model size is bounded by the devices' memory
    # together, not by one device's (shard_fields would cut a
    # single-device fill)
    fs = sharding.sharded_static_fields(
        mesh, jm._static_params(), jm._ss_jml_rb_frac,
        jm.nx, jm.ny, jm.nz, jm.csize, with_time=jm._has_bursts)
    em, taus, fluxes = step(
        sharding.put(torch.as_tensor(freqs, dtype=jm.dtype),
                     sharding.chan_sharding(mesh)),
        fs.nd, fs.xi, fs.temp, fs.ff, fs.area, fs.inside)
    fluxes = fluxes.gather()
    total = float(torch.sum(fluxes[0]))
    print("EM map:", tuple(em.shape), "| flux maps:", tuple(fluxes.shape),
          "| total S(6GHz)~ %.3e Jy" % total)

    # epoch split across every device
    lc_years = np.linspace(0., 2., 2 * n_dev)
    lc = sharding.light_curve_sharded(jm, lc_years, freqs[:2])
    print("sharded light curve:", lc.shape)

    # run-level fan-out: a whole group of pipeline runs (epoch x frequency)
    # computed over the devices at once — what Pipeline.execute does
    # on its own with two or more devices (device_fanout=None default)
    years = np.linspace(0.0, 2.0, n_dev)
    freqs_mat = np.tile(np.array([6e9, 2.2e10]), (n_dev, 1))
    em_r, tau_r, flux_r = fanout.continuum_runs_fanout(jm, years, freqs_mat)
    totals = np.round(flux_r.sum(axis=(1, 2, 3)), 6)
    print("fanned runs:", flux_r.shape, "| per-run totals:", totals)
    return {'model': jm, 'devices': devices, 'mesh': mesh.shape,
            'freqs': freqs, 'em': em, 'taus': taus.gather(),
            'fluxes': fluxes, 'total': total, 'lc_years': lc_years,
            'light_curve': lc, 'years': years, 'freqs_mat': freqs_mat,
            'fanned': (em_r, tau_r, flux_r), 'totals': totals}


if __name__ == '__main__':
    main()
