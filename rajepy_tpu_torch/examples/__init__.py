"""Runnable examples of rajepy_tpu_torch, one module for each example of
the JAX package and under the same name:

- ``single_chip_production``: the 512^3 float32 production run (SED,
  spectral-index and turnover maps, an H58a optical-depth cube, a
  25-epoch light curve, the conservation and occupancy diagnostics);
- ``multi_chip_sharded``: the LOS- and channel-sharded grid fill and RT
  step, the epoch split of a light curve and the run fan-out;
- ``nonlte_and_surveys``: non-LTE H58a from the bundled departure table
  and a parameter survey (``fit.sweep``);
- ``fit_parameters``: SED, light-curve and RRL line-profile fits, with
  Laplace and MALA uncertainties;
- ``calibration_workflow``: gain corruption, self-calibration and a
  closure-quantity fit;
- ``uvfits_interchange``: UVFITS export, read-back and ``fit_uvfits``;
- ``wide_field_vlbi``: the w-term bound, w-stacking against the exact
  DFT and a wide-field visibility fit.

Each module's ``main(*, device='cuda', ...)`` prints the JAX example's
report and returns its numbers in a dict.  On an NVIDIA GPU::

    python -m rajepy_tpu_torch.examples.single_chip_production

and on the CPU (float64, where the example leaves the precision to the
model), at the example's sizes or smaller ones::

    from rajepy_tpu_torch.examples import fit_parameters
    fit_parameters.main(device='cpu', grid=(16, 16, 16), sed_steps=20)

``main``'s keywords besides ``device`` are the output directory, the grid
size and the step and chain counts, each defaulting to the JAX example's
value.  ``multi_chip_sharded`` spreads over
``parallel.sharding.available_devices``; replace that function to put
several shards on one device.
"""
import os

import numpy as np
import torch

from .. import cfg
from ..models.jetmodel import JetModel


def bundled_params() -> dict:
    """A fresh copy of the bundled example model's params."""
    return JetModel.py_to_dict(os.path.join(cfg.dcys['files'],
                                            'example-model-params.py'))


def host(x: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a numpy array."""
    return x.detach().cpu().numpy()
