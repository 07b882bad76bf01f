"""The port's grid fill against the JAX package's, at float64 on the CPU.

Fields match to 1e-10 of each field's maximum; the masks exactly.
"""
import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu import JetModel as JaxJetModel
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.models.fields import StaticFields, \
    static_fields_from_numpy
from tests.torch_one_thread import one_thread  # noqa: F401


@pytest.mark.parametrize("which", ["model_params", "disc_wind_params"])
def test_static_fields_match_jax_f64(request, which):
    params = request.getfixturevalue(which)
    fj = JaxJetModel(copy.deepcopy(params),
                     dtype=jnp.float64)._ensure_fields()
    ft = JetModel(copy.deepcopy(params), dtype='parity',
                  device='cpu')._ensure_fields()
    for name in StaticFields._fields:
        want = np.asarray(getattr(fj, name))
        got = getattr(ft, name).numpy()
        assert got.shape == want.shape == (32, 80, 32), name
        if name in ('inside', 'red'):
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        assert got.dtype == np.float64, name
        scale = np.abs(want).max()
        assert scale > 0, name
        err = np.max(np.abs(got - want)) / scale
        bad = np.argwhere(np.abs(got - want) >= 1e-10 * scale)
        assert err < 1e-10, (f"{name}: rel err {err:.2e} at {len(bad)} "
                             f"cells, first {bad[:4].tolist()}: port "
                             f"{got[tuple(bad[:4].T)]}, JAX "
                             f"{want[tuple(bad[:4].T)]}")
    assert ft.inside.any() and ft.red.any() and (~ft.red).any()


def test_static_fields_from_numpy_carries_jax_fields(model_params):
    fj = JaxJetModel(copy.deepcopy(model_params),
                     dtype=jnp.float64)._ensure_fields()
    for dtype in ('float64', 'float32'):
        dt = getattr(torch, dtype)
        ft = static_fields_from_numpy(fj, device='cpu', dtype=dt)
        for name in StaticFields._fields:
            got = getattr(ft, name)
            want = np.asarray(getattr(fj, name))
            if name in ('inside', 'red'):
                assert got.dtype == torch.bool
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                assert got.dtype == dt
                np.testing.assert_array_equal(got.numpy(),
                                              want.astype(dtype))
