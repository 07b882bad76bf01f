"""The port's export modules against the JAX package's, on the CPU:
UVFITS (``synthobs.uvfits``), the exact-DFT samplers
(``synthobs.sampler.sample_vis_dft``/``_w``) and ``casa_compat``."""
import numpy as np
import pytest
import torch

from rajepy_tpu import casa_compat as jcasa
from rajepy_tpu.synthobs import sampler as jsampler
from rajepy_tpu.synthobs import uvfits as juvfits
from rajepy_tpu_torch import casa_compat as tcasa
from rajepy_tpu_torch.synthobs import observatories
from rajepy_tpu_torch.synthobs import sampler as tsampler
from rajepy_tpu_torch.synthobs import uvfits as tuvfits
from rajepy_tpu_torch.synthobs.calibration import vis_metadata
from tests.torch_one_thread import one_thread  # noqa: F401

RTOL = 1e-12
PACKAGES = {'jax': juvfits, 'port': tuvfits}


def _set(noisy):
    """A VLA A visibility set of 3 time samples and 3 channels."""
    ant = observatories.read_antenna_config(observatories.cfg_file('VLA',
                                                                   'A'))
    n_ant = ant['xyz'].shape[0]
    pairs = np.stack(np.triu_indices(n_ant, k=1), axis=1)
    a1, a2, ti = vis_metadata(3, pairs)
    rng = np.random.default_rng(3)
    n_vis = a1.size
    vis = rng.normal(size=(2, 3, n_vis))
    return dict(uvw_m=rng.uniform(-3e4, 3e4, (n_vis, 3)), vis_re=vis[0],
                vis_im=vis[1], freqs_hz=np.array([5.9e9, 6.0e9, 6.1e9]),
                ant_xyz=ant['xyz'], ant1=a1, ant2=a2,
                time_s=(ti + 0.5) * 5.0, ra_deg=67.89, dec_deg=18.13,
                sigma=np.array([0.1, 0.2, 0.3]) if noisy else 0.0,
                ant_names=ant.get('names'), source='TARGET',
                telescope='VLA')


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """Both packages' UVFITS files of the same two sets."""
    root = tmp_path_factory.mktemp('uvfits')
    out = {}
    for noisy in (False, True):
        args = _set(noisy)
        for name, mod in PACKAGES.items():
            path = str(root / f'{name}.{int(noisy)}.uvfits')
            kw = {k: v for k, v in args.items()
                  if k not in ('uvw_m', 'vis_re', 'vis_im', 'freqs_hz',
                               'ant_xyz', 'ant1', 'ant2', 'time_s',
                               'ra_deg', 'dec_deg')}
            mod.write_uvfits(path, args['uvw_m'], args['vis_re'],
                             args['vis_im'], args['freqs_hz'],
                             args['ant_xyz'], args['ant1'], args['ant2'],
                             args['time_s'], args['ra_deg'],
                             args['dec_deg'], **kw)
            out[name, noisy] = path
        out['args', noisy] = args
    return out


def _cards(path):
    """The primary header's 80-character cards."""
    with open(path, 'rb') as f:
        raw = f.read()
    cards = []
    for i in range(0, len(raw), 80):
        card = raw[i:i + 80].decode('ascii')
        cards.append(card)
        if card.startswith('END '):
            return cards
    raise AssertionError("no END card")


@pytest.mark.parametrize('noisy', [False, True])
def test_both_packages_write_the_same_file(files, noisy):
    assert _cards(files['port', noisy]) == _cards(files['jax', noisy])
    with open(files['port', noisy], 'rb') as a, \
            open(files['jax', noisy], 'rb') as b:
        assert a.read() == b.read()


@pytest.mark.parametrize('reader', ['jax', 'port'])
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_either_package_reads_either_file(files, writer, reader):
    """What either reader gives for either writer's noisy file: the input
    set to float32 rounding, and the other reader's values exactly."""
    got = PACKAGES[reader].read_uvfits(files[writer, True])
    other = PACKAGES['jax' if reader == 'port' else 'port'].read_uvfits(
        files[writer, True])
    assert sorted(got) == sorted(other)
    for key, val in got.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(val, other[key], err_msg=key)
        else:
            assert val == other[key], key
    args = files['args', True]
    for part in ('vis_re', 'vis_im'):
        np.testing.assert_array_equal(
            got[part], args[part].astype(np.float32).astype(np.float64))
    np.testing.assert_array_equal(got['ant1'], args['ant1'])
    np.testing.assert_array_equal(got['ant2'], args['ant2'])
    np.testing.assert_allclose(got['uvw'], args['uvw_m'], rtol=1e-6)
    want_w = np.broadcast_to(1.0 / args['sigma'][:, None] ** 2,
                             got['weights'].shape)
    np.testing.assert_allclose(got['weights'], want_w, rtol=1e-6)
    np.testing.assert_array_equal(got['freqs'], args['freqs_hz'])
    assert got['source'] == 'TARGET' and got['stokes'] == ['I']


@pytest.mark.parametrize('centre', ['pixel', 'fits'])
@pytest.mark.parametrize('fn', ['sample_vis_dft', 'sample_vis_dft_w'])
def test_dft_samplers_match_jax(fn, centre):
    rng = np.random.default_rng(4)
    img = rng.uniform(0.0, 1.0, (32, 32))
    u, v = rng.uniform(-3e4, 3e4, (2, 256))
    w = rng.uniform(-5e3, 5e3, 256)
    cell = 1e-5 if fn == 'sample_vis_dft' else 1e-3
    extra = (w,) if fn.endswith('_w') else ()
    got = getattr(tsampler, fn)(torch.from_numpy(img), cell, u, v, *extra,
                                centre=centre)
    assert got.dtype == torch.complex128 and got.shape == (256,)
    want = np.asarray(getattr(jsampler, fn)(img, cell, u, v, *extra,
                                            centre=centre))
    err = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
    assert err < RTOL


@pytest.mark.parametrize('fn', ['sample_vis_dft', 'sample_vis_dft_w'])
def test_dft_samplers_do_not_depend_on_the_chunk(fn, monkeypatch):
    """Chunks of 1, 7 and 100 visibilities (the last one padded) give the
    one-chunk result; a float32 image gives complex64, from float64
    phases."""
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0.0, 1.0, (16, 24)))
    u, v, w = rng.uniform(-2e4, 2e4, (3, 250))
    extra = (w,) if fn.endswith('_w') else ()
    f = getattr(tsampler, fn)
    whole = f(img, 1e-4, u, v, *extra)
    for n in (1, 7, 100):
        monkeypatch.setattr(tsampler, 'DFT_CHUNK_BYTES', 8 * 16 * 24 * n)
        part = f(img, 1e-4, u, v, *extra)
        err = (part - whole).abs().max() / whole.abs().max()
        assert float(err) < 1e-14, n
    monkeypatch.undo()
    f32 = f(img.float(), 1e-4, u, v, *extra)
    assert f32.dtype == torch.complex64
    err = (f32.to(torch.complex128) - whole).abs().max() / whole.abs().max()
    assert float(err) < 1e-6


def _script(casa):
    sc = casa.Script()
    sc.add_task(casa.Simobserve(project='SynObs', skymodel='model.fits'))
    sc.add_task(casa.Tclean(vis='SynObs.ms', imagename='im', niter=500,
                            interactive=False))
    sc.add_task(casa.Exportfits(imagename='im.image', fitsimage='im.fits'))
    sc.add_task(casa.Chdir('/tmp/x'))
    sc.add_task(casa.Rmdir(path='/tmp/y'))
    return sc


def test_casa_script_renders_as_the_jax_packages():
    assert _script(tcasa).render() == _script(jcasa).render()
    assert sorted(tcasa.__all__) == sorted(jcasa.__all__)


@pytest.mark.parametrize('name', sorted(set(jcasa.__all__) - {'Script'}))
def test_casa_task_defaults_equal_the_jax_packages(name):
    """Each task wrapper's parameter table and default rendering."""
    t, j = getattr(tcasa, name), getattr(jcasa, name)
    assert t.PARAMS == j.PARAMS and t.NAME == j.NAME
    args = ('/tmp/z',) if name == 'Chdir' else ()
    assert str(t(*args)) == str(j(*args))
    with pytest.raises((TypeError, KeyError)):
        t(no_such_param=1)
