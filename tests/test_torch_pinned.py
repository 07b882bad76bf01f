"""The RT products' copy-out (``JetModel.products_to_host``) and the
pinned host pool it copies a CUDA model's maps into
(``utils.pinned.HostPool``), on the CPU: the pool's pages are pinned by
injected functions that record what they lock, and the copy-out is called
on a stand-in for a model on either device, so no card is needed.

* a CPU model's maps come back as views, counted by their bytes;
* a block goes back to the pool only once every numpy array and tensor
  viewing it is gone, and a held array is never written again;
* the free bytes kept never pass twice the largest copy's, and every
  block dropped is unpinned;
* a CUDA model's copy-out goes through its pool, and its counters of
  bytes, maps and new blocks add up over runs;
* many threads copying through one pool never overwrite a held array.
"""
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.utils import pinned, profiling
from tests.torch_one_thread import one_thread  # noqa: F401

PAGE = pinned.PAGE


class Pins:
    """Injected pin/unpin: the pinned ranges, by address."""

    def __init__(self):
        self.live, self.made, self.lock = {}, 0, threading.Lock()

    def pin(self, addr, nbytes):
        with self.lock:
            assert addr % PAGE == 0 and nbytes % PAGE == 0
            assert addr not in self.live
            self.live[addr] = nbytes
            self.made += 1

    def unpin(self, addr):
        with self.lock:
            del self.live[addr]

    def pool(self):
        return pinned.HostPool(self.pin, self.unpin)


def _maps(seed, n_chan=3, n=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, n), generator=g, dtype=dtype),
            torch.rand((n_chan, n, n), generator=g, dtype=dtype),
            torch.rand((n_chan, n, n), generator=g, dtype=dtype))


def _addr(a):
    return a.__array_interface__['data'][0]


def _to_host(device, pool, maps):
    """``JetModel.products_to_host`` of a model on ``device`` whose pool is
    ``pool`` (the two members the copy-out reads)."""
    model = SimpleNamespace(_device=torch.device(device), _host_pool=pool)
    return JetModel.products_to_host(model, maps)


def test_cpu_maps_come_back_as_views_counted_by_their_bytes():
    pins = Pins()
    c = profiling.COUNTERS
    before = {k: c.get(k, 0) for k in ('rt.runs', 'rt.products_out_bytes',
                                       'rt.products_out_maps',
                                       'rt.products_out_pinned_new')}
    maps = _maps(1, dtype=torch.float64)
    out = _to_host('cpu', pins.pool(), maps)
    for a, m in zip(out, maps):
        assert isinstance(a, np.ndarray) and np.array_equal(a, m.numpy())
        assert np.shares_memory(a, m.numpy())
    assert c['rt.products_out_bytes'] == before['rt.products_out_bytes'] \
        + 8 * 16 * 16 * (1 + 2 * 3)
    # the runs count themselves (rt.runs), with or without a copy-out
    for k in ('rt.runs', 'rt.products_out_maps',
              'rt.products_out_pinned_new'):
        assert c.get(k, 0) == before[k]
    assert not pins.made


def _bytes(maps):
    return sum(-(-m.nbytes // PAGE) * PAGE for m in maps)


def test_a_block_is_reused_only_once_nothing_views_it():
    pins = Pins()
    pool = pins.pool()
    first, made = pool.copy_out(_maps(1))
    assert made == 3 and len(pins.live) == 3
    want = [a.copy() for a in first]
    for a, m in zip(first, _maps(1)):
        assert a.flags.writeable and np.array_equal(a, m.numpy())
        assert _addr(a) in pins.live
    addrs = {_addr(a) for a in first}
    # views of the first run's maps, in numpy and torch, outlive it
    em_view = first[0][2:, 1:]
    tau_t = torch.from_numpy(first[1])[1]
    flux_t = torch.from_numpy(first[2][0]).view(-1)[5:]
    del first, a
    for i in range(3):
        out, made = pool.copy_out(_maps(10 + i))
        assert made == (3 if i == 0 else 0)
        assert not addrs & {_addr(a) for a in out}
        del out
        np.testing.assert_array_equal(em_view, want[0][2:, 1:])
        np.testing.assert_array_equal(tau_t.numpy(), want[1][1])
        np.testing.assert_array_equal(flux_t.numpy(),
                                      want[2][0].reshape(-1)[5:])
    del em_view, tau_t
    out, made = pool.copy_out(_maps(20))      # two blocks came back
    assert made == 0 and len(addrs & {_addr(a) for a in out}) == 2
    del out, flux_t                           # all six blocks are free
    assert pool.free_bytes == 2 * _bytes(_maps(1)) == pool.keep_bytes
    assert addrs <= set(pins.live) and len(pins.live) == 6
    out, made = pool.copy_out(_maps(21))      # the newest: the first's
    assert made == 0 and {_addr(a) for a in out} == addrs


def test_free_bytes_stay_within_twice_the_largest_copy():
    pins = Pins()
    pool = pins.pool()
    held = [pool.copy_out(_maps(s, n_chan=8, n=64))[0] for s in range(5)]
    run_bytes = _bytes(_maps(0, n_chan=8, n=64))
    assert pool.keep_bytes == 2 * run_bytes and len(pins.live) == 15
    del held
    assert 0 < pool.free_bytes <= 2 * run_bytes
    small = pool.copy_out(_maps(9, n_chan=1, n=16))[0]   # a smaller run
    assert pool.keep_bytes == 2 * run_bytes
    del small
    assert 0 < pool.free_bytes <= 2 * run_bytes
    assert sum(pins.live.values()) == pool.free_bytes
    del pool                   # no array views a block: all are unpinned
    assert not pins.live


def test_copy_out_counters_add_up_over_two_runs():
    pins = Pins()
    pool = pins.pool()
    c = profiling.COUNTERS
    maps0 = c.get('rt.products_out_maps', 0)
    new0 = c.get('rt.products_out_pinned_new', 0)
    bytes0 = c.get('rt.products_out_bytes', 0)
    out = _to_host('cuda', pool, _maps(1))
    assert c['rt.products_out_maps'] == maps0 + 3
    assert c['rt.products_out_pinned_new'] == new0 + 3
    assert len(pins.live) == 3 and all(_addr(a) in pins.live for a in out)
    del out
    out = _to_host('cuda', pool, _maps(2))
    assert c['rt.products_out_maps'] == maps0 + 6
    assert c['rt.products_out_pinned_new'] == new0 + 3
    assert c['rt.products_out_bytes'] == bytes0 + 2 * 4 * 16 * 16 * 7
    assert all(np.array_equal(a, m.numpy()) for a, m in zip(out, _maps(2)))


def test_threads_sharing_a_pool_never_overwrite_a_held_array():
    pins = Pins()
    pool = pins.pool()
    errors = []

    def client(k):
        try:
            held = []
            for i in range(40):
                fill = float(1000 * k + i)
                n = 8 + 32 * ((k + i) % 3)
                out, _ = pool.copy_out((torch.full((n, n), fill),
                                        torch.full((2, n, n), -fill)))
                held = held[-2:] + [(fill, out)]
                for f, (a, b) in held:
                    if not ((a == f).all() and (b == -f).all()):
                        errors.append((k, i, f))
        except Exception as e:             # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    pool.copy_out((torch.zeros(1),))       # files what came back last
    assert sum(pins.live.values()) == pool.free_bytes <= pool.keep_bytes


@pytest.mark.parametrize('shape', [(0, 4, 4), (3, 5)])
def test_odd_sizes_copy_out_whole(shape):
    pool = Pins().pool()
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    (a,), _ = pool.copy_out((t,))
    assert a.shape == shape and np.array_equal(a, t.numpy())
