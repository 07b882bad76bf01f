"""Pinned host memory for device-to-host copies whose results the caller
keeps.

:class:`HostPool` copies device tensors into page-locked (pinned) host
blocks and hands them back as numpy arrays that view the blocks, so the
copy runs at the host link's rate and is made once.  Each model holds one
pool, which its replicas share; its one user is
``JetModel.products_to_host``, the copy-out of every RT run's products
(the model's own runs, ``Pipeline.execute_run`` and the run fan-out of
:mod:`..parallel.fanout`).  A block is leased to the arrays of one copy:
it goes back to the pool only when every numpy array and tensor that
views it has been dropped, and the pool never writes a block while one is
held.  Free blocks are reused for the next copy of the same size.  The
free blocks kept hold at most :data:`FREE_COPIES` times the bytes of the
pool's largest copy-out (for the 512^3 grid's 1,000-channel RRL run,
2 x 2.1 GB); the pool unpins and unmaps the rest as they come back.

A block is an anonymous page-aligned mapping of its own, pinned with
``cudaHostRegister`` while the block lives and unpinned and unmapped
when it is dropped.
"""
from __future__ import annotations

import collections
import ctypes
import mmap
import threading
import weakref
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .profiling import span

PAGE = mmap.PAGESIZE
#: free bytes kept, in copies of the largest size seen (a copy's blocks
#: come back while the next copy's are in use)
FREE_COPIES = 2

Pin = Callable[[int, int], None]           # (address, bytes)
Unpin = Callable[[int], None]              # (address)


def cuda_pin(addr: int, nbytes: int) -> None:
    torch.cuda.check_error(
        torch.cuda.cudart().cudaHostRegister(addr, nbytes, 0))


def cuda_unpin(addr: int) -> None:
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(addr))


def _release(mm: mmap.mmap, addr: int, unpin: Unpin) -> None:
    unpin(addr)
    mm.close()


class _Block:
    """``nbytes`` (a whole number of pages) of pinned host memory at
    ``addr``, unpinned and unmapped when the block is collected."""

    def __init__(self, nbytes: int, pin: Pin, unpin: Unpin):
        self.nbytes = nbytes
        mm = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
        self.addr = ctypes.addressof(ctypes.c_char.from_buffer(mm))
        pin(self.addr, nbytes)
        weakref.finalize(self, _release, mm, self.addr, unpin).atexit = False


class HostPool:
    """Pinned host blocks recycled across copies to the host; ``pin`` and
    ``unpin`` (``cudaHostRegister``, ``cudaHostUnregister`` by default)
    lock and unlock a block's pages.  Safe to use from several threads."""

    def __init__(self, pin: Pin = cuda_pin, unpin: Unpin = cuda_unpin):
        self._pin, self._unpin = pin, unpin
        self._free: List[_Block] = []        # viewed by none, oldest first
        self._back = collections.deque()     # returned, not yet filed
        self._lock = threading.Lock()
        self.keep_bytes = 0                  # most free bytes kept

    @property
    def free_bytes(self) -> int:
        with self._lock:
            return sum(b.nbytes for b in self._free)

    def copy_out(self, tensors: Sequence[torch.Tensor]
                 ) -> Tuple[Tuple[np.ndarray, ...], int]:
        """Copies of ``tensors`` on the host, each a numpy array viewing a
        pinned block of its own, and how many blocks had to be made.  The
        copies are issued on the current stream of each tensor's device,
        followed by one synchronisation of each such stream."""
        sizes = [-(-max(t.nbytes, 1) // PAGE) * PAGE for t in tensors]
        with self._lock:
            self.keep_bytes = max(self.keep_bytes, FREE_COPIES * sum(sizes))
            self._file()
            blocks = [self._take(n) for n in sizes]
        self._settle()
        made = 0
        for i, n in enumerate(sizes):
            if blocks[i] is None:
                with span('rajepy.host_pool.new_block'):
                    blocks[i] = _Block(n, self._pin, self._unpin)
                made += 1
        dsts = [self._lease(b, t) for b, t in zip(blocks, tensors)]
        for d, t in zip(dsts, tensors):
            d.copy_(t, non_blocking=True)
        for dev in {t.device for t in tensors if t.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
        return tuple(d.numpy() for d in dsts), made

    def _take(self, nbytes: int):
        """The newest free block of ``nbytes``, out of the free list, or
        None (the lock held)."""
        for i in range(len(self._free) - 1, -1, -1):
            if self._free[i].nbytes == nbytes:
                return self._free.pop(i)
        return None

    def _lease(self, block: _Block, like: torch.Tensor) -> torch.Tensor:
        """A tensor of ``like``'s shape and dtype on ``block``, whose
        memory (a ctypes array, which every numpy array and tensor viewing
        it keeps alive) gives the block back when it is collected."""
        lease = (ctypes.c_ubyte * block.nbytes).from_address(block.addr)
        weakref.finalize(lease, self._give_back, block).atexit = False
        if like.numel() == 0:
            return torch.empty(like.shape, dtype=like.dtype)
        return torch.frombuffer(lease, dtype=like.dtype,
                                count=like.numel()).view(like.shape)

    def _give_back(self, block: _Block) -> None:
        # may run inside a collection, in any thread, while the pool is
        # busy: the block then waits in _back for the lock's holder
        self._back.append(block)
        self._settle()

    def _settle(self) -> None:
        if self._lock.acquire(blocking=False):
            try:
                self._file()
            finally:
                self._lock.release()

    def _file(self) -> None:
        """Move the returned blocks to the free list, and drop the oldest
        free blocks beyond ``keep_bytes`` (the lock held)."""
        while self._back:
            self._free.append(self._back.popleft())
        excess = sum(b.nbytes for b in self._free) - self.keep_bytes
        while excess > 0:
            excess -= self._free.pop(0).nbytes
