"""Registered receive windows — where the ring writes across processes.

Counterpart of the reference's per-peer receive buffers and its barrier
semaphore (``sparkrdma_tpu/exchange/ring.py:93-99``, ``:158-164``), and
of SparkRDMA's registered buffers: memory a peer writes into one-sidedly,
without the owner taking part in the transfer.

- **One window per process and collective scope.** A standalone
  manager's ring uses the default group's scope; a service session's
  uses its own (``runtime/distributed.py::collective_scope``), so two
  tenants' rings never write into one window (the role the reference's
  ``derive_collective_id`` plays for its semaphores).
- **On the card** the window is one ``cudaMalloc`` allocation made in
  ``csrc/ring_exchange.cu`` (``sr_window_alloc``), not by torch's caching
  allocator: ``cudaIpcGetMemHandle`` names a whole allocation, and
  expandable segments refuse it. It is exported once; the 64-byte
  handles are all-gathered over the scope as ``uint8`` CPU tensors, and
  each process opens every peer's once with ``cudaIpcOpenMemHandle(...,
  cudaIpcMemLazyEnablePeerAccess)``. A process reaches its own window
  through its own pointer (opening one's own handle fails). Python sees
  a window through ``torch.as_tensor`` of an object with
  ``__cuda_array_interface__``.
- **On the CPU** a window is a POSIX shared-memory block
  (``multiprocessing.shared_memory``) whose name is gathered the same
  way; every process maps it with ``torch.from_file(..., shared=True)``.
  The registry, growth, the handshake and the layout are this same code
  on both devices, so the CPU tests exercise all of it except the
  kernel and the IPC calls.
- **Growth.** A window grows when a move needs more room, to a multiple
  of :data:`GRAIN`. Every process derives the same send shape from the
  all-gathered counts, so all of them grow at the same move, and the
  regrowth (unmap, free, allocate, export, gather, open) is collective.
- **Closing** (``ShuffleManager.stop``, a session's close): every
  process finishes its reads, a barrier, every process closes its
  mappings of the peers' windows, a barrier, then each owner frees its
  own. An owner that freed a window a peer still maps would be
  undefined behaviour.

The handshake of one move (:meth:`RingWindow.ready`, the push,
:meth:`RingWindow.done`):

1. **ready**: this process has finished every read of its window (a sync
   on the event :meth:`RingWindow.release` recorded after the last read;
   the whole card's work when a move's reads were never released), then
   the scope's barrier;
2. **push**: one launch writes every chunk straight into its destination
   process's window;
3. **done**: a sync on the launch's own event, then the scope's barrier:
   after it, the window holds every peer's chunks;
4. **consume**: compaction or the streaming fold reads the window, then
   calls :meth:`RingWindow.release`. The window is never handed out as
   an exchange's output and never goes to the slot pool.

Visibility: the stores of a kernel that has completed, as an event sync
on its process shows, are visible to the later kernels of another
process on the same card; across cards they are visible once the
writer's sync has returned, which the barrier after it orders before
any read. The design relies on both. No kernel waits on another
process: the handshake stays on the host.
"""

from __future__ import annotations

import ctypes
import threading
import time
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Tuple

import torch

from sparkrdma_tpu_torch import _build

#: bytes of a handle as it is gathered: a CUDA IPC handle, or the
#: shared-memory block's name, zero-padded
HANDLE_BYTES = 64
#: a window grows to a multiple of this many bytes
GRAIN = 2 << 20


class WindowError(RuntimeError):
    """A window could not be allocated, exported, opened or closed. Not
    retried: the processes would no longer agree on the windows."""


class _CudaWords:
    """``__cuda_array_interface__`` of ``words`` int32 words at ``ptr``."""

    def __init__(self, ptr: int, words: int):
        self.__cuda_array_interface__ = {
            "shape": (words,), "typestr": "<i4", "data": (ptr, False),
            "version": 2}


def _card_words(ptr: int, words: int, device: torch.device) -> torch.Tensor:
    """``words`` int32 words of card memory at ``ptr``, as a tensor."""
    return torch.as_tensor(_CudaWords(ptr, words), device=device)


class RingWindow:
    """This process's receive window in one collective scope, and its
    mappings of every peer's. Made by :func:`window_for`; every method
    but :meth:`view` and :meth:`release` is collective over the scope."""

    def __init__(self, coll, device: torch.device, rank: int, procs: int):
        if procs > 8:
            raise ValueError(f"the ring's window table holds 8 processes, "
                             f"not {procs}")
        self.coll = coll
        self.device = torch.device(device)
        self.rank, self.procs = rank, procs
        #: bytes of every process's window (0: not mapped)
        self.nbytes = 0
        self._own = None                 # card: pointer; CPU: the block
        self._bases: List[int] = []      # card: every window, mapped here
        self._views: List[torch.Tensor] = []
        #: every process's handle as gathered (an IPC handle, or the
        #: block's zero-padded name), by rank
        self.handles: List[bytes] = []
        self._read: Optional[torch.cuda.Event] = None
        self._unread = False
        #: moves made, regrowths, and host seconds in the handshake's
        #: syncs and barriers (``launch_wait_s``: the done step's wait
        #: for the push itself)
        self.moves = 0
        self.growths = 0
        self.handshake_s = 0.0
        self.launch_wait_s = 0.0

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def _call(self, name: str, *args) -> None:
        err = getattr(_build.library("ring_exchange"), name)(*args)
        if err:
            raise WindowError(f"{name} failed: cudaError_t {err} (window "
                              f"of process {self.rank} in scope "
                              f"{self.coll.name!r})")

    # --- the handshake --------------------------------------------------
    def _quiesce(self) -> None:
        """Wait until this process's reads of its window are done."""
        if not self.on_card:
            return
        if self._unread:
            torch.cuda.synchronize(self.device)
        elif self._read is not None:
            self._read.synchronize()

    def ready(self) -> None:
        """Step 1: this process has read its window; the barrier."""
        t0 = time.perf_counter()
        self._quiesce()
        self.coll.barrier()
        self.handshake_s += time.perf_counter() - t0

    def done(self) -> None:
        """Step 3: the push has completed; the barrier."""
        t0 = time.perf_counter()
        if self.on_card:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()
        t1 = time.perf_counter()
        self.coll.barrier()
        self._unread = True
        self.moves += 1
        self.launch_wait_s += t1 - t0
        self.handshake_s += time.perf_counter() - t1

    def release(self) -> None:
        """Mark the reads of the window queued so far as the last ones of
        this move: the next move's ready step waits for them."""
        if self.on_card:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._read = ev
        self._unread = False

    # --- the memory -----------------------------------------------------
    def ensure(self, nbytes: int) -> None:
        """Make every window hold ``nbytes`` (collective when it grows;
        called after :meth:`ready`)."""
        if nbytes <= self.nbytes:
            return
        self._unmap()
        self._map(-(-nbytes // GRAIN) * GRAIN)
        self.growths += 1

    def _map(self, nbytes: int) -> None:
        """Allocate, export, gather and open: all or nothing. A failure
        undoes what this process made here (its mappings of the peers'
        windows, its own window) and drops the window from the registry,
        then raises: the peers may have mapped theirs, so the scope is
        closed (``close_scope``) before it moves again."""
        try:
            self._map_all(nbytes)
        except BaseException:
            self._abandon()
            raise

    def _map_all(self, nbytes: int) -> None:
        handle = torch.zeros(HANDLE_BYTES, dtype=torch.uint8)
        dev = self.device.index or 0
        if self.on_card:
            ptr = ctypes.c_void_p()
            self._call("sr_window_alloc", dev, nbytes, ctypes.byref(ptr))
            self._own = ptr.value
            raw = (ctypes.c_char * HANDLE_BYTES)()
            self._call("sr_ipc_export", dev, ptr, raw)
            handle.copy_(torch.frombuffer(bytearray(raw.raw),
                                          dtype=torch.uint8))
        else:
            block = shared_memory.SharedMemory(create=True, size=nbytes)
            block.close()        # every process maps it through torch
            self._own = block
            name = block.name.encode()
            handle[:len(name)] = torch.frombuffer(bytearray(name),
                                                  dtype=torch.uint8)
        handles = [torch.empty_like(handle) for _ in range(self.procs)]
        self.coll.all_gather(handles, handle)
        words = nbytes // 4
        self.handles = [bytes(h.tolist()) for h in handles]
        if self.on_card:
            for q, raw in enumerate(self.handles):
                if q == self.rank:
                    self._bases.append(self._own)
                    continue
                ptr = ctypes.c_void_p()
                self._call("sr_ipc_open", dev, raw, ctypes.byref(ptr))
                self._bases.append(ptr.value)
            self._views = [_card_words(base, words, self.device)
                           for base in self._bases]
        else:
            names = [raw.rstrip(b"\0").decode() for raw in self.handles]
            self._views = [torch.from_file(f"/dev/shm/{name}", shared=True,
                                           size=words, dtype=torch.int32)
                           for name in names]
        self.nbytes = nbytes

    def _abandon(self) -> None:
        """Undo a :meth:`_map` that failed partway, without a barrier
        (the peers may be anywhere); the calls' own errors are dropped,
        since the first one is being raised."""
        dev = self.device.index or 0
        if self.on_card:
            lib = _build.library("ring_exchange")
            for q, base in enumerate(self._bases):
                if q != self.rank:
                    lib.sr_ipc_close(dev, ctypes.c_void_p(base))
            if self._own is not None:
                lib.sr_window_free(dev, ctypes.c_void_p(self._own))
        elif self._own is not None:
            self._own.unlink()
        self._own = None
        self._bases, self._views, self.handles = [], [], []
        self.nbytes = 0
        self._read = None
        self._unread = False
        key = (self.coll.name, str(self.device))
        with _LOCK:
            if _WINDOWS.get(key) is self:
                del _WINDOWS[key]

    def _unmap(self) -> None:
        if not self.nbytes:
            return
        self.coll.barrier()          # every process is done with them all
        self._views = []
        dev = self.device.index or 0
        if self.on_card:
            for q, base in enumerate(self._bases):
                if q != self.rank:
                    self._call("sr_ipc_close", dev, ctypes.c_void_p(base))
        self._bases = []
        self.handles = []
        self.coll.barrier()          # no peer maps this window any more
        if self.on_card:
            self._call("sr_window_free", dev, ctypes.c_void_p(self._own))
        else:
            self._own.unlink()
        self._own = None
        self.nbytes = 0
        self._read = None
        self._unread = False

    def close(self) -> None:
        """Unmap and free (collective)."""
        self._quiesce()
        self._unmap()

    # --- access ---------------------------------------------------------
    def bases(self) -> List[int]:
        """Every process's window as mapped here, by rank (the card)."""
        return list(self._bases)

    def views(self) -> List[torch.Tensor]:
        """Every process's window as flat int32 words, by rank."""
        return list(self._views)

    def view(self, shape) -> torch.Tensor:
        """The first words of this process's own window, as ``shape``."""
        n = 1
        for s in shape:
            n *= int(s)
        return self._views[self.rank][:n].view(tuple(shape))

    def __repr__(self) -> str:
        return (f"RingWindow(scope={self.coll.name!r}, {self.device}, "
                f"rank {self.rank}/{self.procs}, {self.nbytes} bytes)")


_LOCK = threading.Lock()
#: the windows of this process, by (scope name, device)
_WINDOWS: Dict[Tuple[Optional[str], str], RingWindow] = {}  # guarded-by: _LOCK


def window_for(coll, device, rank: int, procs: int) -> RingWindow:
    """This process's window of scope ``coll`` on ``device`` (made, not
    yet mapped, at the first ask)."""
    key = (coll.name, str(torch.device(device)))
    with _LOCK:
        win = _WINDOWS.get(key)
        if win is None:
            win = _WINDOWS[key] = RingWindow(coll, device, rank, procs)
        return win


def close_scope(coll) -> None:
    """Close the scope's windows (collective where one is mapped)."""
    with _LOCK:
        keys = [k for k in _WINDOWS if k[0] == coll.name]
        wins = [_WINDOWS.pop(k) for k in keys]
    for win in wins:
        win.close()


def open_windows() -> List[RingWindow]:
    """The windows this process has made and not closed."""
    with _LOCK:
        return list(_WINDOWS.values())


__all__ = ["RingWindow", "WindowError", "window_for", "close_scope",
           "open_windows", "GRAIN", "HANDLE_BYTES"]
