"""A serve tick's device work, as both serve loops run it, and the
host <-> device copies of the tick and of a client's restore.

:class:`ServeTick` stages a decoded frame and prepares it once per source
frame (``prepare``), then samples the tick's gazes and reads the reduced
frames back to host memory (``sample``).  ``serve/server.py::Feed`` calls
it from the executor threads for both serve loops; a benchmark can drive
it the same way.  Each step is a span of
:mod:`foveax_torch.pipeline.profiling`: ``serve.stage``,
``serve.prepare``, ``serve.sample``, ``serve.readback``, and
:meth:`ServeTick.unit` opens the tick's root span, ``serve.tick``.

:func:`upload` and :func:`readback` are every copy of the tick and of
``serve/client.py::ClientRestore``: each opens the span its caller names
and gives it ``bytes`` (and ``fresh`` on a readback).  The counters
``serve.stage_bytes`` and ``serve.readback_bytes`` add up the bytes the
tick copies each way; ``serve.readback_fresh`` and
``client.readback_fresh`` count the readbacks that had to grow the pinned
host pool.

A host array bound for a CUDA device is copied from registered memory
once its owner recurs (:class:`HostRegistry`): its span carries
``registered`` (and ``register`` on the one copy that registered the
owner), counted as ``<span name>_registered``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import sys
import threading
import weakref

import numpy as np
import torch

from foveax_torch.pipeline import profiling


def upload(x, device, span: profiling.span, *, counted: bool = False, gaze=None):
    """``x`` (a host array, or a tensor) on ``device``, by a synchronous
    copy inside ``span`` (a span not yet entered), which carries its
    ``bytes``, so a host array (a reader's frame, the gaze list) may be
    reused as soon as the call returns; a tensor on ``device`` already is
    taken as it is.  ``counted`` adds the bytes to the counter
    ``<span name>_bytes``.  With ``gaze``, a (cx, cy) pair, that follows
    as a (2,) float32 tensor in the same span, outside ``bytes``, and the
    pair ``(x, gaze)`` is returned.

    A host array bound for a CUDA device is first shown to
    :data:`HOSTS`, which registers its owner's memory with CUDA the
    second time it sees it, so that this copy and every later one from
    that owner is a direct DMA; the span then carries ``registered``
    (true when the copy runs from registered memory; ``register`` too on
    the copy that registered), counted as ``<span name>_registered``."""
    with span as sp:
        if isinstance(x, np.ndarray) and (seen := HOSTS.sight(x, device)) is not None:
            registered, register = seen
            sp.attrs["registered"] = registered
            if register:
                sp.attrs["register"] = True
            if registered:
                profiling.count(f"{sp.name}_registered")
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        nbytes = x.numel() * x.element_size()
        sp.attrs["bytes"] = nbytes
        if counted:
            profiling.count(f"{sp.name}_bytes", nbytes)
        x = x.to(device)
        if gaze is None:
            return x
        return x, torch.tensor(gaze, dtype=torch.float32).to(device)


class CudaHostRuntime:
    """Registration of host memory with the CUDA runtime that PyTorch
    uses: ``cudaHostRegister`` and ``cudaHostUnregister`` through
    ``torch.cuda.cudart()``, and after a call that failed, the runtime's
    ``cudaGetLastError``, so that the error is not reported again by the
    next kernel launch's check.  That function is taken from the runtime
    library already loaded (``libcudart.so.<major>``); where there is none
    (a runtime linked statically), nothing is registered."""

    # cudaHostRegisterPortable: the range counts as page-locked for every
    # device, not only the one current when it was registered.
    PORTABLE = 1

    @functools.cached_property
    def _last_error(self):
        """The loaded runtime's ``cudaGetLastError``, or None."""
        major = (torch.version.cuda or "").split(".")[0]
        try:
            lib = ctypes.CDLL(f"libcudart.so.{major}", mode=os.RTLD_NOLOAD)
        except OSError:
            return None
        fn = lib.cudaGetLastError
        fn.argtypes = []
        fn.restype = ctypes.c_int
        return fn

    def register(self, ptr: int, nbytes: int) -> bool:
        """Page-lock ``[ptr, ptr + nbytes)``; False where the runtime
        refused it (the error cleared) or could not be asked."""
        if self._last_error is None:
            return False
        if int(torch.cuda.cudart().cudaHostRegister(ptr, nbytes, self.PORTABLE)) == 0:
            return True
        self._last_error()
        return False

    def unregister(self, ptr: int) -> None:
        if int(torch.cuda.cudart().cudaHostUnregister(ptr)) != 0:
            self._last_error()


class HostRegistry:
    """Caller-owned host memory that :func:`upload` copies from, registered
    with CUDA once it recurs, so that the copy is a direct DMA with
    no pageable bounce.

    A host array's memory belongs to its *owner*: the ndarray that owns
    the data, or the CPU tensor behind a ``.numpy()`` view, found by
    following ``.base``.  The owner's whole range is registered, not the
    view's, since views of one owner (a pool of frames in one block) share
    pages.  The first time an owner is seen nothing is done; the second
    time it is registered, once (``runtime.register``); a registration that
    fails is remembered and not retried.  So a caller that hands a fresh
    array every call registers nothing, and one that reuses its buffers (a
    decoder's frame pool) registers each buffer once.  Nothing is kept
    alive: a weak reference to the owner forgets it, and unregisters its
    range, as it dies, before its memory is freed.  Contiguous, writeable
    arrays only; one of any other owner (an ``np.memmap``'s mmap, a
    foreign buffer) is copied as it always was.

    One registry per process (:data:`HOSTS`), since CUDA's host
    registrations are per process; the lock serves the executor threads
    that stage frames, and two channels that share a reader's buffers."""

    SEEN, REGISTERED, REFUSED = range(3)

    def __init__(self, runtime=None, *, target: str = "cuda"):
        self.runtime = runtime if runtime is not None else CudaHostRuntime()
        self.target = target
        self._lock = threading.RLock()
        # id(owner) -> [weak reference to the owner, state, ptr, nbytes]
        self._owners: dict[int, list] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._owners)

    def sight(self, a: np.ndarray, device) -> tuple[bool, bool] | None:
        """Show ``a``, about to be copied to ``device``: None where the
        copy is no host-to-device copy (another device type), else
        ``(registered, register)``: whether ``a`` lies in registered
        memory, and whether this call registered it."""
        if torch.device(device).type != self.target:
            return None
        if not (a.flags.c_contiguous and a.flags.writeable) or a.nbytes == 0:
            return False, False
        owner = _owner(a)
        if owner is None:
            return False, False
        key = id(owner)
        with self._lock:
            entry = self._owners.get(key)
            if entry is None:
                ptr, nbytes = _extent(owner)
                ref = weakref.ref(owner, lambda _, key=key: self._gone(key))
                self._owners[key] = [ref, self.SEEN, ptr, nbytes]
                return False, False
            if entry[1] == self.SEEN:
                ok = self.runtime.register(entry[2], entry[3])
                entry[1] = self.REGISTERED if ok else self.REFUSED
                return ok, ok
            return entry[1] == self.REGISTERED, False

    def _gone(self, key: int) -> None:
        """The owner ``key`` is dying: forget it, and unregister its range
        before its memory is freed (not while the interpreter shuts down,
        when the process's exit releases it)."""
        with self._lock:
            entry = self._owners.pop(key)
        if entry[1] == self.REGISTERED and not sys.is_finalizing():
            self.runtime.unregister(entry[2])


def _owner(a: np.ndarray):
    """The object that owns ``a``'s memory, found by following ``.base``:
    an ndarray that owns its data or a CPU tensor; None for any other
    owner."""
    o = a
    while isinstance(o, np.ndarray) and o.base is not None:
        o = o.base
    if isinstance(o, np.ndarray):
        return o if o.flags.owndata else None
    if isinstance(o, torch.Tensor) and o.device.type == "cpu":
        return o
    return None


def _extent(owner) -> tuple[int, int]:
    """The owner's whole range, ``(ptr, nbytes)``: an ndarray's data, a
    tensor's whole storage."""
    if isinstance(owner, np.ndarray):
        return owner.ctypes.data, owner.nbytes
    storage = owner.untyped_storage()
    return storage.data_ptr(), storage.nbytes()


# The process's registry (:class:`HostRegistry`).
HOSTS = HostRegistry()


def stager(device: torch.device):
    """The tick's staging of its device inputs: :func:`upload` in a
    ``serve.stage`` span, counted."""

    def stage(x) -> torch.Tensor:
        return upload(x, device, profiling.span("serve.stage"), counted=True)

    return stage


def readback(out, span: profiling.span, *, counted: bool = False, whole: bool = True):
    """``out`` in host memory, read inside ``span`` (a span not yet
    entered), which carries its ``bytes`` and ``fresh``: whether the pinned
    host pool had to allocate (``cudaHostAlloc``) for this copy, counted as
    ``<span name>_fresh``.  ``counted`` adds the bytes to the counter
    ``<span name>_bytes``.  With
    ``whole`` false it only waits for ``out`` by reading one element back
    (``bytes`` 1, no ``fresh``) and returns None.

    A CUDA tensor is copied, synchronously, into a pinned block of
    PyTorch's caching host allocator, and the block's NumPy view is
    returned.  The view keeps the block, which goes back to the pool when
    the caller's last view is dropped: every caller (a tick's encodes, a
    readback its guard abandoned, a client's frame sink) owns its frames
    while it holds them, and a steady loop reuses cached blocks, with no
    page faults and no bounce buffer.  A CPU tensor and a sharded pair's
    ``Sharded`` batch are read by their own ``.cpu()``."""
    with span as sp:
        if not whole:
            _ = int(out[(0,) * out.dim()])
            sp.attrs["bytes"] = 1
            return None
        host, fresh = _to_host(out)
        sp.attrs["bytes"] = host.nbytes
        sp.attrs["fresh"] = fresh
        if counted:
            profiling.count(f"{sp.name}_bytes", host.nbytes)
        if fresh:
            profiling.count(f"{sp.name}_fresh")
        return host


def _to_host(out) -> tuple[np.ndarray, bool]:
    """:func:`readback`'s copy: the host array, and whether its pinned
    block is new."""
    if not isinstance(out, torch.Tensor) or out.device.type != "cuda":
        return out.cpu().numpy(), False
    # the stats are empty until the pool's first block
    allocs = torch.cuda.host_memory_stats().get("num_host_alloc", 0)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    fresh = torch.cuda.host_memory_stats().get("num_host_alloc", 0) > allocs
    host.copy_(out)
    return host.numpy(), fresh


class ServeTick:
    """The device half of a serve tick on ``pipeline``'s device.

    ``pair`` is a ``(prepare, sample)`` pair: the pipeline's
    ``batch_pair(...)`` or a sharded pair of ``parallel/sharded.py`` (the
    gaze batch padded with its last gaze to a multiple of ``pad_to``, the
    mesh's data axis, and trimmed after the readback), or with
    ``single=True`` its ``single_pair()``."""

    def __init__(self, pipeline, pair, *, single: bool = False, pad_to: int = 1):
        self.pipeline = pipeline
        self.stage = stager(pipeline.device)
        self._prepare, self._sample = pair
        self.single = single
        self.pad_to = pad_to

    @staticmethod
    def unit(tally: profiling.StageTimer | None = None, **attrs) -> profiling.root:
        """The tick's root span, ``serve.tick``: the spans opened inside it,
        and in the executor calls bound to it, share its unit id and feed
        ``tally`` (the server's)."""
        return profiling.root("serve.tick", tally=tally, **attrs)

    def prepare(self, frame_np: np.ndarray):
        """Stage the (H, W, 3) uint8 frame and prepare it: the SAT, or the
        staged frame itself for the SAT-free samplers."""
        staged = self.stage(frame_np)
        with profiling.span("serve.prepare"):
            return self._prepare(staged)

    def sample(self, prepared, centers) -> np.ndarray:
        """The reduced frames at ``centers`` in host memory: for a batch
        pair a list of (cx, cy), giving (N, Hr, Wr, 3); for a single pair
        one (cx, cy), giving (Hr, Wr, 3)."""
        with profiling.span("serve.sample", viewers=1 if self.single else len(centers)):
            if self.single:
                out = self._sample(prepared, self.pipeline.center(*centers))
            else:
                padded = list(centers) + [centers[-1]] * (-len(centers) % self.pad_to)
                out = self._sample(prepared, self.stage(np.asarray(padded, dtype=np.float32)))
        host = readback(out, profiling.span("serve.readback"), counted=True)
        return host if self.single else host[: len(centers)]
