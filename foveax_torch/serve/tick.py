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
"""

from __future__ import annotations

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
    pair ``(x, gaze)`` is returned."""
    with span as sp:
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
