"""A serve tick's device work, as both serve loops run it.

:class:`ServeTick` stages a decoded frame and prepares it once per source
frame (``prepare``), then samples the tick's gazes and reads the reduced
frames back to host memory (``sample``).  ``BroadcastChannel._loop`` and
``FoveaxServer._send_frame_loop`` (``serve/server.py``) call it from
their executor threads; a benchmark can drive it the same way.  Each step
is a span of :mod:`foveax_torch.pipeline.profiling`: ``serve.stage``,
``serve.prepare``, ``serve.sample``, ``serve.readback``, and
:meth:`ServeTick.unit` opens the tick's root span, ``serve.tick``.  The
counters ``serve.stage_bytes`` and ``serve.readback_bytes`` add up the
bytes copied each way; ``serve.readback_fresh`` counts the readbacks that
had to grow the pinned host pool (:func:`_readback`).
"""

from __future__ import annotations

import numpy as np
import torch

from foveax_torch.pipeline import profiling


def _input_stager(device: torch.device):
    """Staging fn for hot-loop device inputs: a synchronous host -> device
    copy, so the host array (a reader's frame, the gaze list) may be reused
    as soon as the call returns."""

    def stage(x) -> torch.Tensor:
        with profiling.span("serve.stage") as sp:
            host = np.ascontiguousarray(x)
            sp.attrs["bytes"] = host.nbytes
            profiling.count("serve.stage_bytes", host.nbytes)
            return torch.from_numpy(host).to(device)

    return stage


def _readback(out) -> tuple[np.ndarray, bool]:
    """``out`` in host memory, and whether its pinned block is new.

    A CUDA tensor is copied, synchronously, into a pinned block of
    PyTorch's caching host allocator, and the block's NumPy view is
    returned.  The view keeps the block, which goes back to the pool when
    the caller's last view is dropped: every caller (a tick's encodes, a
    readback its guard abandoned, a client's frame sink through
    ``ClientRestore``) owns its frames while it holds them, and
    a steady loop reuses cached blocks, with no page faults and no bounce
    buffer.  ``fresh``: the pool had to allocate (``cudaHostAlloc``) for
    this copy.  A CPU tensor and a sharded pair's ``Sharded`` batch are
    read by their own ``.cpu()``."""
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
        self.stage = _input_stager(pipeline.device)
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
        with profiling.span("serve.readback") as sp:
            host, fresh = _readback(out)
            sp.attrs["bytes"] = host.nbytes
            sp.attrs["fresh"] = fresh
            profiling.count("serve.readback_bytes", host.nbytes)
            if fresh:
                profiling.count("serve.readback_fresh")
        return host if self.single else host[: len(centers)]
