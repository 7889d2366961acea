"""Host-side transcode runner: decode prefetch double-buffered against
device compute (counterpart of ``foveax/pipeline/runner.py``).

The reference's server loop decodes a frame, builds the SAT, then sleeps to
the 30 fps tick before sampling (reference: src/video_server.cc:287-335) —
host decode and GPU work alternate.  Here they overlap: a background
thread decodes ahead into a bounded queue while the card processes the
current frame (CUDA launches return before the kernels finish), and a
second thread reads each result back and hands it to the sink.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np
import torch

from foveax_torch.device import resolve_device
from foveax_torch.pipeline.profiling import StageTimer


def upload(frame: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host frame as a tensor on ``device``.  File readers hand out
    OpenCV's BGR arrays reversed on the channel axis (a negative stride,
    which ``torch.from_numpy`` refuses), so the frame is made contiguous on
    the host first; a contiguous frame is not copied there."""
    return torch.from_numpy(np.ascontiguousarray(frame)).to(device)


class PrefetchReader:
    """Wrap a frame source with a decode-ahead thread and bounded queue."""

    def __init__(self, reader, depth: int = 3):
        self._reader = reader
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: BaseException | None = None
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            while not self._stop:
                frame = self._reader.read()
                if frame is None:
                    break
                self._q.put(frame)
        except BaseException as e:  # surfaced on next read()
            self._err = e
        finally:
            self._q.put(self._done)

    def read(self) -> np.ndarray | None:
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            return None
        return item

    def close(self) -> None:
        """Stop the decode thread before the caller closes the underlying
        reader (a concurrent native read during release can crash)."""
        self._stop = True
        # Unblock a worker waiting on a full queue and drain to the
        # sentinel so the thread exits.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                if not self._thread.is_alive():
                    break
                try:
                    item = self._q.get(timeout=5.0)
                except queue.Empty:
                    break
            if item is self._done:
                break
        self._thread.join(timeout=10.0)

    def __iter__(self):
        while (f := self.read()) is not None:
            yield f


def run_transcode(
    reader,
    process: Callable,
    gaze: Callable[[int], tuple[float, float]],
    sink: Callable[[np.ndarray, int], None],
    *,
    max_frames: int | None = None,
    timer: StageTimer | None = None,
    device: str | torch.device | None = None,
) -> StageTimer:
    """Device transcode loop with prefetch and a readback thread.

    ``process(frame, center) -> tensor`` takes the (H, W, 3) uint8 frame
    and the float32 (2,) gaze on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``); ``sink(frame_np, idx)`` consumes the outputs
    (encode/write).  The card's work for frame i overlaps the host decode
    of i+1 and the readback and encode of i-1.

    The readback thread copies tensors that the main thread's stream
    computes.  Each output carries an event recorded on that stream after
    ``process``; the thread waits on it before its blocking ``.cpu()``,
    so it never reads a frame the card has not finished, whatever stream
    the caller runs on.
    """
    dev = resolve_device(device)
    timer = timer or StageTimer()
    pf = PrefetchReader(reader)

    # Readback worker: device->host transfers and the sink run in a single
    # ordered thread, overlapping with the next frames' decode + device
    # compute.
    rq: queue.Queue = queue.Queue(maxsize=3)
    sink_err: list[BaseException] = []

    def drain():
        while True:
            item = rq.get()
            if item is None:
                return
            if sink_err:
                continue  # keep consuming so the producer never blocks
            dev_out, done, idx = item
            try:
                with timer.stage("d2h"):
                    if done is not None:
                        done.synchronize()
                    host = dev_out.cpu().numpy()
                with timer.stage("sink"):
                    sink(host, idx)
            except BaseException as e:  # surfaced after the loop
                sink_err.append(e)

    worker = threading.Thread(target=drain, daemon=True)
    worker.start()

    try:
        n = 0
        for frame in pf:
            with timer.stage("h2d+dispatch"):
                fj = upload(frame, dev)
                c = torch.tensor(gaze(n), dtype=torch.float32, device=dev)
                out = process(fj, c)
                done = None
                if dev.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
            rq.put((out, done, n))
            if sink_err:
                break
            n += 1
            if max_frames is not None and n >= max_frames:
                break
    finally:
        rq.put(None)
        worker.join()
        pf.close()
    if sink_err:
        raise sink_err[0]
    return timer
