"""A client's restore, as ``FoveaxClient`` runs it for a client with a
``frame_sink`` (serve/client.py): upload the decoded reduced frame and the
gaze it was sampled with, ``pipeline.unwarp_auto``, then the restored
frame back to host memory.  The unit's latency runs from the decoded frame
in host memory to the restored frame in host memory."""

from __future__ import annotations

import time

import numpy as np
import torch

SPANS = ("upload", "unwarp", "readback")


def make(ctx):
    pipeline, inputs = ctx.pipeline, ctx.inputs
    dev = pipeline.device

    def unit(k: int, span):
        i = inputs.frame(k)
        gaze = inputs.gaze(k)
        t0 = time.perf_counter()
        with span("upload"):
            reduced = torch.from_numpy(np.ascontiguousarray(inputs.pool[i])).to(dev)
            center = torch.tensor((float(gaze[0, 0]), float(gaze[0, 1])), dtype=torch.float32).to(dev)
        with span("unwarp"):
            full = pipeline.unwarp_auto(reduced, center)
        with span("readback"):
            full_np = full.cpu().numpy()
        latency = time.perf_counter() - t0
        return latency, ("restored", i, gaze, full_np)

    return unit
