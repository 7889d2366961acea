"""One connection's tick, as ``FoveaxServer._send_frame_loop`` runs it:
stage the decoded frame with the server's own stager, the pipeline's
``single_pair()`` prepare, snapshot the gaze, then ``sample_one(prepared,
pipeline.center(cx, cy)).cpu().numpy()``.  The unit's latency runs from
the gaze snapshot to the reduced frame in host memory."""

from __future__ import annotations

import time

import numpy as np

SPANS = ("stage", "prepare", "sample", "readback")


def make(ctx):
    from foveax_torch.serve.server import _input_stager

    pipeline, inputs = ctx.pipeline, ctx.inputs
    stage = _input_stager(pipeline.device)
    prepare, sample_one = pipeline.single_pair()

    def unit(k: int, span):
        i = inputs.frame(k)
        with span("stage"):
            staged = stage(inputs.pool[i])
        with span("prepare"):
            prepared = prepare(staged)
        gaze = inputs.gaze(k)
        cx, cy = float(gaze[0, 0]), float(gaze[0, 1])
        t0 = time.perf_counter()
        with span("sample"):
            out = sample_one(prepared, pipeline.center(cx, cy))
        with span("readback"):
            reduced = out.cpu().numpy()
        latency = time.perf_counter() - t0
        return latency, ("reduced", i, gaze, reduced[np.newaxis])

    return unit
