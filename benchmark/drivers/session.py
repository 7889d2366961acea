"""One connection's tick, as ``FoveaxServer._send_frame_loop`` runs it,
through the port's own ``serve/tick.py::ServeTick`` over the pipeline's
``single_pair()``: inside ``ServeTick.unit()``, ``tick.prepare(frame)``
stages the decoded frame with the server's stager and prepares it, then,
with the gaze snapshot, ``tick.sample(prepared, (cx, cy))`` samples at
``pipeline.center(cx, cy)`` and reads the reduced frame back to host
memory.  The unit's latency runs from the gaze snapshot to the reduced
frame in host memory."""

from __future__ import annotations

import time

import numpy as np

# Each step of the unit by its name in a traced run, and the port's span
# that carries it (``trace.summarize``).
SPANS = {"stage": "serve.stage", "prepare": "serve.prepare", "sample": "serve.sample",
         "readback": "serve.readback"}


def make(ctx):
    from foveax_torch.serve.tick import ServeTick

    pipeline, inputs = ctx.pipeline, ctx.inputs
    tick = ServeTick(pipeline, pipeline.single_pair(), single=True)

    def unit(k: int):
        i = inputs.frame(k)
        with ServeTick.unit(viewers=1):
            prepared = tick.prepare(inputs.pool[i])
            gaze = inputs.gaze(k)
            t0 = time.perf_counter()
            reduced = tick.sample(prepared, (float(gaze[0, 0]), float(gaze[0, 1])))
            latency = time.perf_counter() - t0
        return latency, ("reduced", i, gaze, reduced[np.newaxis])

    return unit
