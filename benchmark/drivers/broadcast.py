"""A broadcast channel's tick, as ``BroadcastChannel._loop`` runs it,
through the port's own ``serve/tick.py::ServeTick`` over the pipeline's
``batch_pair`` (the configuration's batch sampler): inside
``ServeTick.unit()``, ``tick.prepare(frame)`` stages the decoded frame
with the server's stager and prepares it, then, with every member's gaze
snapshot, ``tick.sample(prepared, gazes)`` stages the centres, samples
them in one call for all viewers and reads the reduced frames back to
host memory.  The unit's latency runs from the gaze snapshot to every
viewer's reduced frame in host memory."""

from __future__ import annotations

import time

# Each step of the unit by its name in a traced run, and the port's span
# that carries it (``trace.summarize``).
SPANS = {"stage": "serve.stage", "prepare": "serve.prepare", "sample": "serve.sample",
         "readback": "serve.readback"}


def make(ctx):
    from foveax_torch.serve.tick import ServeTick

    pipeline, inputs = ctx.pipeline, ctx.inputs
    tick = ServeTick(pipeline, pipeline.batch_pair(ctx.config["batch_sampler"]))

    def unit(k: int):
        i = inputs.frame(k)
        with ServeTick.unit(viewers=inputs.viewers):
            prepared = tick.prepare(inputs.pool[i])
            gaze = inputs.gaze(k)
            t0 = time.perf_counter()
            reduced = tick.sample(prepared, gaze)
            latency = time.perf_counter() - t0
        return latency, ("reduced", i, gaze, reduced)

    return unit
