"""A client's restore, as ``FoveaxClient`` runs it for a client with a
``frame_sink`` (serve/client.py), through the port's own
``serve/client.py::ClientRestore``: one call with the decoded reduced
frame and the gaze it was sampled with uploads both, runs
``pipeline.unwarp_auto`` and reads the restored frame back to host
memory.  The unit's latency runs from the decoded frame in host memory to
the restored frame in host memory."""

from __future__ import annotations

import time

# Each step of the unit by its name in a traced run, and the port's span
# that carries it (``trace.summarize``): the unwarp is what the restore's
# root span holds outside its upload and readback.
SPANS = {"upload": "client.upload", "unwarp": "client.restore", "readback": "client.readback"}


def make(ctx):
    from foveax_torch.serve.client import ClientRestore

    pipeline, inputs = ctx.pipeline, ctx.inputs
    restore = ClientRestore(pipeline)

    def unit(k: int):
        i = inputs.frame(k)
        gaze = inputs.gaze(k)
        t0 = time.perf_counter()
        full = restore(inputs.pool[i], (float(gaze[0, 0]), float(gaze[0, 1])))
        latency = time.perf_counter() - t0
        return latency, ("restored", i, gaze, full)

    return unit
