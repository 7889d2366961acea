"""A broadcast channel's tick, as ``BroadcastChannel._loop`` runs it:
stage the decoded frame with the server's own stager, the pipeline's
``batch_pair`` prepare (the configuration's batch sampler), snapshot every
member's gaze, stage the centres, then ``batch_sample(prepared,
centres).cpu().numpy()``: one call for all viewers.  The unit's latency
runs from the gaze snapshot to every viewer's reduced frame in host
memory."""

from __future__ import annotations

import time

import numpy as np

SPANS = ("stage", "prepare", "sample", "readback")


def make(ctx):
    from foveax_torch.serve.server import _input_stager

    pipeline, inputs = ctx.pipeline, ctx.inputs
    stage = _input_stager(pipeline.device)
    prepare, batch_sample = pipeline.batch_pair(ctx.config["batch_sampler"])

    def unit(k: int, span):
        i = inputs.frame(k)
        with span("stage"):
            staged = stage(inputs.pool[i])
        with span("prepare"):
            prepared = prepare(staged)
        gaze = inputs.gaze(k)
        t0 = time.perf_counter()
        with span("sample"):
            out = batch_sample(prepared, stage(np.asarray(gaze, dtype=np.float32)))
        with span("readback"):
            reduced = out.cpu().numpy()
        latency = time.perf_counter() - t0
        return latency, ("reduced", i, gaze, reduced)

    return unit
