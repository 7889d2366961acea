"""The traffic generator: gazes, the input pool and the sample of checked
units come from the seed alone."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.inputs import Inputs, Reservoir, gaze_trace, seed_sequence

ROOT = Path(__file__).resolve().parents[1]
CONFIG = dict(json.loads((ROOT / "configs" / "equirect8k.json").read_text()),
              source_width=96, source_height=64, reduced_width=64, reduced_height=48)


def _traffic(name):
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("mix", ["session1", "broadcast8", "restore1"])
def test_same_seed_same_inputs_other_seed_other(mix):
    t = _traffic(mix)
    a = Inputs(2**31 + 17, CONFIG, t, torch.device("cpu"))
    b = Inputs(2**31 + 17, CONFIG, t, torch.device("cpu"))
    c = Inputs(2**31 + 18, CONFIG, t, torch.device("cpu"))
    np.testing.assert_array_equal(a.gazes, b.gazes)
    for fa, fb in zip(a.pool, b.pool):
        np.testing.assert_array_equal(fa, fb)
    assert not np.array_equal(a.gazes, c.gazes)
    assert not np.array_equal(a.pool[0], c.pool[0])
    assert len(a.pool) == t["pool"]
    shape = (64, 96, 3) if t["frames"] == "source" else (48, 64, 3)
    assert all(f.shape == shape and f.dtype == np.uint8 for f in a.pool)
    assert a.gazes.shape == (t["gaze"]["trace_steps"], t["viewers"], 2)


def test_negative_and_large_seeds():
    for seed in (-5, 0, 2**31 + 1, 2**40 + 3):
        seed_sequence(seed).generate_state(1)
    assert not np.array_equal(seed_sequence(-5).generate_state(2), seed_sequence(5).generate_state(2))


def test_gaze_model():
    p = _traffic("broadcast8")["gaze"]
    g = gaze_trace(np.random.default_rng(3), 8, p)
    assert g.dtype == np.float32
    assert (g >= 0).all() and (g < 1).all()
    # the gaze moves every tick
    assert (np.abs(np.diff(g, axis=0)).max(axis=-1) > 0).all()
    # most of the time within the band of latitudes
    y = g[..., 1]
    band = ((y >= p["band"][0] - 0.05) & (y <= p["band"][1] + 0.05)).mean()
    assert 0.65 < band < 0.95, band
    # saccades cross the wrap seam: some steps jump by nearly a whole frame
    jumps = np.abs(np.diff(g[..., 0], axis=0))
    assert (jumps > 0.5).any()
    # fixations hold: most steps move by little
    assert np.median(np.abs(np.diff(g, axis=0))) < 0.01


def test_reservoir_uniform_and_seeded():
    hits = np.zeros(200)
    for s in range(400):
        r = Reservoir(8, np.random.default_rng(s))
        for i in range(200):
            r.offer(i)
        assert len(r.items) == 8 and len(set(r.items)) == 8
        hits[r.items] += 1
    # each item is kept with probability 8/200: 16 of 400 on average
    assert hits.mean() == pytest.approx(16)
    assert hits[:100].sum() == pytest.approx(hits[100:].sum(), rel=0.15)
    a, b = Reservoir(4, np.random.default_rng(9)), Reservoir(4, np.random.default_rng(9))
    for i in range(1000):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def test_reservoir_fewer_items_than_size():
    r = Reservoir(8, np.random.default_rng(1))
    for i in range(3):
        r.offer(i)
    assert r.items == [0, 1, 2]
