"""A whole run, past the harness's look for a card, on the CPU at a small
size: sound, it is correct; with the timed path broken underneath, or
with the control in the program's place, it is not.  The ``cuda`` case
runs each cell at its own size on the card, sound and with the control.

The faults a cell of this benchmark can have: a unit that returns its
state unchanged (the previous tick's frames), half of a broadcast batch
left out (its frames copied from the other half), and a value altered
where it is produced.  No cell spans chips, so none leaves out an
exchange between them.  The 1080p session cell, which the manifest
leaves out, is added back here as data, so that its driver and its tail
stay held."""

import json
import time

import pytest
import torch

from benchmark.control import control_patch
from benchmark.harness import CHECKOUT, load_cell, run_cell

SMALL = dict(source_width=192, source_height=108, reduced_width=112, reduced_height=64)
MANIFEST = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
CARD_CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _with_session(manifest: dict) -> dict:
    """The manifest with the 1080p session cell added back as data: its
    configuration, the cell, its gaze-to-frame tail, and the tick cells'
    per-layer metrics, as a later benchmark PR would add them."""
    m = json.loads(json.dumps(manifest))
    conf = json.loads((CHECKOUT / "benchmark/configs/ref1080p.json").read_text())
    m["configs"].append({"name": "ref1080p", "source": conf["source"], "why": "the upstream's stream",
                         "file": "benchmark/configs/ref1080p.json", "reduced": conf["reduced"]})
    m["workloads"].append({"name": "ref1080p.session", "config": "ref1080p", "traffic": "session1",
                           "chips": 1, "why": "one connection at 1080p, closed loop"})
    m["end_to_end"].append({"name": "gaze_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                            "source": "host_clock", "workloads": ["ref1080p.session"]})
    for metric in m["end_to_end"] + m["per_layer"]:
        if metric.get("workloads") == ["equirect8k.broadcast8"]:
            metric["workloads"].append("ref1080p.session")
    return m


CELLS = ["ref1080p.session"] + CARD_CELLS


def _cell(name, **shape):
    c = load_cell(name, _with_session(MANIFEST))
    c.config = dict(c.config, **(shape or SMALL))
    return c


def _run(cell, patch=None, seconds=0.6, seed=2**31 + 11):
    return run_cell(cell, seed, seconds, False, device="cpu", t_start=time.perf_counter(),
                    patch=patch, log=lambda s: None)


def _stale(pipeline):
    """The first output forever: a step that returns its state unchanged."""
    memo = {}

    def wrap(fn):
        def f(*a):
            if "out" not in memo:
                memo["out"] = fn(*a)
            return memo["out"]
        return f

    one, batch = pipeline.single_pair, pipeline.batch_pair
    unwarp = pipeline.unwarp_auto
    pipeline.single_pair = lambda: (one()[0], wrap(one()[1]))
    pipeline.batch_pair = lambda s="auto": (batch(s)[0], wrap(batch(s)[1]))
    pipeline.unwarp_auto = wrap(unwarp)


def _half_batch(pipeline):
    """A broadcast tick that samples half of its gazes and fills the rest
    from them."""
    batch = pipeline.batch_pair

    def pair(s="auto"):
        prepare, sample = batch(s)

        def half(frame, centers):
            n = len(centers)
            out = sample(frame, centers[: max(1, n // 2)])
            return torch.cat([out] * 2)[:n] if n > 1 else out
        return prepare, half
    pipeline.batch_pair = pair


def _altered(pipeline):
    """One value of every output off by one where it is produced."""
    one, batch = pipeline.single_pair, pipeline.batch_pair
    unwarp = pipeline.unwarp_auto

    def alter(fn):
        def f(*a):
            out = fn(*a).clone()
            out.view(-1)[7] ^= 1
            return out
        return f

    pipeline.single_pair = lambda: (one()[0], alter(one()[1]))
    pipeline.batch_pair = lambda s="auto": (batch(s)[0], alter(batch(s)[1]))
    pipeline.unwarp_auto = alter(unwarp)


def _fovea_nudged(pipeline):
    """The restored pixel at the gaze off by one: within the stated 1 LSB,
    but the fovea no longer equals its texel, as where a kernel blends
    through it."""
    unwarp = pipeline.unwarp_auto

    def f(reduced, center):
        out = unwarp(reduced, center).clone()
        h, w, _ = out.shape
        cx, cy = center.tolist()
        out[int(cy * h), int(cx * w)] ^= 1
        return out

    pipeline.unwarp_auto = f


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(_cell(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in _cell(name).end_to_end}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_stale, _altered], ids=["stale", "altered"])
def test_fault_is_not_correct(name, fault):
    assert not _run(_cell(name), fault)["correct"]


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
def test_fovea_nudged_is_not_correct(seed):
    r = _run(_cell("equirect8k.restore"), _fovea_nudged, seed=seed)
    assert not r["correct"]
    assert r["checks"]["restore_bytes_over_1lsb"]["value"] == 0
    assert r["checks"]["restore_fovea_bytes_off"]["value"] > 0


def test_half_batch_is_not_correct():
    assert not _run(_cell("equirect8k.broadcast8"), _half_batch)["correct"]


@pytest.mark.parametrize("name, shape", [
    ("ref1080p.session", dict(source_width=960, source_height=540, reduced_width=544, reduced_height=304)),
    ("equirect8k.restore", {}),
])
def test_control_is_not_correct(name, shape):
    cell = _cell(name, **shape)
    r = _run(cell, control_patch(cell.config), seconds=1.0)
    assert not r["correct"], r["checks"]


def test_traced_run_reads_its_metrics():
    r = run_cell(_cell("ref1080p.session"), 5, 1.0, True, device="cpu",
                 t_start=time.perf_counter(), log=lambda s: None)
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
    assert "sampler.host_ms" in r["metrics"] and "breakdown" in r


def test_session_cell_reports_its_tail():
    r = _run(_cell("ref1080p.session"))
    assert r["correct"] and set(r["metrics"]) == {"viewer_fps", "gaze_p95_ms", "setup_s"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CELLS)
def test_cell_on_card_sound_and_control(card, name):
    cell = load_cell(name)
    ok = run_cell(cell, 3, 1.0, False, device=card, t_start=time.perf_counter(),
                  log=lambda s: None)
    assert ok["correct"], ok["checks"]
    bad = run_cell(cell, 4, 2.0, False, device=card, t_start=time.perf_counter(),
                   patch=control_patch(cell.config), log=lambda s: None)
    assert not bad["correct"], bad["checks"]
