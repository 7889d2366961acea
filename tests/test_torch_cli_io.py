"""The port's copies of the CLI's host helpers (``foveax_torch/io/gaze.py``,
``io/png.py`` and ``cli/main.py::_gaze_fn``) against foveax's: the cases
of ``test_io.py``, each also held equal to foveax's result on the same
input."""

import argparse

import numpy as np
import pytest

from foveax.cli.main import _gaze_fn as fx_gaze_fn
from foveax.io import gaze as fx_gaze
from foveax.io import png as fx_png
from foveax_torch.cli.main import _gaze_fn
from foveax_torch.io import GazeViewPoints, load_png, save_png
from foveax_torch.io.gaze import synthetic_trace

REFERENCE_TEXT = (
    "frame,0,forward,0.5,0.5,eye,0.51,0.49\n"
    "garbage line\n"
    "frame,1,forward,0.52,0.5,eye,0.53,0.48\n"
    "frame,2,forward,-0.1,1e-3,eye,0.5,0.5\n"
)


def test_gaze_parse_reference_format():
    g = GazeViewPoints.from_text(REFERENCE_TEXT)
    assert len(g) == 3
    assert g.points[0].gaze_point == (0.51, 0.49)
    # One-frame-lag prediction: first record predicts itself.
    assert g.points[0].pred_gaze_point == (0.51, 0.49)
    assert g.points[1].pred_gaze_point == (0.51, 0.49)
    assert g.points[2].view_point == (-0.1, 0.001)
    assert g.gaze_for_frame(99) == (0.5, 0.5)
    assert g.gaze_array().shape == (3, 2)
    fx = fx_gaze.GazeViewPoints.from_text(REFERENCE_TEXT)
    assert [vars(p) for p in g.points] == [vars(p) for p in fx.points]
    np.testing.assert_array_equal(g.gaze_array(), fx.gaze_array())


@pytest.mark.parametrize("seed, saccades", [(0, False), (3, True)])
def test_synthetic_trace_parses_back(seed, saccades):
    text = synthetic_trace(50, seed=seed, saccades=saccades)
    # The same trace text as foveax's for the same seed.
    assert text == fx_gaze.synthetic_trace(50, seed=seed, saccades=saccades)
    g = GazeViewPoints.from_text(text)
    assert len(g) == 50
    arr = g.gaze_array()
    assert (arr >= 0).all() and (arr <= 1).all()


def test_png_roundtrip(tmp_path, small_frame):
    p = tmp_path / "frame.png"
    save_png(p, small_frame)
    back = load_png(p)
    np.testing.assert_array_equal(back, small_frame)
    fx_png.save_png(tmp_path / "fx.png", small_frame)
    assert p.read_bytes() == (tmp_path / "fx.png").read_bytes()
    with pytest.raises(ValueError):
        save_png(tmp_path / "bad.png", small_frame.astype(np.int32))


def test_gaze_fn_synthetic_trace():
    """--gaze-trace synthetic[:seed] yields a deterministic moving trace
    (pursuit + saccades) without a dataset file, the same as foveax's."""
    ns = argparse.Namespace(gaze_trace="synthetic:3", gaze=(0.5, 0.5))
    g = _gaze_fn(ns)
    pts = np.asarray([g(i) for i in range(120)])
    assert pts.shape == (120, 2)
    assert np.all((pts >= 0.0) & (pts <= 1.0))
    # It moves (pursuit) and jumps (saccade at the 60-frame boundary).
    steps = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    assert steps.max() > 0.05  # a saccade
    assert 0 < np.median(steps) < 0.05  # smooth pursuit between
    g2 = _gaze_fn(argparse.Namespace(gaze_trace="synthetic:3", gaze=None))
    assert g2(17) == g(17)
    fx = fx_gaze_fn(ns)
    assert [g(i) for i in range(120)] == [fx(i) for i in range(120)]
