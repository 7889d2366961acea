"""foveax_torch's gnomonic viewport (``core/gnomonic.py``) on the CPU,
held against foveax on the same inputs made from numpy seeds.  The float32
trigonometry of the two libraries is not correctly rounded in the same
way, so a source index may move by one at a cell border: every source
index stays within 1 of foveax's, and the share of viewport pixels that
differ stays under a stated bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.core import golden
from foveax.core.gnomonic import gnomonic_project as fx_gnomonic
from foveax_torch.core.gnomonic import gnomonic_project

torch.set_num_threads(1)

GAZES = [(0.5, 0.5), (0.3, 0.4), (0.0, 0.0), (0.97, 0.9), (0.37, 0.61), (0.0, 1.0)]
# Share of viewport pixels whose source index differs from foveax's:
# measured worst 3.75% at 40x20 and 2.1% at 48x32 over three seeds and
# six gazes.
SHARE_DIFFERENT = 0.05


def _index_frame(w, h):
    """Each pixel names its own source index: R = x, G = y (w, h <= 256),
    B = a seeded random byte."""
    yy, xx = np.mgrid[0:h, 0:w]
    b = np.random.default_rng(w * h).integers(0, 256, (h, w))
    return np.stack([xx, yy, b], axis=-1).astype(np.uint8)


@pytest.mark.parametrize("shape", [(96, 64, 40, 20), (256, 128, 96, 48)],
                         ids=["96x64", "256x128"])
@pytest.mark.parametrize("gaze", GAZES)
def test_source_indices_within_one_of_foveax(shape, gaze):
    w, h, ow, oh = shape
    frame = _index_frame(w, h)
    project = jax.jit(lambda f, c: fx_gnomonic(f, ow, oh, c))
    want = np.asarray(project(jnp.asarray(frame), jnp.asarray(gaze, jnp.float32)))
    got = gnomonic_project(torch.from_numpy(frame), ow, oh,
                           torch.tensor(gaze, dtype=torch.float32)).numpy()
    assert got.shape == (oh, ow, 3) and got.dtype == np.uint8
    dx = np.abs(got[..., 0].astype(np.int32) - want[..., 0].astype(np.int32))
    dy = np.abs(got[..., 1].astype(np.int32) - want[..., 1].astype(np.int32))
    dx = np.minimum(dx, w - dx)  # the 360 seam
    # On a pole row every longitude is the same point of the sphere: the
    # viewport centre at a polar gaze lands there with any x (jitted
    # foveax gives x = 30 at gaze (0, 0) where its eager run gives 0).
    pole = np.isin(want[..., 1], (0, h - 1))
    assert dx[~pole].max(initial=0) <= 1 and dy.max() <= 1, (dx.max(), dy.max())
    assert (got != want).any(-1).mean() <= SHARE_DIFFERENT


def test_matches_float64_golden():
    frame = np.random.default_rng(1).integers(0, 256, (64, 96, 3), np.uint8)
    out = gnomonic_project(torch.from_numpy(frame), 40, 20,
                           torch.tensor([0.5, 0.5])).numpy()
    ref = golden.gnomonic_project(frame, 40, 20, (0.5, 0.5))
    assert (out == ref).all(axis=-1).mean() > 0.97


def test_center_pixel_is_gaze_point():
    frame = np.random.default_rng(2).integers(0, 256, (64, 96, 3), np.uint8)
    center = (0.37, 0.61)
    out = gnomonic_project(torch.from_numpy(frame), 40, 20,
                           torch.tensor(center, dtype=torch.float32)).numpy()
    gx = int(np.clip(center[0] % 1.0, 0, 0.999) * 96)
    gy = int(np.clip(center[1] % 1.0, 0, 0.999) * 64)
    np.testing.assert_array_equal(out[10, 20], frame[gy, gx])


def test_odd_viewport_at_the_pole():
    frame = np.random.default_rng(3).integers(0, 256, (64, 96, 3), np.uint8)
    out = gnomonic_project(torch.from_numpy(frame), 33, 17,
                           torch.tensor([0.0, 1.0])).numpy()
    assert out.shape == (17, 33, 3)
