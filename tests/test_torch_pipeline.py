"""The whole slice: foveax_torch's ``FoveationPipeline(device="cpu")``
against foveax's at 1920x512 -> 1072x288 (its roundtrip, and the fused
foveate -> unwarp step that foveax's bench times as ``step_fused``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.config import FoveaxConfig as FxConfig
from foveax.kernels.segreduce import sample_rect_fused as fx_sample_fused
from foveax.kernels.unwarp_pl import unwarp_rect_fused as fx_unwarp_fused
from foveax.pipeline import FoveationPipeline as FxPipeline
from foveax_torch import FoveaxConfig, FoveationPipeline

torch.set_num_threads(1)

SIZE = dict(
    source_width=1920, source_height=512, reduced_width=1072, reduced_height=288
)
CENTERS = [(0.5, 0.5), (0.999, 0.001), (0.2, 0.8)]


@pytest.fixture(autouse=True)
def _default_unwarp_knobs(monkeypatch):
    for knob in ("FOVEAX_UNWARP_ORDER", "FOVEAX_UNWARP_INT8", "FOVEAX_UNWARP_GEOM"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    frame = rng.integers(0, 256, (512, 1920, 3), np.uint8)
    fx = FxPipeline(FxConfig(**SIZE), sampler="fused")
    grid = fx.grid

    @jax.jit
    def step_fused(frame_chw, center):
        reduced = fx_sample_fused(
            frame_chw, grid, center, out_layout="chw", interpret=True
        )
        restored = fx_unwarp_fused(
            reduced, 1920, 512, center, in_layout="chw", out_layout="chw",
            interpret=True,
        )
        return reduced, restored

    return dict(
        frame=frame,
        fx=fx,
        step_fused=step_fused,
        pipe=FoveationPipeline(FoveaxConfig(**SIZE), device="cpu"),
    )


@pytest.mark.parametrize("center", CENTERS)
def test_roundtrip_matches_foveax(setup, center):
    pipe, fx = setup["pipe"], setup["fx"]
    want_red, want_out = fx.roundtrip(
        jnp.asarray(setup["frame"]), fx.center(*center)
    )
    got_red, got_out = pipe.roundtrip(
        torch.from_numpy(setup["frame"]), pipe.center(*center)
    )
    assert got_red.shape == pipe.reduced_shape == fx.reduced_shape
    assert got_out.shape == pipe.source_shape == fx.source_shape
    np.testing.assert_array_equal(got_red.numpy(), np.asarray(want_red))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))


@pytest.mark.parametrize("center", CENTERS)
def test_fused_step_matches_foveax(setup, center):
    pipe = setup["pipe"]
    chw = np.ascontiguousarray(setup["frame"].transpose(2, 0, 1))
    want_red, want_out = setup["step_fused"](
        jnp.asarray(chw), jnp.asarray(center, jnp.float32)
    )
    c = pipe.center(*center)
    got_red = pipe.foveate_chw(torch.from_numpy(chw), c)
    got_out = pipe.unwarp_auto_chw(got_red, c)
    np.testing.assert_array_equal(got_red.numpy(), np.asarray(want_red))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(
        pipe.unwarp_auto(got_red.permute(1, 2, 0), c).numpy(),
        np.asarray(want_out).transpose(1, 2, 0),
    )


def test_chw_variants_match_hwc(setup):
    pipe = setup["pipe"]
    frame = torch.from_numpy(setup["frame"])
    c = pipe.center(0.6, 0.3)
    red, out = pipe.roundtrip(frame, c)
    red_chw, out_chw = pipe.roundtrip_chw(frame.permute(2, 0, 1), c)
    np.testing.assert_array_equal(red.numpy(), red_chw.permute(1, 2, 0).numpy())
    np.testing.assert_array_equal(out.numpy(), out_chw.permute(1, 2, 0).numpy())
    np.testing.assert_array_equal(
        pipe.unwarp(red, c).numpy(), pipe.unwarp_chw(red_chw, c).numpy()
        .transpose(1, 2, 0),
    )


def test_serve_pairs(setup):
    """The serve loop's device pairs: the fused sampler has no
    gaze-independent prepare stage."""
    pipe = setup["pipe"]
    frame = torch.from_numpy(setup["frame"])
    centers = torch.tensor(CENTERS, dtype=torch.float32)
    for mode in ("auto", "fused"):
        prepare, sample_batch = pipe.batch_pair(mode)
        got = sample_batch(prepare(frame), centers)
        assert got.shape == (len(CENTERS), *pipe.reduced_shape)
        for i in range(len(CENTERS)):
            np.testing.assert_array_equal(
                got[i].numpy(), pipe.foveate(frame, centers[i]).numpy()
            )
    np.testing.assert_array_equal(
        pipe.sample_batch_fused(frame, centers).numpy(), got.numpy()
    )
    prepare, sample = pipe.single_pair()
    np.testing.assert_array_equal(
        sample(prepare(frame), centers[0]).numpy(), got[0].numpy()
    )
    with pytest.raises(ValueError, match="only the fused sampler"):
        pipe.batch_pair("sat")


def test_center_and_device(setup, monkeypatch):
    pipe = setup["pipe"]
    c = pipe.center(0.25, 0.75)
    assert c.dtype == torch.float32 and c.device.type == "cpu"
    assert c.tolist() == [0.25, 0.75]
    # The default device is the card; without one the pipeline raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FoveationPipeline(FoveaxConfig(**SIZE))


def test_ineligible_shape_raises():
    """A shape whose row steps overflow the uint16 row sums raises (the
    SAT sampler it would degrade to comes with a later slice)."""
    cfg = FoveaxConfig(
        source_width=256, source_height=8640, reduced_width=128,
        reduced_height=32,
    )
    with pytest.raises(ValueError, match="contract"):
        FoveationPipeline(cfg, device="cpu")
