"""The whole port: foveax_torch's ``FoveationPipeline(device="cpu")``
against foveax's at 1920x512 -> 1072x288: the fused path (its roundtrip,
and the fused foveate -> unwarp step that foveax's bench times as
``step_fused``), the SAT path (``sampler="sat"``: foveate, roundtrip,
their batches and the serve pairs), the direct path (``sampler="direct"``
and ``batch_pair("direct")``) and the degrade to SAT of a shape outside
the fused sampler's contract (a row-sum bound, and at 36,000 columns
``segment_reduce_xy``'s shared memory)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.config import FoveaxConfig as FxConfig
from foveax.core.logrect import make_grid as fx_make_grid
from foveax.core.sample import sample_rect_from_sat as fx_sample_sat
from foveax.core.sat import build_sat as fx_build_sat
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
        fx_sat=FxPipeline(FxConfig(**SIZE), sampler="sat"),
        pipe_sat=FoveationPipeline(
            FoveaxConfig(**SIZE), sampler="sat", device="cpu"
        ),
        fx_direct=FxPipeline(FxConfig(**SIZE), sampler="direct"),
        pipe_direct=FoveationPipeline(
            FoveaxConfig(**SIZE), sampler="direct", device="cpu"
        ),
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
    gaze-independent prepare stage; the SAT pair prepares one SAT per
    frame, and its batch equals the fused pair's and foveax's SAT pair."""
    pipe, fx_sat = setup["pipe"], setup["fx_sat"]
    frame = torch.from_numpy(setup["frame"])
    centers = torch.tensor(CENTERS, dtype=torch.float32)
    for mode in ("auto", "fused"):
        prepare, sample_batch = pipe.batch_pair(mode)
        assert prepare(frame) is frame
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
    prepare, sample_batch = pipe.batch_pair("sat")
    sat = prepare(frame)
    assert sat.dtype == torch.uint32 and sat.shape == (3, 512, 1920)
    np.testing.assert_array_equal(sample_batch(sat, centers).numpy(), got.numpy())
    fx_prepare, fx_sample_batch = fx_sat.batch_pair("sat")
    want = fx_sample_batch(
        fx_prepare(jnp.asarray(setup["frame"])), jnp.asarray(centers.numpy())
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    prepare, sample_batch = pipe.batch_pair("direct")
    assert prepare(frame) is frame
    np.testing.assert_array_equal(
        sample_batch(prepare(frame), centers).numpy(), got.numpy()
    )


@pytest.mark.parametrize("center", CENTERS)
def test_direct_pipeline_matches_foveax(setup, center):
    """``sampler="direct"``: the roundtrip equals foveax's direct pipeline
    and the fused path (tolerance 0), in both layouts."""
    pipe = setup["pipe_direct"]
    assert pipe.sampler == "direct"
    frame = torch.from_numpy(setup["frame"])
    c = pipe.center(*center)
    red, out = pipe.roundtrip(frame, c)
    fx = setup["fx_direct"]
    want_red, want_out = fx.roundtrip(jnp.asarray(setup["frame"]), fx.center(*center))
    np.testing.assert_array_equal(red.numpy(), np.asarray(want_red))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(red.numpy(), setup["pipe"].foveate(frame, c).numpy())
    red_chw = pipe.foveate_chw(frame.permute(2, 0, 1).contiguous(), c)
    np.testing.assert_array_equal(red_chw.permute(1, 2, 0).numpy(), red.numpy())


def test_sat_serve_pairs(setup):
    """The SAT pipeline's pairs: ``batch_pair("auto")`` stays fused at an
    eligible shape, ``single_pair()`` is the SAT pair, as foveax's."""
    pipe, fx_sat = setup["pipe_sat"], setup["fx_sat"]
    frame = torch.from_numpy(setup["frame"])
    c = pipe.center(*CENTERS[2])
    prepare, sample = pipe.single_pair()
    sat = prepare(frame)
    assert sat.dtype == torch.uint32
    fx_prepare, fx_sample = fx_sat.single_pair()
    want = fx_sample(fx_prepare(jnp.asarray(setup["frame"])), fx_sat.center(*CENTERS[2]))
    np.testing.assert_array_equal(sample(sat, c).numpy(), np.asarray(want))
    prepare, _ = pipe.batch_pair("auto")
    assert prepare(frame) is frame


@pytest.mark.parametrize("center", CENTERS)
def test_sat_pipeline_matches_foveax(setup, center):
    pipe, fx = setup["pipe_sat"], setup["fx_sat"]
    assert pipe.sampler == fx.sampler == "sat"
    want_red, want_out = fx.roundtrip(
        jnp.asarray(setup["frame"]), fx.center(*center)
    )
    frame = torch.from_numpy(setup["frame"])
    c = pipe.center(*center)
    got_red, got_out = pipe.roundtrip(frame, c)
    np.testing.assert_array_equal(got_red.numpy(), np.asarray(want_red))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(pipe.foveate(frame, c).numpy(), got_red.numpy())
    # The chw SAT path and the fused pipeline give the same frame.
    chw = frame.permute(2, 0, 1).contiguous()
    red_chw = pipe.foveate_chw(chw, c)
    np.testing.assert_array_equal(red_chw.permute(1, 2, 0).numpy(), got_red.numpy())
    np.testing.assert_array_equal(
        setup["pipe"].foveate_chw(chw, c).numpy(), red_chw.numpy()
    )


def test_sat_batches_match_foveax(setup):
    pipe, fx = setup["pipe_sat"], setup["fx_sat"]
    centers = np.asarray(CENTERS, np.float32)
    frame = setup["frame"]
    want = fx.foveate_batch(jnp.asarray(frame), jnp.asarray(centers))
    got = pipe.foveate_batch(torch.from_numpy(frame), torch.from_numpy(centers))
    assert got.shape == (len(CENTERS), *pipe.reduced_shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_red, want_out = fx.roundtrip_batch(jnp.asarray(frame), jnp.asarray(centers))
    got_red, got_out = pipe.roundtrip_batch(
        torch.from_numpy(frame), torch.from_numpy(centers)
    )
    assert got_out.shape == (len(CENTERS), *pipe.source_shape)
    np.testing.assert_array_equal(got_red.numpy(), np.asarray(want_red))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))


def test_center_and_device(setup, monkeypatch):
    pipe = setup["pipe"]
    c = pipe.center(0.25, 0.75)
    assert c.dtype == torch.float32 and c.device.type == "cpu"
    assert c.tolist() == [0.25, 0.75]
    # The default device is the card; without one the pipeline raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FoveationPipeline(FoveaxConfig(**SIZE))


# A shape whose row steps (max_dy 391) overflow the fused sampler's uint16
# row sums.
SMALL = dict(
    source_width=1920, source_height=1080, reduced_width=64, reduced_height=36
)


def test_ineligible_shape_raises():
    """An explicit "fused" on a shape outside its contract raises: the
    port refuses it through its uint16 row-sum bound (foveax's probe admits
    it, and its fused sampler wraps there).  The direct sampler, exact at
    every shape, runs there and equals the SAT path; an unknown sampler
    raises."""
    with pytest.raises(ValueError, match="contract"):
        FoveationPipeline(FoveaxConfig(**SMALL), sampler="fused", device="cpu")
    pipe = FoveationPipeline(FoveaxConfig(**SMALL), sampler="direct", device="cpu")
    sat = FoveationPipeline(FoveaxConfig(**SMALL), sampler="sat", device="cpu")
    frame = torch.from_numpy(
        np.random.default_rng(24).integers(0, 256, (1080, 1920, 3), np.uint8)
    )
    c = pipe.center(0.98, 0.03)
    assert torch.equal(pipe.foveate(frame, c), sat.foveate(frame, c))
    with pytest.raises(ValueError, match="expected one of"):
        FoveationPipeline(FoveaxConfig(**SMALL), sampler="mm", device="cpu")


def test_ineligible_shape_degrades_to_sat():
    """"auto" resolves to the SAT sampler there, and equals foveax's CPU
    pipeline (SAT on the CPU) at that shape."""
    pipe = FoveationPipeline(FoveaxConfig(**SMALL), device="cpu")
    assert pipe.sampler == "sat"
    fx = FxPipeline(FxConfig(**SMALL))
    assert fx.sampler == "sat"
    frame = np.random.default_rng(23).integers(0, 256, (1080, 1920, 3), np.uint8)
    center = (0.3, 0.6)
    want_red, want_out = fx.roundtrip(jnp.asarray(frame), fx.center(*center))
    got_red, got_out = pipe.roundtrip(torch.from_numpy(frame), pipe.center(*center))
    np.testing.assert_array_equal(got_red.numpy(), np.asarray(want_red))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    prepare, sample_batch = pipe.batch_pair("auto")
    got = sample_batch(prepare(torch.from_numpy(frame)), pipe.center(*center)[None])
    np.testing.assert_array_equal(got[0].numpy(), got_red.numpy())


def test_ineligible_shape_saturated_edge_gaze():
    """At an edge gaze with an all-255 frame, where valid row boxes reach
    dy = 268 and foveax's fused sampler wraps its uint16 row sums, the
    port's "auto" (the SAT path) equals foveax's SAT sampler: every valid
    cell 255, every invalid one 0."""
    pipe = FoveationPipeline(FoveaxConfig(**SMALL), device="cpu")
    assert pipe.sampler == "sat"
    frame = np.full((1080, 1920, 3), 255, np.uint8)
    center = (0.5, 0.0)
    grid = fx_make_grid(64, 36, 1920, 1080)
    want = np.asarray(
        fx_sample_sat(
            fx_build_sat(jnp.asarray(frame)), grid,
            jnp.asarray(center, jnp.float32),
        )
    )
    got = pipe.foveate(torch.from_numpy(frame), pipe.center(*center)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 255}


# Wider than a segment_reduce_xy block's shared memory allows (233,064
# bytes for 36,000 source and 20,000 reduced columns), and than one K5
# scanning block spans (32,768 columns).
WIDE = dict(
    source_width=36000, source_height=64, reduced_width=20000, reduced_height=48
)


def test_wide_shape_takes_the_sat_path():
    """Past 35,888 source columns "auto" resolves "sat", as foveax's
    pipeline does there, and its reduced frame equals foveax's; an explicit
    "fused" raises naming the width and the bytes; ``batch_pair("auto")``
    is the SAT pair."""
    pipe = FoveationPipeline(FoveaxConfig(**WIDE), device="cpu")
    assert (pipe.sampler, pipe.fused_ok) == ("sat", False)
    fx = FxPipeline(FxConfig(**WIDE))
    assert fx.sampler == "sat"
    frame = np.random.default_rng(25).integers(0, 256, (64, 36000, 3), np.uint8)
    center = (0.3, 0.6)
    want = np.asarray(fx.foveate(jnp.asarray(frame), fx.center(*center)))
    got = pipe.foveate(torch.from_numpy(frame), pipe.center(*center))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="source width 36000 .* 233064 bytes"):
        FoveationPipeline(FoveaxConfig(**WIDE), sampler="fused", device="cpu")
    prepare, sample_batch = pipe.batch_pair("auto")
    assert prepare == pipe.build_sat
    got_b = sample_batch(prepare(torch.from_numpy(frame)), pipe.center(*center)[None])
    np.testing.assert_array_equal(got_b[0].numpy(), want)


# F3 (ROADMAP Queue 3): from 32,768 source columns foveax's fused sampler
# raises in interpret mode, though its eligibility admits the shape.
F3 = dict(source_width=32768, source_height=64, reduced_width=18208,
          reduced_height=48)


def test_f3_port_fused_matches_foveax_sat_past_32767():
    """At 32768x64 -> 18208x48 the port's fused sampler (inside its
    contract) equals foveax's jitted SAT sampler, where foveax's own fused
    sampler raises a TypeError (a negative slice size)."""
    pipe = FoveationPipeline(FoveaxConfig(**F3), device="cpu")
    assert pipe.sampler == "fused"
    frame = np.random.default_rng(32).integers(0, 256, (64, 32768, 3), np.uint8)
    grid = fx_make_grid(18208, 48, 32768, 64)
    centers = [(0.3, 0.6), (0.0005, 0.5)]
    sat = fx_build_sat(jnp.asarray(frame))
    sample = jax.jit(lambda s, c: fx_sample_sat(s, grid, c))
    for center in centers:
        c = jnp.asarray(center, jnp.float32)
        want = np.asarray(sample(sat, c))
        got = pipe.foveate(torch.from_numpy(frame), pipe.center(*center))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError, match="slice_sizes must be greater than or equal to zero"):
        fx_sample_fused(jnp.asarray(frame.transpose(2, 0, 1)), grid,
                        jnp.asarray(centers[0], jnp.float32), out_layout="chw",
                        interpret=True)


def test_default_pipeline_matches_foveax(monkeypatch):
    """``default_pipeline(device="cpu")`` has foveax's configuration, wrap
    and grid, and the sampler foveax's "auto" takes on an accelerator
    (fused; on the CPU foveax's takes its SAT path); it is built once per
    device, and the default device is the card (raises without a GPU)."""
    import dataclasses

    from foveax.pipeline.frames import default_pipeline as fx_default
    from foveax_torch.pipeline.frames import default_pipeline

    fx, pipe = fx_default(), default_pipeline(device="cpu")
    assert dataclasses.asdict(pipe.config) == dataclasses.asdict(fx.config)
    assert (pipe.sampler, pipe.wrap_x) == ("fused", fx._wrap_x)
    assert pipe.device.type == "cpu"
    np.testing.assert_array_equal(pipe.grid.gx.numpy(), np.asarray(fx.grid.gx))
    np.testing.assert_array_equal(pipe.grid.gy.numpy(), np.asarray(fx.grid.gy))
    assert default_pipeline(device="cpu") is pipe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_pipeline()
