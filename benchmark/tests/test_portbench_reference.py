"""The plain reference against the port's plain CPU path at small
shapes: the reduced frames bit-equal (fused and SAT samplers), the
restored frames within 1 LSB and equal on the fovea; and the control,
one precision lower, off where it must be."""

import numpy as np
import pytest
import torch

from benchmark.reference.foveation import BoxFilter, Unwarp
from foveax_torch.config import FoveaxConfig, reduced_dim
from foveax_torch.pipeline.frames import FoveationPipeline

SHAPES = [(192, 108), (330, 170), (256, 128), (97, 61)]
SEAM = [(0.0, 0.5), (0.9999, 0.02), (0.5, 0.999), (0.001, 0.0)]


def _setup(w, h, seed):
    cfg = FoveaxConfig(source_width=w, source_height=h, reduced_width=reduced_dim(w),
                       reduced_height=reduced_dim(h))
    pipe = FoveationPipeline(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    gazes = np.concatenate([rng.random((4, 2)), SEAM]).astype(np.float32)
    return cfg, pipe, frame, gazes


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampler", ["fused", "sat"])
def test_reduced_frames_bit_equal(shape, sampler):
    cfg, pipe, frame, gazes = _setup(*shape, 1)
    if sampler == "fused" and not pipe.fused_ok:
        pytest.skip("outside the fused sampler's contract")
    prepare, sample = pipe.batch_pair(sampler)
    got = sample(prepare(torch.from_numpy(frame)), torch.from_numpy(gazes)).numpy()
    box = BoxFilter(cfg.source_width, cfg.source_height, cfg.reduced_width, cfg.reduced_height)
    for i, g in enumerate(gazes):
        np.testing.assert_array_equal(box(torch.from_numpy(frame), g, key=0).numpy(), got[i])
    # the session path, one gaze at a time
    prep1, one = pipe.single_pair()
    got1 = one(prep1(torch.from_numpy(frame)), pipe.center(float(gazes[2, 0]), float(gazes[2, 1])))
    np.testing.assert_array_equal(got1.numpy(), got[2])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_restored_frames_within_1_lsb_fovea_exact(shape):
    cfg, pipe, _, gazes = _setup(*shape, 2)
    rng = np.random.default_rng(3)
    unwarp = Unwarp(cfg.source_width, cfg.source_height)
    for g in gazes:
        red = rng.integers(0, 256, (cfg.reduced_height, cfg.reduced_width, 3), dtype=np.uint8)
        c = torch.tensor((float(g[0]), float(g[1])), dtype=torch.float32)
        ref, fovea = unwarp(torch.from_numpy(red), g)
        ref = ref.numpy().astype(np.int16)
        for precision in ("auto", "exact"):
            got = pipe.unwarp_auto(torch.from_numpy(red), c) if precision == "auto" else \
                pipe.unwarp(torch.from_numpy(red), c)
            d = np.abs(got.numpy().astype(np.int16) - ref)
            assert d.max() <= 1
            assert (d[fovea.numpy()] == 0).all()
        assert fovea.numpy().any()


def test_controls_are_off():
    """Float32 box sums and a bfloat16 blend break the guarantees at a
    960x540 source (the cells' shapes are larger still)."""
    cfg, pipe, frame, gazes = _setup(960, 540, 4)
    args = (cfg.source_width, cfg.source_height, cfg.reduced_width, cfg.reduced_height)
    exact, low = BoxFilter(*args), BoxFilter(*args, precision="control")
    f = torch.from_numpy(frame)
    off = sum(int((exact(f, g, key=0) != low(f, g, key=0)).sum()) for g in gazes[:3])
    assert off > 1000
    red = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (cfg.reduced_height, cfg.reduced_width, 3), dtype=np.uint8))
    a, _ = Unwarp(960, 540)(red, gazes[0])
    b, _ = Unwarp(960, 540, precision="control")(red, gazes[0])
    assert int(((a.to(torch.int16) - b.to(torch.int16)).abs() > 1).sum()) > 1000
