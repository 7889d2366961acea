"""The CUDA kernels of foveax_torch on the card: each wrapper against its
plain version (tolerance 0), its input checks and its launch count.

These tests need a CUDA device and skip without one.  On the card, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the port's
machine does not need)."""

import numpy as np
import pytest
import torch

from foveax_torch import FoveaxConfig, FoveationPipeline
from foveax_torch.kernels import segreduce as sr
from foveax_torch.kernels import unwarp as uw

pytestmark = pytest.mark.cuda

CFG = FoveaxConfig(
    source_width=1920, source_height=512, reduced_width=1072, reduced_height=288
)
CENTERS = [(0.5, 0.5), (0.0, 0.0), (1.0, 1.0), (0.999, 0.001), (0.03, 0.4)]


@pytest.fixture(scope="module")
def pipe():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return FoveationPipeline(CFG)


@pytest.fixture(scope="module")
def frame(pipe):
    rng = np.random.default_rng(13)
    return torch.from_numpy(rng.integers(0, 256, (3, 512, 1920), np.uint8)).cuda()


def _equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.to(torch.int32), want.to(torch.int32))


@pytest.mark.parametrize("batch", [False, True])
def test_sampler_kernels_match_plain(pipe, frame, batch):
    gazes = CENTERS if batch else CENTERS[:1]
    centers = torch.tensor(gazes, dtype=torch.float32, device="cuda")
    pxc, pxmc, vx, pyc, pymc, vy = sr.fused_taps(pipe.grid, frame, centers)
    rows = sr.y_segment_reduce_batch(frame, pymc, pyc)
    _equal(rows, sr.y_segment_reduce_batch_plain(frame, pymc, pyc))
    args = (rows, pxmc, pxc, vx, pymc, pyc, vy)
    _equal(sr.x_segment_reduce_batch(*args), sr.x_segment_reduce_batch_plain(*args))


@pytest.mark.parametrize("center", CENTERS)
def test_unwarp_kernels_match_plain(pipe, frame, center):
    c = pipe.center(*center)
    reduced = pipe.foveate_chw(frame, c)
    xv, yv = uw.fused_vectors(288, 1072, 1920, 512, c)
    xb = uw.unwarp_x_pass(reduced, *xv)
    _equal(xb, uw.unwarp_x_pass_plain(reduced, *xv))
    _equal(uw.unwarp_y_pass(xb, *yv), uw.unwarp_y_pass_plain(xb, *yv))


def test_pipeline_matches_cpu(pipe, frame):
    cpu = FoveationPipeline(CFG, device="cpu")
    c = (0.37, 0.62)
    red = pipe.foveate_chw(frame, pipe.center(*c))
    want = cpu.foveate_chw(frame.cpu(), cpu.center(*c))
    assert torch.equal(red.cpu(), want)
    assert torch.equal(
        pipe.unwarp_auto_chw(red, pipe.center(*c)).cpu(),
        cpu.unwarp_auto_chw(want, cpu.center(*c)),
    )
    assert pipe.device.type == "cuda"


def test_each_launch_counts_once(pipe, frame):
    kernels = (sr.Y_PASS, sr.X_PASS, uw.X_PASS, uw.Y_PASS)
    before = [k.launches for k in kernels]
    c = pipe.center(0.5, 0.5)
    pipe.unwarp_auto_chw(pipe.foveate_chw(frame, c), c)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1, 1]


def test_wrappers_check_inputs(pipe, frame):
    centers = pipe.center(0.5, 0.5)[None]
    pxc, pxmc, vx, pyc, pymc, vy = sr.fused_taps(pipe.grid, frame, centers)
    with pytest.raises(ValueError, match="frame"):
        sr.y_segment_reduce_batch(frame.to(torch.int32), pymc, pyc)
    with pytest.raises(ValueError, match="contiguous"):
        sr.y_segment_reduce_batch(frame, pymc, pyc.repeat_interleave(2, 1)[:, ::2])
    with pytest.raises(ValueError, match="pc"):
        sr.y_segment_reduce_batch(frame, pymc, pyc.cpu())
    rows = sr.y_segment_reduce_batch(frame, pymc, pyc)
    with pytest.raises(ValueError, match="valid_x"):
        sr.x_segment_reduce_batch(rows, pxmc, pxc, vx.int(), pymc, pyc, vy)
    xv, _ = uw.fused_vectors(288, 1072, 1920, 512, centers[0])
    red = torch.zeros((3, 288, 1072), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="src"):
        uw.unwarp_x_pass(red[:, :, ::2], *xv)
    with pytest.raises(ValueError, match="den"):
        uw.unwarp_x_pass(red, *xv[:3], xv[3].long())
