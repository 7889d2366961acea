"""foveax_torch's configuration, grid and inverse-map table against
foveax's, exhaustively at the production axes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.config import FoveaxConfig as FxConfig
from foveax.core import logrect as fx_logrect
from foveax_torch import FoveaxConfig, make_grid
from foveax_torch.convert import grid_from_numpy
from foveax_torch.core import logrect
from foveax_torch.core.unwarp import u_raw_table

torch.set_num_threads(1)

# Source sizes: the four production shapes and the 1920x512 test shape.
SOURCES = {
    "1080p": (1920, 1080),
    "4k": (3840, 2160),
    "8k": (7680, 4320),
    "16k": (15360, 8640),
    "1920x512": (1920, 512),
}


def _axes(name):
    """(full, reduced) dims of both axes of one source size: the grid
    maps reduced onto full, the unwarp full onto reduced."""
    cfg = FxConfig().with_source(*SOURCES[name])
    return [
        (cfg.source_width, cfg.reduced_width),
        (cfg.source_height, cfg.reduced_height),
    ]


@pytest.mark.parametrize("name", SOURCES)
def test_config_matches(name):
    w, h = SOURCES[name]
    assert dataclasses.asdict(FoveaxConfig().with_source(w, h)) == (
        dataclasses.asdict(FxConfig().with_source(w, h))
    )


@pytest.mark.parametrize("name", SOURCES)
def test_grid_axis_matches(name):
    for full, red in _axes(name):
        np.testing.assert_array_equal(
            logrect._grid_axis(red, full), fx_logrect._grid_axis(red, full)
        )


@pytest.mark.parametrize("name", SOURCES)
def test_make_grid_matches(name):
    cfg = FxConfig().with_source(*SOURCES[name])
    dims = (cfg.reduced_width, cfg.reduced_height, *cfg.source_size)
    ref = fx_logrect.make_grid(*dims)
    for grid in (
        make_grid(*dims, device="cpu"),
        grid_from_numpy(np.asarray(ref.gx), np.asarray(ref.gy), *dims, "cpu"),
    ):
        assert grid.gx.dtype == torch.int16 and grid.gy.dtype == torch.int16
        np.testing.assert_array_equal(grid.gx.numpy(), np.asarray(ref.gx))
        np.testing.assert_array_equal(grid.gy.numpy(), np.asarray(ref.gy))
        assert grid.max_dy == int(np.diff(np.asarray(ref.gy, np.int64)).max())


@pytest.mark.parametrize("name", SOURCES)
def test_u_raw_table_matches_xla(name):
    """The inverse map's exponent table equals what XLA-CPU computes with
    foveax's expression (core/unwarp.py:359-363) for every integer |d|
    the axis reaches: up to half the width on the 360 wrap (x) axis, up
    to the full height on the y axis."""
    for (full, red), wrap in zip(_axes(name), (True, False)):
        lam_out = fx_logrect.lam(full)

        @jax.jit
        def xla(ad):
            return jnp.ceil(
                0.5 * np.float32(red) * jnp.log(ad / lam_out + np.float32(1.0))
                ** 0.25
            ).astype(jnp.int32)

        table = u_raw_table(full, red, wrap=wrap).numpy()
        assert table.shape == ((full // 2 if wrap else full) + 1,)
        ad = np.arange(table.shape[0], dtype=np.float32)
        np.testing.assert_array_equal(table, np.asarray(xla(ad)))


def test_delta_table_matches():
    for full, red in _axes("4k"):
        u = red // 2 + 2
        np.testing.assert_array_equal(
            logrect.delta_table(-u, u, red, full),
            fx_logrect.delta_table(-u, u, red, full),
        )


def test_scaled_center_matches_float32_truncation():
    """trunc(float32(c) * float32(dim)), as foveax computes it."""
    rng = np.random.default_rng(11)
    cs = np.concatenate([
        rng.random((64, 2)),
        [[0.0, 0.0], [1.0, 1.0], [0.999, 0.001], [0.03, 0.4], [1 / 3, 2 / 3]],
    ]).astype(np.float32)
    for w, h in SOURCES.values():
        cx, cy = logrect.scaled_center(torch.from_numpy(cs), w, h)
        ref = (jnp.asarray(cs) * jnp.asarray([w, h], jnp.float32)).astype(
            jnp.int32
        )
        np.testing.assert_array_equal(cx.numpy(), np.asarray(ref[:, 0]))
        np.testing.assert_array_equal(cy.numpy(), np.asarray(ref[:, 1]))


def test_grid_defaults_to_cuda(monkeypatch):
    """Entry points run on the card unless asked for the CPU: without a
    GPU, asking for the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_grid(1072, 608, 1920, 1080)
    assert make_grid(1072, 608, 1920, 1080, device="cpu").device.type == "cpu"


def test_grid_from_numpy_checks_shapes():
    gx = fx_logrect._grid_axis(1072, 1920)
    gy = fx_logrect._grid_axis(608, 1080)
    with pytest.raises(ValueError, match="do not match"):
        grid_from_numpy(gx, gy, 1072, 600, 1920, 1080, "cpu")


@pytest.mark.parametrize("shape", [(1920, 1080), (3840, 2160), (96, 64)],
                         ids=["1080p", "4k", "96x64"])
def test_dense_matches(shape):
    """``LogRectGrid.dense()`` equals foveax's (tolerance 0), with no
    device read: it is built from the host copies of the vectors."""
    cfg = FxConfig().with_source(*shape)
    dims = (cfg.reduced_width, cfg.reduced_height, *cfg.source_size)
    want = fx_logrect.make_grid(*dims).dense()
    got = make_grid(*dims, device="cpu").dense()
    assert got.dtype == np.int16 and got.shape == want.shape
    assert got.shape == (cfg.reduced_height + 1, cfg.reduced_width + 1, 2)
    np.testing.assert_array_equal(got, want)


def _delta_1d_float32(u: np.ndarray, out_dim: int, source_dim: int) -> np.ndarray:
    """foveax's ``delta_1d`` transcribed to torch float32, with XLA's
    saturating float-to-int32 cast."""
    tu = torch.from_numpy(u)
    au = tu.abs()
    t = (2.0 * au.to(torch.float32) / np.float32(out_dim)) ** 4
    mag = torch.tensor(logrect.lam(source_dim)) * (torch.exp(t) - 1.0)
    mag = mag.clamp(max=2**31 - 1).to(torch.int64).clamp(max=2**31 - 1)
    return (torch.maximum(au, mag.to(torch.int32)) * torch.sign(tu)).numpy()


@pytest.mark.parametrize("name", ["1080p", "4k", "8k", "16k"])
def test_delta_1d_has_no_float32_twin(name):
    """Why ``delta_1d`` stays out of ``foveax_torch.core``: a torch
    float32 transcription of it (even with XLA's saturating cast) differs
    from foveax's jitted one at some of the 2r + 1 offsets of every axis,
    r the reduced dim (the two float32 ``exp``s differ by ulps), while
    the port's grid is the float64 ``delta64``'s, as foveax's own grids
    are (test_grid_axis_matches)."""
    for full, red in _axes(name):
        u = np.arange(-red, red + 1, dtype=np.int32)
        want = np.asarray(jax.jit(
            lambda u: fx_logrect.delta_1d(u, red, full))(jnp.asarray(u)))
        differ = int((_delta_1d_float32(u, red, full) != want).sum())
        assert 0 < differ < u.size, (full, red, differ)
