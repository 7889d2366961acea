"""K7's plain version, the SAT path's 4-tap sampler on the CPU
(``foveax_torch.kernels.sat_sample``), reached through
``sample_rect_from_sat``: bit-equal (tolerance 0) to foveax's jitted
``sample_rect_from_sat`` and its ``jax.vmap`` batch on the same numpy
frames, at 96x64 -> 48x32 (both wrap modes, both layouts), at F1's
1920x1080 -> 64x36 on an all-255 frame at the edge gazes (the largest box
sums), and at 36000x64 -> 20000x48 with three gazes, two at the seam.
Then the plain version against a numpy 4-tap reference on random taps
(non-monotone seam columns, ``pmc = pc - 1``) and on SAT words offset by
row and column mod 2^32, whose 4-tap differences wrap; on a CPU tensor the wrapper runs the plain version and
launches nothing; its checks raise ValueError on what K7 does not take.

Both samplers read the port's SAT (``build_sat``, bit-equal to foveax's,
tests/test_torch_sat.py), so these tests hold the sampler alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.core.logrect import make_grid as fx_make_grid
from foveax.core.sample import sample_rect_from_sat as fx_sample_sat
from foveax_torch.core.logrect import make_grid
from foveax_torch.core.sample import sample_rect_from_sat
from foveax_torch.core.sat import build_sat
from foveax_torch.kernels import sat_sample as ss
from foveax_torch.kernels.scan2d import MASK32

torch.set_num_threads(1)

GAZES = [(0.5, 0.5), (0.0, 0.3), (0.999, 0.7), (0.03, 0.97), (1.0, 1.0),
         (0.61, 0.02)]
EDGE_GAZES = [(0.0, 0.0), (1.0, 1.0), (0.0, 1.0), (1.0, 0.0), (0.999, 0.001),
              (0.5, 0.0)]
# 36000x64: two gazes at the seam, where columns wrap past either edge.
WIDE_GAZES = [(0.0005, 0.5), (0.9995, 0.4), (0.37, 0.6)]


def _sat(frame: np.ndarray):
    """The port's SAT of an (H, W, 3) frame and the same words for JAX."""
    sat = build_sat(torch.from_numpy(frame))
    return sat, jnp.asarray(sat.view(torch.int32).numpy().view(np.uint32))


def _foveax(jsat, w: int, h: int, wr: int, hr: int, gazes, wrap: bool,
            layout: str) -> tuple[list[np.ndarray], np.ndarray]:
    """foveax's jitted sampler at each gaze and its vmapped batch."""
    grid = fx_make_grid(wr, hr, w, h)

    def one(sat, c):
        return fx_sample_sat(sat, grid, c, wrap_x=wrap, out_layout=layout)

    cs = jnp.asarray(gazes, jnp.float32)
    single = jax.jit(one)
    batch = jax.jit(jax.vmap(one, in_axes=(None, 0)))
    return [np.asarray(single(jsat, c)) for c in cs], np.asarray(batch(jsat, cs))


def _port(sat, w: int, h: int, wr: int, hr: int, gazes, wrap: bool,
          layout: str) -> tuple[list[np.ndarray], np.ndarray]:
    grid = make_grid(wr, hr, w, h, "cpu")
    cs = torch.tensor(gazes, dtype=torch.float32)
    single = [sample_rect_from_sat(sat, grid, c, wrap_x=wrap, out_layout=layout)
              for c in cs]
    batch = sample_rect_from_sat(sat, grid, cs, wrap_x=wrap, out_layout=layout)
    return [t.numpy() for t in single], batch.numpy()


def _assert_same(got, want, shape) -> None:
    (got_one, got_batch), (want_one, want_batch) = got, want
    assert got_batch.shape == shape and got_batch.dtype == np.uint8
    np.testing.assert_array_equal(got_batch, want_batch)
    for g, w_ in zip(got_one, want_one, strict=True):
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("layout", ["hwc", "chw"])
@pytest.mark.parametrize("wrap", [True, False])
def test_small_matches_foveax(wrap, layout):
    frame = np.random.default_rng(18).integers(0, 256, (64, 96, 3), np.uint8)
    sat, jsat = _sat(frame)
    args = (96, 64, 48, 32, GAZES, wrap, layout)
    shape = (len(GAZES), 32, 48, 3) if layout == "hwc" else (len(GAZES), 3, 32, 48)
    _assert_same(_port(sat, *args), _foveax(jsat, *args), shape)


@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_f1_shape_all_255_edge_gazes(layout):
    """1920x1080 -> 64x36 (row boxes up to 268 rows, F1) on an all-255
    frame: the largest box sums.  Every valid cell is 255."""
    frame = np.full((1080, 1920, 3), 255, np.uint8)
    sat, jsat = _sat(frame)
    args = (1920, 1080, 64, 36, EDGE_GAZES, True, layout)
    got = _port(sat, *args)
    shape = (len(EDGE_GAZES), 36, 64, 3) if layout == "hwc" else (len(EDGE_GAZES), 3, 36, 64)
    _assert_same(got, _foveax(jsat, *args), shape)
    assert set(np.unique(got[1])) == {0, 255}


def test_wide_three_gazes_two_at_the_seam():
    """36000x64 -> 20000x48, past the fused sampler's contract: the SAT
    batch of three gazes, two at the seam, equal to foveax's vmapped
    batch and to its single-gaze calls."""
    frame = np.random.default_rng(36).integers(0, 256, (64, 36000, 3), np.uint8)
    sat, jsat = _sat(frame)
    args = (36000, 64, 20000, 48, WIDE_GAZES, True, "hwc")
    _assert_same(_port(sat, *args), _foveax(jsat, *args), (3, 48, 20000, 3))


def _random_taps(rng, n: int, m: int, dim: int):
    """In-contract taps of no particular order, as at the seam: (pc, pmc,
    valid) int32/bool (n, m); every third interval one long (pmc = pc -
    1), the first touching 0, the last dim - 1, about a fifth invalid."""
    pc = rng.integers(1, dim, (n, m))
    pmc = np.maximum(pc - rng.integers(1, dim, (n, m)), 0)
    pmc[:, ::3] = pc[:, ::3] - 1
    pc[:, 0], pmc[:, 0] = 1, 0
    pc[:, -1], pmc[:, -1] = dim - 1, 0
    valid = rng.random((n, m)) > 0.2
    return (torch.from_numpy(pc.astype(np.int32)),
            torch.from_numpy(pmc.astype(np.int32)), torch.from_numpy(valid))


def _numpy_4tap(sat: np.ndarray, pxc, pxmc, vx, pyc, pymc, vy) -> np.ndarray:
    """The 4-tap box mean in numpy int64, (N, 3, Hr, Wr)."""
    s = sat.astype(np.int64)
    out = []
    for g in range(pxc.shape[0]):
        y1, y0 = pyc[g][:, None], pymc[g][:, None]
        x1, x0 = pxc[g][None, :], pxmc[g][None, :]
        box = (s[:, y1, x1] - s[:, y0, x1] - s[:, y1, x0] + s[:, y0, x0]) & MASK32
        vals = box // ((y1 - y0) * (x1 - x0))
        keep = vy[g][:, None] & vx[g][None, :]
        out.append(np.where(keep, vals, 0).astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize("offset", [False, True], ids=["sat", "offset-words"])
def test_plain_random_taps_match_numpy(offset):
    """Random in-contract taps over a 301x77 SAT, three gazes, against
    numpy; then over the SAT's words plus a random offset per row and per
    column, mod 2^32: the offsets cancel in every box, but nearly every
    4-tap difference of the words leaves [0, 2^32), so the box means
    stay the same only through the wrap."""
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (77, 301, 3), np.uint8)
    sat = build_sat(torch.from_numpy(frame))
    words = sat.view(torch.int32).to(torch.int64) & MASK32
    if offset:
        row = torch.from_numpy(rng.integers(0, 2**32, 77, np.int64))
        col = torch.from_numpy(rng.integers(0, 2**32, 301, np.int64))
        words = (words + row[:, None] + col[None, :]) & MASK32
    shifted = words.to(torch.int32).view(torch.uint32)
    pxc, pxmc, vx = _random_taps(rng, 3, 120, 301)
    pyc, pymc, vy = _random_taps(rng, 3, 40, 77)
    want = _numpy_4tap(words.numpy(), *(t.numpy() for t in (pxc, pxmc, vx, pyc, pymc, vy)))
    got = ss.sat_sample_batch_plain(shifted, pxmc, pxc, vx, pymc, pyc, vy, "chw")
    np.testing.assert_array_equal(got.numpy(), want)
    hwc = ss.sat_sample_batch_plain(shifted, pxmc, pxc, vx, pymc, pyc, vy, "hwc")
    np.testing.assert_array_equal(hwc.numpy(), want.transpose(0, 2, 3, 1))
    plain = ss.sat_sample_batch_plain(sat, pxmc, pxc, vx, pymc, pyc, vy, "chw")
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_cpu_tensor_runs_the_plain_version(monkeypatch):
    """On a CPU SAT the wrapper, and ``sample_rect_from_sat`` through it,
    run the plain version: no launch, no build."""

    def refuse(*args):
        raise AssertionError("K7 launched for a CPU tensor")

    monkeypatch.setattr(ss.SAT_SAMPLE, "launch", refuse)
    before = ss.SAT_SAMPLE.launches
    frame = np.random.default_rng(5).integers(0, 256, (64, 96, 3), np.uint8)
    sat = build_sat(torch.from_numpy(frame))
    rng = np.random.default_rng(6)
    pxc, pxmc, vx = _random_taps(rng, 2, 48, 96)
    pyc, pymc, vy = _random_taps(rng, 2, 32, 64)
    args = (sat, pxmc, pxc, vx, pymc, pyc, vy)
    for layout in ss.LAYOUTS:
        assert torch.equal(ss.sat_sample_batch(*args, layout),
                           ss.sat_sample_batch_plain(*args, layout))
    grid = make_grid(48, 32, 96, 64, "cpu")
    out = sample_rect_from_sat(sat, grid, torch.tensor([0.4, 0.6]))
    assert out.shape == (32, 48, 3)
    assert ss.SAT_SAMPLE.launches == before


def _args():
    sat = torch.zeros((3, 64, 96), dtype=torch.uint32)
    x = torch.ones((2, 48), dtype=torch.int32)
    y = torch.ones((2, 32), dtype=torch.int32)
    return dict(sat=sat, pxmc=x - 1, pxc=x, valid_x=x.bool(), pymc=y - 1,
                pyc=y, valid_y=y.bool(), out_layout="chw")


@pytest.mark.parametrize("key, bad, match", [
    ("sat", torch.zeros((3, 64, 96), dtype=torch.int32), "sat: expected torch.uint32"),
    ("sat", torch.zeros((2, 64, 96), dtype=torch.uint32), r"sat: expected \(3, Hs, Ws\)"),
    ("sat", torch.zeros((3, 64, 96), dtype=torch.uint32).transpose(1, 2).contiguous()
     .transpose(1, 2), "sat: must be contiguous"),
    ("sat", torch.zeros(1, dtype=torch.uint32).expand(3, 65536, 65536), "2\\^32 cells"),
    ("pxc", torch.ones((2, 48), dtype=torch.int64), "pxc: expected torch.int32"),
    ("pxmc", torch.zeros((2, 47), dtype=torch.int32), r"pxmc: expected torch.int32 \(2, 48\)"),
    ("pyc", torch.ones(32, dtype=torch.int32), r"pyc: expected \(N, M\)"),
    ("pymc", torch.zeros((1, 32), dtype=torch.int32), r"pymc: expected torch.int32 \(2, 32\)"),
    ("valid_x", torch.ones((2, 48), dtype=torch.int32), "valid_x: expected torch.bool"),
    ("valid_y", torch.ones((2, 31), dtype=torch.bool), r"valid_y: expected torch.bool \(2, 32\)"),
    ("out_layout", "nhwc", "out_layout 'nhwc'"),
], ids=["sat-dtype", "sat-channels", "sat-strides", "sat-cells", "pxc-dtype",
        "pxmc-shape", "pyc-dims", "pymc-gazes", "valid_x-dtype", "valid_y-shape",
        "layout"])
def test_check_rejects(key, bad, match):
    args = _args()
    assert ss.check_sat_sample(**args) == (2, 64, 96, 32, 48)
    args[key] = bad
    with pytest.raises(ValueError, match=match):
        ss.check_sat_sample(**args)


def test_smoke_phase_2_sat_sample_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's K7 comparisons (phase 2) on the CPU at small
    shapes, where the wrapper is its plain version: every case runs in
    both layouts and ``errs`` records K7."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "SHAPES", {"small": (192, 108)})
    monkeypatch.setattr(chip_smoke, "LADDER", {"8k": (256, 144)})
    monkeypatch.setattr(chip_smoke, "ODD_SHAPE", (100, 50, 56, 29))
    errs = {}
    chip_smoke.phase_compare_sat_sample(errs, "cpu")
    assert errs == {"sat_sample": 0}
    out = capsys.readouterr().out
    assert "compare sat_sample: 11 cases x 2 layouts (small at 5 single gazes" in out


def test_sources_name_every_kernel_source():
    """``build.SOURCES``, which chip_smoke.py and the two-process demo
    build, names every CUDA source under csrc/."""
    from pathlib import Path

    from foveax_torch.kernels import build

    found = {p.stem for p in Path(build.CSRC).glob("*.cu")}
    assert set(build.SOURCES) == found and "sat_sample" in found
