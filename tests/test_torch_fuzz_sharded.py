"""foveax_torch.scripts.fuzz_sharded on the CPU: its exit codes (a flipped
byte in any sharded output -> 1), the shapes it draws, its shapes against
foveax.parallel on the conftest's 8 virtual CPU devices (tolerance 0), and
chip_smoke.py's phase 14 at a small size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from foveax.core.logrect import make_grid as fx_make_grid
from foveax.parallel import make_mesh as fx_make_mesh
from foveax.parallel import sharded as fx
from foveax_torch import FoveaxConfig
from foveax_torch.config import reduced_dim
from foveax_torch.core.logrect import make_grid
from foveax_torch.parallel import make_mesh
from foveax_torch.parallel import sharded as pt
from foveax_torch.scripts import fuzz_sharded

torch.set_num_threads(1)

SMALL = ["0", "2", "--device", "cpu", "--max-width", "300", "--max-height", "120",
         "--wrap", "none"]


def _host(x) -> np.ndarray:
    t = x.cpu()
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def test_fuzz_sharded_cpu_exits_zero(capsys):
    """Two shapes at the JAX package's range and the 4808x4000 all-255
    case, whose sums wrap past 2^32, with no failure."""
    assert fuzz_sharded.main(["0", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "FAILS: 0" and len(lines) == 4
    assert lines[2].startswith("wrap all-255 4808x4000 mesh 1x8: 255*W*H = 4904160000")
    assert "closed_form=True" in lines[2]


def _flip(out):
    """``out`` (a tensor or a Sharded) with one byte of its last block
    flipped."""
    if isinstance(out, pt.Sharded):
        last = out.blocks[-1].clone()
        last.view(torch.uint8).view(-1)[last.numel() // 2] ^= 1
        return out._replace(blocks=out.blocks[:-1] + (last,))
    return tuple(_flip(o) for o in out)


@pytest.mark.parametrize("name,field", [
    ("sharded_build_sat", "sat"),
    ("sharded_sample_batch", "sample"),
    ("multi_client_step", "mc"),
    ("sharded_sample_batch_fused", "fused"),
])
def test_fuzz_sharded_catches_a_flipped_byte(monkeypatch, capsys, name, field):
    """A sharded function that gets one byte of one block wrong fails the
    fuzz (exit code 1) and names the output."""
    real = getattr(fuzz_sharded, name)
    monkeypatch.setattr(fuzz_sharded, name, lambda *a, **k: _flip(real(*a, **k)))
    assert fuzz_sharded.main(SMALL) == 1
    out = capsys.readouterr().out
    assert f" {field}=False" in out and out.splitlines()[-1] != "FAILS: 0"


def test_fuzz_sharded_needs_a_gpu_unless_told(capsys):
    assert fuzz_sharded.main(["0", "1"]) == 2
    assert "device='cpu'" in capsys.readouterr().err


@pytest.mark.parametrize("text", ["4000x4000", "4808x4001", "40000x4001", "4808"])
def test_wrap_size_must_wrap_and_split(text):
    """The wrap case's size must pass 2^32 and split over eight blocks."""
    with pytest.raises(SystemExit):
        fuzz_sharded.main(["0", "0", "--device", "cpu", "--wrap", text])


def test_wrap_size_may_pass_one_scanning_block():
    """K5 scans a row wider than one block spans in column tiles, so the
    wrap case's width has no limit of its own."""
    assert fuzz_sharded.parse_wrap("40000x4000") == (40000, 4000)
    assert fuzz_sharded.parse_wrap("none") is None


@pytest.mark.parametrize("limits", [(4096, 2160), (640, 200)], ids=["card", "cpu"])
def test_draws_end_blocks_off_the_band(limits):
    """Widths never a multiple of 16, heights n_space * k inside the
    limits with k never a multiple of K5's band; the edge gazes first."""
    rng = np.random.default_rng(3)
    for _ in range(40):
        case = fuzz_sharded.draw_case(rng, *limits)
        h, w, _ = case["frame"].shape
        n_space = case["n_space"]
        assert w % 16 and 128 <= w <= limits[0] and h <= limits[1]
        assert h % n_space == 0 and (h // n_space) % 32
        n = len(case["centers"])
        assert n % case["n_data"] == 0
        np.testing.assert_array_equal(case["centers"][:2],
                                      np.float32([(0, 1), (0.997, 0.003)])[:n])


@pytest.mark.parametrize("index", [0, 1])
def test_fuzzed_shapes_match_foveax(index):
    """At the first two shapes seed 0 draws on the CPU, the port's
    sharded SAT and SAT-sampled batch equal foveax's on its 8 virtual
    devices with the same mesh shape (tolerance 0; foveax's sampler under
    ``jax.jit``, as the serving loop runs it)."""
    rng = np.random.default_rng(0)
    for _ in range(index + 1):
        case = fuzz_sharded.draw_case(rng, *fuzz_sharded.LIMITS["cpu"])
    n_data, n_space = case["n_data"], case["n_space"]
    frame, centers = case["frame"], case["centers"]
    h, w, _ = frame.shape
    mesh = make_mesh(n_space, n_data, devices=["cpu"] * 8)
    fmesh = fx_make_mesh(n_space=n_space, n_data=n_data)
    grid = make_grid(reduced_dim(w), reduced_dim(h), w, h, "cpu")
    fgrid = fx_make_grid(reduced_dim(w), reduced_dim(h), w, h)
    sat = pt.sharded_build_sat(torch.from_numpy(frame), mesh)
    fsat = fx.sharded_build_sat(jnp.asarray(frame), fmesh)
    np.testing.assert_array_equal(_host(sat), np.asarray(fsat))
    got = pt.sharded_sample_batch(sat, torch.from_numpy(centers), grid, mesh)
    want = jax.jit(lambda s, c: fx.sharded_sample_batch(s, c, fgrid, fmesh))(
        fsat, jnp.asarray(centers))
    np.testing.assert_array_equal(_host(got), np.asarray(want))


def test_phase_sharded_fuzz_on_cpu():
    """chip_smoke.py's phase 14 at a small size: the fuzz over two shapes
    with a wrap case of 4112x4104 (255 * 4112 * 4104 > 2^32), the hostile
    streams rejected where the client checks dimensions, unwarp_xy after
    them equal to its plain version."""
    cfg = FoveaxConfig(source_width=96, source_height=64, reduced_width=48,
                       reduced_height=32)
    report = chip_smoke.phase_sharded_fuzz(
        device="cpu", fuzz=SMALL[:-2], wrap=(4112, 4104), cfg=cfg)
    assert report["fuzz"][-1] == "FAILS: 0"
    assert report["fuzz"][-2].startswith("wrap all-255 4112x4104 mesh 1x8")
    assert report["launches"] == {"K5": 0, "segreduce_xy": 0, "K7": 0}
    init, sample, unwarp = report["hostile"]
    assert "serve/client.py" in init and "stream is 64x32" in init
    assert "serve/client.py" in sample and "decoded sample is 64x32" in sample
    assert "max_abs_err 0" in unwarp
