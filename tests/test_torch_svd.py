"""foveax_torch's SVD-compressed SAT (``core/svd_sat.py``) and its wire
(``io/svdwire.py``) on the CPU, held against foveax on the same inputs
made from numpy seeds: the factors, the residual and the packed bytes
bit-equal (tolerance 0); the rank contraction, an ordered float32 sum in
the port and XLA's einsum in foveax, within a stated share of the SAT's
maximum; the box filter bit-equal on equal texels.  The foveax references
are jitted with the gaze traced."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.core import golden
from foveax.core import svd_sat as fx
from foveax.core.logrect import make_grid as fx_make_grid
from foveax.core.sample import sample_rect_from_sat as fx_sample_sat
from foveax.core.sat import build_sat as fx_build_sat
from foveax.io import svdwire as fx_wire
from foveax_torch.convert import svd_sat_from_numpy
from foveax_torch.core import svd_sat as pt
from foveax_torch.core.logrect import make_grid
from foveax_torch.core.sat import build_sat
from foveax_torch.io import svdwire as pt_wire

torch.set_num_threads(1)

SHAPES = [(96, 64, 48, 32), (256, 128, 144, 80)]
GAZES = [(0.5, 0.5), (0.3, 0.4), (0.0, 0.0), (0.97, 0.9), (0.61, 0.12)]
RANK = 8
# |port - foveax| of a reconstructed SAT value, as a share of the SAT's
# maximum: the rank contraction sums in another order (measured worst
# 2.4e-7 over both shapes, three seeds and five gazes; float32 spacing is
# 1.2e-7 of a value).
CONTRACTION_REL = 5e-7
FIELDS = ("u", "s", "v", "residual_q", "ranges")

_reconstruct = jax.jit(fx.reconstruct_sat)
_reduced = jax.jit(fx.create_reduced_sat)
_box = jax.jit(fx.sample_from_reduced_sat)


def _frame(w, h, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _pair(frame, rank=RANK):
    """(foveax SVDSat, port SVDSat, foveax SAT) of one frame."""
    fsat = fx_build_sat(jnp.asarray(frame))
    return (
        fx.compress_sat(fsat, rank),
        pt.compress_sat(build_sat(torch.from_numpy(frame)), rank),
        fsat,
    )


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def case(request):
    w, h, wr, hr = request.param
    frame = _frame(w, h, 7)
    fs, ts, fsat = _pair(frame)
    return dict(w=w, h=h, wr=wr, hr=hr, frame=frame, fs=fs, ts=ts, fsat=fsat)


def _same_factors(fs, ts):
    for name in FIELDS:
        got = getattr(ts, name).numpy()
        want = np.asarray(getattr(fs, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rank", [1, 8, 30])
def test_compress_bit_equal_to_foveax(seed, rank):
    w, h = (96, 64) if seed < 2 else (256, 128)
    fs, ts, _ = _pair(_frame(w, h, seed), rank)
    _same_factors(fs, ts)
    assert ts.u.shape == (3, h, min(rank, h)) and ts.residual_q.shape == (h, w, 3)


def test_compress_places_factors(case):
    on_cpu = pt.compress_sat(build_sat(torch.from_numpy(case["frame"])), RANK,
                             device="cpu")
    assert all(getattr(on_cpu, n).device.type == "cpu" for n in FIELDS)
    _same_factors(case["fs"], on_cpu)


def test_reconstruct_within_contraction_bound(case):
    want = np.asarray(_reconstruct(case["fs"]))
    got = pt.reconstruct_sat(case["ts"]).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    rel = np.abs(got - want).max() / float(np.asarray(case["fsat"]).max())
    assert rel <= CONTRACTION_REL, rel


def test_reconstruct_matches_float64_golden(case):
    ts = case["ts"]
    ref = golden.reconstruct_sat_svd(*(getattr(ts, n).numpy() for n in FIELDS))
    got = pt.reconstruct_sat(ts).numpy().astype(np.float64)
    assert (np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max() < 1e-4


def test_full_rank_reconstruction_is_exact():
    frame = _frame(96, 64, 3)
    sat = build_sat(torch.from_numpy(frame))
    rec = pt.reconstruct_sat(pt.compress_sat(sat, 64)).numpy()
    ref = pt.sat_to_numpy(sat).astype(np.float64)
    assert np.abs(rec - ref).max() / ref.max() < 1e-4


@pytest.mark.parametrize("gaze", GAZES)
def test_reduced_sat_within_contraction_bound(case, gaze):
    grid = make_grid(case["wr"], case["hr"], case["w"], case["h"], "cpu")
    fgrid = fx_make_grid(case["wr"], case["hr"], case["w"], case["h"])
    want = np.asarray(_reduced(case["fs"], fgrid, jnp.asarray(gaze, jnp.float32)))
    got = pt.create_reduced_sat(case["ts"], grid, torch.tensor(gaze)).numpy()
    assert got.shape == want.shape == (case["hr"] + 1, case["wr"] + 1, 5)
    # The position channels are integers: exact.
    np.testing.assert_array_equal(got[..., 3:], want[..., 3:])
    rel = np.abs(got - want).max() / float(np.asarray(case["fsat"]).max())
    assert rel <= CONTRACTION_REL, rel


@pytest.mark.parametrize("gaze", GAZES)
def test_box_filter_bit_equal_on_equal_texels(case, gaze):
    """Fed the same reduced SAT, both box filters give the same bytes (the
    masks are 0/1, so every product is exact)."""
    grid = make_grid(case["wr"], case["hr"], case["w"], case["h"], "cpu")
    texels = pt.create_reduced_sat(case["ts"], grid, torch.tensor(gaze))
    want = np.asarray(_box(jnp.asarray(texels.numpy())))
    got = pt.sample_from_reduced_sat(texels).numpy()
    assert got.dtype == np.uint8 and got.shape == (case["hr"], case["wr"], 3)
    np.testing.assert_array_equal(got, want)


def test_reduced_sat_sampling_approximates_direct():
    """Mirrors foveax's own check: with an exact factorization the reduced
    SAT path lands near the direct SAT sampler in the interior."""
    frame = _frame(96, 64, 4)
    sat = build_sat(torch.from_numpy(frame))
    grid = make_grid(24, 16, 96, 64, "cpu")
    center = torch.tensor([0.5, 0.5])
    direct = np.asarray(fx_sample_sat(fx_build_sat(jnp.asarray(frame)),
                                      fx_make_grid(24, 16, 96, 64),
                                      jnp.asarray([0.5, 0.5], jnp.float32), wrap_x=False))
    red = pt.create_reduced_sat(pt.compress_sat(sat, 64), grid, center)
    out = pt.sample_from_reduced_sat(red).numpy()
    assert red.shape == (17, 25, 5) and out.shape == (16, 24, 3)
    a = out[4:12, 6:18].astype(np.int32)
    b = direct[4:12, 6:18].astype(np.int32)
    assert np.abs(a - b).mean() <= 2.0


def test_svd_sat_from_numpy_carries_foveax_factors(case):
    fs = case["fs"]
    got = svd_sat_from_numpy(*(np.asarray(getattr(fs, n)) for n in FIELDS), "cpu")
    _same_factors(fs, got)


# -- the wire ----------------------------------------------------------------


def test_pack_svd_bit_equal_and_round_trip(case):
    fs, ts = case["fs"], case["ts"]
    blob = pt_wire.pack_svd(ts)
    assert blob == fx_wire.pack_svd(fs)
    h, w = case["h"], case["w"]
    assert len(blob) <= pt_wire.payload_size(h, w, RANK) + 9 + len(blob) // 512
    back = pt_wire.unpack_svd(blob, device="cpu")
    want = fx_wire.unpack_svd(blob)
    _same_factors(want, back)
    np.testing.assert_array_equal(back.residual_q.numpy(), ts.residual_q.numpy())
    # float16 wire quantization of the factors stays small against scale.
    assert (back.u - ts.u).abs().max() <= 2.0**-10 * ts.u.abs().max() * 4 + 1e-3


def _stream_frames(n=7, w=64, h=40, seed=11):
    """Near-static content: one changed row per frame."""
    base = _frame(w, h, seed)
    frames = []
    for i in range(n):
        f = base.copy()
        f[i % h, :, :] ^= 3
        frames.append(f)
    return frames


@pytest.mark.parametrize("compress", ["rle", "deflate", "none"])
def test_packer_stream_bit_equal_to_foveax(compress):
    """v2 sync and delta samples of each residual strategy: the same bytes
    and sync flags as foveax's packer, and every sample decodes to the
    same factors in both packages."""
    pairs = [_pair(f)[:2] for f in _stream_frames()]
    fx_packer = fx_wire.SvdWirePacker(sync_every=3, compress=compress)
    pt_packer = pt_wire.SvdWirePacker(sync_every=3, compress=compress)
    fx_unp, pt_unp = fx_wire.SvdWireUnpacker(), pt_wire.SvdWireUnpacker("cpu")
    for fs, ts in pairs:
        blob, key = pt_packer.pack(ts)
        assert (blob, key) == fx_packer.pack(fs)
        _same_factors(fx_unp.unpack(blob), pt_unp.unpack(blob))


def test_delta_stream_and_gap_recovery():
    """Mirrors foveax's serve test: sync cadence honored, every in-order
    sample decodes exactly, a missed delta goes dark until the next sync,
    static content deltas to nearly nothing, and the stateless helper
    refuses delta samples."""
    svds = [_pair(f)[1] for f in _stream_frames()]
    packer = pt_wire.SvdWirePacker(sync_every=3)
    packed = [packer.pack(s) for s in svds]
    assert [k for _, k in packed] == [True, False, False, True, False, False, True]
    sync_sizes = [len(b) for b, k in packed if k]
    delta_sizes = [len(b) for b, k in packed if not k]
    assert max(delta_sizes) < min(sync_sizes), (sync_sizes, delta_sizes)

    p2 = pt_wire.SvdWirePacker(sync_every=8)
    b_sync, k0 = p2.pack(svds[0])
    b_delta, k1 = p2.pack(svds[0])
    assert k0 and not k1
    factor_bytes = 16 + 12 + 2 * 3 * 40 * 8 + 4 * 3 * 8 + 2 * 3 * 8 * 64
    assert len(b_delta) - factor_bytes < 0.1 * (len(b_sync) - factor_bytes)

    def res(s):
        return s.residual_q.numpy()

    unp = pt_wire.SvdWireUnpacker("cpu")
    for (blob, _), svd in zip(packed, svds):
        np.testing.assert_array_equal(res(unp.unpack(blob)), res(svd))

    unp = pt_wire.SvdWireUnpacker("cpu")
    assert unp.unpack(packed[0][0]) is not None
    assert unp.unpack(packed[2][0]) is None  # packed[1] missed
    np.testing.assert_array_equal(res(unp.unpack(packed[3][0])), res(svds[3]))
    np.testing.assert_array_equal(res(unp.unpack(packed[4][0])), res(svds[4]))

    unp = pt_wire.SvdWireUnpacker("cpu")  # a mid-GOP joiner
    assert unp.unpack(packed[4][0]) is None
    assert unp.unpack(packed[6][0]) is not None

    with pytest.raises(ValueError):
        pt_wire.unpack_svd(packed[1][0], device="cpu")


@pytest.mark.parametrize("blob", [b"nope", b"FXSV\x02\x00", b"FXSV" + bytes(40)])
def test_unpack_rejects_bad_payloads(blob):
    with pytest.raises(ValueError):
        pt_wire.unpack_svd(blob, device="cpu")


def test_unpacker_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_wire.SvdWireUnpacker()
